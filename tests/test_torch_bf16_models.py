"""The port's training step at the reference's bfloat16 configs: the xlstm
smoke model (every port engine), the qwen3 smoke model (``attn_impl`` xla
and flash; the reference's flash in interpret mode) and the mixtral smoke
model (``moe_impl`` xla, and the port's K12 route "pallas" against the
reference's only route), each with ``param_dtype = compute_dtype =
bfloat16``, against the reference's bfloat16 run: loss and every parameter
gradient, with the reference's NR / RH masks injected (case3 tables), as
the float32 parity tests do (tests/test_torch_xlstm.py,
test_torch_transformer.py, test_torch_moe.py).

XLA's CPU runtime cannot execute the reference MoE's expert einsums in
bfloat16 ("Unsupported element type for DotThunk: BF16 x BF16 = F32", the
batched ``secd,edf->secf`` products with ``preferred_element_type=
float32``). For the mixtral reference's bfloat16 run those einsums are
traced with their bfloat16 operands widened to float32 first
(``_wide_dots``): the same arithmetic (exact products, float32 sums), and
nothing else of the reference changes.

The mixtral configs take capacity factor 2.0 (4 experts, top-2: every
expert has a slot for every token) in place of 1.25. Which tokens a full
expert drops is a discontinuous function of the rounding: the smoke
router's second choices carry gates of ~1e-5 that near-tie, and at 1.25
they compete for slots, so a bfloat16 run drops a different token than the
float32 one in both packages (layer 0: the reference at token 4, the port
at token 15, each moving that token's output by ~7 of ~60). Without drops a
flipped second choice moves only a ~1e-5 gate. tests/test_torch_moe.py
holds the dropping path in float32.

Both sides start from the reference's bfloat16 ``init_params`` tree,
carried across bit for bit (``repro_torch.convert``); the xLSTM's mLSTM
conv weights are perturbed (std 0.1, then rounded to bfloat16) as in
tests/test_torch_xlstm.py, since at init they make every mLSTM cell output
zero.

Tolerance: ``ref32`` is the reference's float32 config run on the same
bfloat16-rounded parameters and batch. For the model's output (the final
normed features, (B, S, d_model)) and for each gradient leaf, the port's
max-abs distance from ref32 must be at most 2 x the reference's bfloat16
run's distance from ref32, plus 1e-3 x max(1, max |ref32|). The loss, one
scalar, is held to the reference's bfloat16 loss within 2e-2 (the
reference's own bfloat16 rtol, tests/test_kernels.py): a lone scalar's
bfloat16 error is one draw of rounding noise, which at this size moves the
loss by ~0.5% for any change in where a value is rounded. Every feature and
gradient leaf carries the reference's dtype, bfloat16, on both sides.

Batch 2 x 12 (xlstm) and 2 x 16 (qwen3, mixtral), the float32 parity
tests' sizes. The rule compares two draws of rounding noise, so it needs a
model whose bfloat16 error is small beside its values. At these sizes the
reference's bfloat16 gradients sit 1-2% (qwen3) to ~25% (xlstm) of each
leaf's largest entry from ref32, and the port's are as close or closer.
Swapped (xlstm at 16, mixtral at 12), one chaotic token (an exponential
gate, a near-saturated softmax) dominates either package's error wherever
its noise lands, and the ratio of the two packages' errors ranges from 0.2
to 5 across leaves.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.configs import adapters as r_adapters  # noqa: E402
from repro.distributed.sharding import strip  # noqa: E402
from repro.models import transformer as r_tf  # noqa: E402
from repro.models import xlstm as r_xlstm  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs import adapters as t_adapters  # noqa: E402
from repro_torch.convert import from_reference, to_reference  # noqa: E402
from repro_torch.data import synthetic as t_synth  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.models import xlstm as t_xlstm  # noqa: E402
from repro_torch.optim import tree_leaves, value_and_grad  # noqa: E402
from repro_torch.testing import (injection_from_ctx, to_numpy_tree,  # noqa: E402
                                 to_torch, transformer_sites, xlstm_sites)

torch.set_num_threads(1)

B, STEP = 2, 3
# sequence lengths of the float32 parity tests (tests/test_torch_xlstm.py,
# test_torch_transformer.py, test_torch_moe.py)
SEQ = {"xlstm": 12, "qwen3-xla": 16, "qwen3-flash": 16, "mixtral-xla": 16}
BF = dict(param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)
TBF = dict(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
XSMALL = dict(num_layers=8, slstm_every=4, d_model=32, n_heads=4, vocab=64, chunk=4)
XPLAN = "case3:0.5:bs2:pallas"
LOSS_RTOL = 2e-2
NO_DROP = 2.0     # mixtral smoke: 4 experts top-2, C = T: no expert overflows


def _batch(vocab, S):
    stream = t_synth.lm_stream(vocab, B * (S + 1) + 1, seed=3)
    chunk = stream[:B * (S + 1)].reshape(B, S + 1)
    return {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}


def _xlstm_cfgs(dtypes, engine="fused"):
    r_spec, t_spec = r_configs.get_arch("xlstm-1.3b"), t_configs.get_arch("xlstm-1.3b")
    r_cfg = r_adapters.apply_engine(r_spec, r_adapters.apply_dropout(
        r_spec, r_spec.smoke(**XSMALL, **dtypes), XPLAN), "fused")
    t_cfg = t_adapters.apply_engine(t_spec, t_adapters.apply_dropout(
        t_spec, t_spec.smoke(**XSMALL, **TBF), XPLAN), engine)
    return r_cfg, t_cfg


def _tf_cfgs(arch, dtypes, **kw):
    r_cfg = r_configs.get_arch(arch).smoke(**dtypes, **kw)
    t_cfg = t_configs.get_arch(arch).smoke(**TBF, **kw)
    if r_cfg.moe is not None:       # no token dropped (see the module docstring)
        r_cfg = dataclasses.replace(r_cfg, moe=dataclasses.replace(
            r_cfg.moe, capacity_factor=NO_DROP))
        t_cfg = dataclasses.replace(t_cfg, moe=dataclasses.replace(
            t_cfg.moe, capacity_factor=NO_DROP))
    return r_cfg, t_cfg


MODELS = {
    "xlstm": dict(cfgs=_xlstm_cfgs, mod=r_xlstm, sites=xlstm_sites, kind="xlstm"),
    "qwen3-xla": dict(cfgs=lambda d: _tf_cfgs("qwen3-8b", d, attn_impl="xla"),
                      mod=r_tf, sites=transformer_sites, kind="transformer"),
    "qwen3-flash": dict(cfgs=lambda d: _tf_cfgs("qwen3-8b", d, attn_impl="flash"),
                        mod=r_tf, sites=transformer_sites, kind="transformer"),
    "mixtral-xla": dict(cfgs=lambda d: _tf_cfgs("mixtral-8x22b", d),
                        mod=r_tf, sites=transformer_sites, kind="transformer"),
}

_REFS = {}


class _WideDots:
    """``jax.numpy`` whose float32-accumulating einsums widen bfloat16
    operands first (see the module docstring)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) if o.dtype == jnp.bfloat16 else o for o in ops]
        return jnp.einsum(spec, *ops, preferred_element_type=preferred_element_type, **kw)


def _run_ref_wide(mod, cfg, params, batch, key):
    saved = r_tf.jnp
    r_tf.jnp = _WideDots()
    try:
        return _run_ref(mod, cfg, params, batch, key)
    finally:
        r_tf.jnp = saved


def _run_ref(mod, cfg, params, batch, key):
    """(loss, grads, features) of the reference; the features come out of
    the same jitted program as the loss (XLA's CPU runtime rejects a
    bfloat16 x bfloat16 -> float32 dot of the MoE forward compiled alone)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = jax.tree.map(jnp.asarray, params)

    def loss_feats(p):
        feats = mod.forward(p, jb["tokens"], cfg, ctx=cfg.plan.bind(key, STEP))
        if mod is r_xlstm:
            tcfg = r_tf.TransformerConfig(vocab=cfg.vocab, d_model=cfg.d_model,
                                          loss_chunks=cfg.loss_chunks)
            return r_tf.lm_loss({"lm_head": p["lm_head"]}, feats, jb["labels"],
                                tcfg), feats
        return mod.lm_loss(p, feats, jb["labels"], cfg), feats

    (loss, feats), grads = jax.jit(jax.value_and_grad(loss_feats, has_aux=True))(jp)
    return float(loss), to_numpy_tree(grads), np.asarray(feats)


def _reference(name):
    """bfloat16 params (numpy), batch, injected masks, and the reference's
    bfloat16 and float32 losses and gradients (once per model)."""
    if name not in _REFS:
        m = MODELS[name]
        r16, _ = m["cfgs"](BF)
        r32, _ = m["cfgs"]({})
        params = to_numpy_tree(strip(m["mod"].init_params(jax.random.PRNGKey(0), r16)))
        if name == "xlstm":
            rng = np.random.default_rng(7)
            for leaf in ("conv_w", "conv_b"):
                shape = params["mlstm"][leaf].shape
                params["mlstm"][leaf] = np.asarray(jnp.asarray(
                    rng.standard_normal(shape) * 0.1, jnp.bfloat16))
        S = SEQ[name]
        batch = _batch(r16.vocab, S)
        key = jax.random.PRNGKey(11)
        _, t_cfg = m["cfgs"](BF)
        inj = injection_from_ctx(r16.plan.bind(key, STEP), m["sites"](t_cfg, B, S))
        p32 = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
        _REFS[name] = dict(params=params, batch=batch, inj=inj,
                           r16=(_run_ref_wide if name.startswith("mixtral") else _run_ref)(
                               m["mod"], r16, params, batch, key),
                           r32=_run_ref(m["mod"], r32, p32, batch, key))
    return _REFS[name]


def _rule(got, r16, r32, what):
    got, r16, r32 = (np.asarray(x, np.float64) for x in (got, r16, r32))
    assert np.all(np.isfinite(got)), what
    dp, dr = np.abs(got - r32).max(), np.abs(r16 - r32).max()
    lim = 2 * dr + 1e-3 * max(1.0, np.abs(r32).max())
    assert dp <= lim, f"{what}: port {dp:.3e} from ref32, limit {lim:.3e} (ref bf16 {dr:.3e})"


def _check(name, t_cfg):
    ref = _reference(name)
    kind = MODELS[name]["kind"]
    lfn = value_and_grad(lambda p, b, **kw: t_adapters.loss_fn(kind)(
        p, b, t_cfg, **kw))
    params = from_reference(ref["params"])
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(params))
    batch, inj = to_torch(ref["batch"]), to_torch(ref["inj"])
    loss, grads = lfn(params, batch, seed=0, step=STEP, injected=inj)
    (l16, g16, f16), (_, g32, f32) = ref["r16"], ref["r32"]
    assert abs(float(loss) - l16) <= LOSS_RTOL * abs(l16), (float(loss), l16)
    mod = t_tf if kind == "transformer" else t_xlstm
    with torch.no_grad():
        feats = mod.forward(params, batch["tokens"], t_cfg,
                            ctx=t_cfg.plan.bind(0, STEP, injected=inj))
    assert feats.dtype == torch.bfloat16 and str(f16.dtype) == "bfloat16"
    _rule(to_reference(feats), f16, f32, f"{name} features")
    got = tree_leaves(grads)
    assert len(got) == len(tree_leaves(g16))
    for g, w16, w32 in zip(got, tree_leaves(g16), tree_leaves(g32)):
        assert g.dtype == torch.bfloat16 and str(w16.dtype) == "bfloat16"
        _rule(to_reference(g), w16, w32, f"{name} grad {tuple(g.shape)}")


@pytest.mark.parametrize("engine", ["fused", "scheduled", "stepwise"])
def test_xlstm_bf16_matches_reference(engine):
    _check("xlstm", _xlstm_cfgs(BF, engine)[1])


@pytest.mark.parametrize("name", ["qwen3-xla", "qwen3-flash"])
def test_qwen3_bf16_matches_reference(name):
    _check(name, MODELS[name]["cfgs"](BF)[1])


@pytest.mark.parametrize("moe_impl", ["xla", "pallas"])
def test_mixtral_bf16_matches_reference(moe_impl):
    t_cfg = MODELS["mixtral-xla"]["cfgs"](BF)[1]
    _check("mixtral-xla", dataclasses.replace(t_cfg, moe_impl=moe_impl))


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "qwen3-8b", "mixtral-8x22b"])
def test_full_configs_take_the_reference_dtypes(arch):
    """full() in bfloat16 as the reference's; smoke() keeps float32; a
    float32 full() is still one override away."""
    r_full, t_full = r_configs.get_arch(arch).full(), t_configs.get_arch(arch).full()
    assert str(jnp.dtype(r_full.param_dtype)) == str(t_full.param_dtype)[6:] == "bfloat16"
    assert str(jnp.dtype(r_full.compute_dtype)) == str(t_full.compute_dtype)[6:] == "bfloat16"
    t_smoke = t_configs.get_arch(arch).smoke()
    assert t_smoke.param_dtype == t_smoke.compute_dtype == torch.float32
    f32 = t_configs.get_arch(arch).full(param_dtype=torch.float32,
                                        compute_dtype=torch.float32)
    assert f32.param_dtype == f32.compute_dtype == torch.float32
