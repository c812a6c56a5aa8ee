"""The port's dense transformer training step (qwen3 smoke config) against
the JAX reference: final-norm features, loss and every parameter gradient,
with ``attn_impl="xla"`` (chunked attention in plain PyTorch) and
``attn_impl="flash"`` (the flash-attention wrapper, whose CPU route is its
plain version; the reference runs its Pallas kernel in interpret mode);
rope, qk-norm and windowed chunked attention alone; the port's qwen3-8b
config against the reference's; the training CLI.

Both sides get the same parameters (the reference's ``init_params`` tree,
converted leaf for leaf), the same batch (numpy, seeded) and the same NR
masks (the reference's threefry-sampled kept blocks per layer, injected
under ``attn/nr``, ``mlp/nr`` and, where the plan has it,
``mlp/ffn_inner``).

Configs: the qwen3 smoke config (2 layers, d_model 64, 4 query heads over
2 kv heads of 16, d_ff 128, vocab 128, chunks of 8, NR p=0.25 block 8);
"repeat" with 8 query heads over 2 kv heads of 16 and ``kv_repeat=2`` (so
kv heads are repeated AND grouped, G = 2); "window" with a sliding window
of 6 and a structured FFN-inner drop (p=0.5, block 8); and, with the
chunked attention only, GeGLU + LayerNorm + QKV bias, a GELU MLP with tied
and scaled embeddings and no positions, and ReLU^2 with MQA and no remat.
Batch 2 x 16.

Tolerances (float32, the same arithmetic in another summation order):
features rtol 1e-5, atol 1e-5 (atol 1e-4 for "gelu_tied_scaled": without
qk-norm, with sqrt(d_model)-scaled embeddings and the reference's init,
attention logits reach ~30 and the softmax amplifies float32 rounding; a
float64 run of the port is 2.9e-5 from the reference's features and 6.5e-5
from the port's float32 ones); loss rtol 1e-5; each gradient leaf rtol
1e-4 plus atol 1e-4 x its largest entry (rounding follows each leaf's
scale, as in tests/test_torch_xlstm.py); rope and qk-norm 1e-6; chunked
attention 1e-5 forward, 1e-4 grads.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.distributed.sharding import strip  # noqa: E402
from repro.models import transformer as r_tf  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs import adapters as t_adapters  # noqa: E402
from repro_torch.convert import from_reference, to_reference  # noqa: E402
from repro_torch.core.dropout_plan import DropoutPlan  # noqa: E402
from repro_torch.core.sdrop import DropoutSpec  # noqa: E402
from repro_torch.data import synthetic as t_synth  # noqa: E402
from repro_torch.launch import profile as t_profile  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.optim import tree_leaves, value_and_grad  # noqa: E402
from repro_torch.testing import (injection_from_ctx, to_numpy_tree,  # noqa: E402
                                 to_torch, transformer_sites)

torch.set_num_threads(1)

ARCH = "qwen3-8b"
B, S, STEP = 2, 16, 3
CONFIGS = {
    "smoke": {},
    "repeat": dict(n_heads=8, head_dim=16, n_kv_heads=2, kv_repeat=2),
    "window": dict(window=6),
    # the block's other dense options on the qwen3 smoke config, with the
    # chunked attention only (gemma-2b, qwen1.5-32b and minitron-8b have
    # their own configs: tests/test_torch_transformer_configs.py)
    "geglu_layernorm_bias": dict(mlp="geglu", norm="layernorm", qkv_bias=True),
    "gelu_tied_scaled": dict(mlp="gelu_mlp", tie_embeddings=True,
                             scale_embed=True, qk_norm=False, pos="none"),
    "relu2_no_remat": dict(mlp="relu2", remat="none", n_kv_heads=1),
}
FEAT_TOL = dict(rtol=1e-5, atol=1e-5)
FEAT_ATOL = {"gelu_tied_scaled": 1e-4}
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-4


def _cfgs(name, attn_impl):
    r_spec, t_spec = r_configs.get_arch(ARCH), t_configs.get_arch(ARCH)
    r_cfg = r_spec.smoke(attn_impl=attn_impl, **CONFIGS[name])
    t_cfg = t_spec.smoke(attn_impl=attn_impl, **CONFIGS[name])
    if name == "window":
        from repro.core.dropout_plan import DropoutPlan as RPlan
        from repro.core.sdrop import DropoutSpec as RSpec
        r_cfg = dataclasses.replace(r_cfg, plan=RPlan({
            "nr": RSpec(rate=0.25, block_size=8),
            "ffn_inner": RSpec(rate=0.5, block_size=8)}))
        t_cfg = dataclasses.replace(t_cfg, plan=DropoutPlan({
            "nr": DropoutSpec(rate=0.25, block_size=8),
            "ffn_inner": DropoutSpec(rate=0.5, block_size=8)}))
    return r_cfg, t_cfg


def _batch(vocab):
    stream = t_synth.lm_stream(vocab, B * (S + 1) + 1, seed=3)
    chunk = stream[:B * (S + 1)].reshape(B, S + 1)
    return {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}


_REFS = {}


def _reference(name, attn_impl):
    """Params, batch, injected masks, features, loss and grads of the
    reference (computed once per config and attention)."""
    key_ = (name, attn_impl)
    if key_ not in _REFS:
        r_cfg, t_cfg = _cfgs(name, attn_impl)
        params = to_numpy_tree(strip(r_tf.init_params(jax.random.PRNGKey(0), r_cfg)))
        batch = _batch(r_cfg.vocab)
        key = jax.random.PRNGKey(11)
        inj = injection_from_ctx(r_cfg.plan.bind(key, STEP),
                                 transformer_sites(t_cfg, B, S))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jp = jax.tree.map(jnp.asarray, params)
        feats = r_tf.forward(jp, jb["tokens"], r_cfg, ctx=r_cfg.plan.bind(key, STEP))
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: r_tf.loss_fn(p, jb, r_cfg, drop_key=key, step=STEP)))(jp)
        _REFS[key_] = dict(params=params, batch=batch, inj=inj, loss=float(loss),
                           feats=np.asarray(feats), grads=to_numpy_tree(grads))
    return _REFS[key_]


CASES = ([(n, a) for n in ("smoke", "repeat", "window") for a in ("xla", "flash")]
         + [(n, "xla") for n in ("geglu_layernorm_bias", "gelu_tied_scaled",
                                 "relu2_no_remat")])


def test_injected_sites_cover_plan():
    ref = _reference("window", "xla")
    assert set(ref["inj"]) == {"attn/nr", "mlp/nr", "mlp/ffn_inner"}
    assert ref["inj"]["attn/nr"].shape == (2, 6)          # 2 layers, 6 of 8 blocks
    assert ref["inj"]["mlp/ffn_inner"].shape == (2, 8)    # 8 of 16 blocks


@pytest.mark.parametrize("name,attn_impl", CASES)
def test_features_match_reference(name, attn_impl):
    ref = _reference(name, attn_impl)
    _, t_cfg = _cfgs(name, attn_impl)
    ctx = t_cfg.plan.bind(0, STEP, injected=to_torch(ref["inj"]))
    with torch.no_grad():
        feats = t_tf.forward(from_reference(ref["params"]),
                             to_torch(ref["batch"])["tokens"], t_cfg, ctx=ctx)
    np.testing.assert_allclose(feats.numpy(), ref["feats"], rtol=FEAT_TOL["rtol"],
                               atol=FEAT_ATOL.get(name, FEAT_TOL["atol"]))


@pytest.mark.parametrize("name,attn_impl", CASES)
def test_loss_and_grads_match_reference(name, attn_impl):
    ref = _reference(name, attn_impl)
    _, t_cfg = _cfgs(name, attn_impl)
    lfn = value_and_grad(
        lambda p, b, **kw: t_adapters.loss_fn("transformer")(p, b, t_cfg, **kw))
    loss, grads = lfn(from_reference(ref["params"]), to_torch(ref["batch"]),
                      seed=0, step=STEP, injected=to_torch(ref["inj"]))
    np.testing.assert_allclose(float(loss), ref["loss"], **LOSS_TOL)
    got, want = to_reference(grads), ref["grads"]
    assert len(tree_leaves(got)) == len(tree_leaves(want))
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * np.abs(w).max(),
                                   err_msg=f"{name}/{attn_impl}")


def test_apply_rope_matches_reference():
    """Rotates the two halves of head_dim in float32; theta 1e6."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32)
    want = np.asarray(r_tf.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    got = t_tf.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), 1e6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_qk_norm_matches_reference():
    """RMSNorm over head_dim, eps 1e-6, gain per head_dim entry."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 5, 4, 16)) * 3).astype(np.float32)
    g = rng.standard_normal(16).astype(np.float32)
    want = np.asarray(r_tf.norm_apply("rmsnorm", jnp.asarray(g), None, jnp.asarray(x)))
    got = t_tf.norm_apply("rmsnorm", torch.from_numpy(g), None, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("window,causal", [(None, True), (5, True), (5, False)])
def test_chunked_attention_matches_reference(window, causal):
    """Chunked online-softmax attention with GQA (4 over 2 heads), chunks
    of 4 over 12 positions, the windowed span included: forward and the
    gradients of sum(o * w)."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 12, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 12, 2, 8)).astype(np.float32) for _ in range(2))
    w = rng.standard_normal((2, 12, 4, 8)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=4, kv_chunk=4)

    def r_f(q, k, v):
        o = r_tf.chunked_attention(q, k, v, **kw)
        return (o * w).sum(), o
    (_, r_o), r_g = jax.value_and_grad(r_f, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = t_tf.chunked_attention(*ts, **kw)
    t_g = torch.autograd.grad((o * torch.from_numpy(w)).sum(), ts)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(r_o), rtol=1e-5, atol=1e-5)
    for a, b in zip(t_g, r_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_full_config_matches_reference():
    """qwen3-8b: the reference's widths, heads, kv_repeat, chunks, plan and
    every other field, and its dtypes (bfloat16 parameters and compute);
    ``moe_impl`` is the port's own."""
    r_cfg, t_cfg = r_configs.get_arch(ARCH).full(), t_configs.get_arch(ARCH).full()
    for f in dataclasses.fields(t_cfg):
        if f.name in ("param_dtype", "compute_dtype", "plan", "moe_impl"):
            continue
        assert getattr(t_cfg, f.name) == getattr(r_cfg, f.name), f.name
    assert t_cfg.plan.to_dict() == r_cfg.plan.to_dict()
    assert (t_cfg.d_model, t_cfg.n_heads, t_cfg.n_kv_eff, t_cfg.hd, t_cfg.d_ff,
            t_cfg.vocab, t_cfg.q_chunk) == (4096, 32, 16, 128, 12288, 151936, 1024)
    assert t_cfg.param_dtype == t_cfg.compute_dtype == torch.bfloat16
    assert str(jnp.dtype(r_cfg.param_dtype)) == str(jnp.dtype(r_cfg.compute_dtype)) == "bfloat16"
    assert t_cfg.attn_impl == "xla"


def test_param_tree_matches_reference():
    r_cfg, t_cfg = _cfgs("repeat", "xla")
    want = to_numpy_tree(strip(r_tf.init_params(jax.random.PRNGKey(0), r_cfg)))
    got = to_reference(t_tf.init_params(torch.Generator().manual_seed(0), t_cfg))
    flat = lambda t, p="": ({p: t.shape} if not isinstance(t, dict) else
                            {k: v for n in t for k, v in flat(t[n], f"{p}/{n}").items()})
    assert flat(got) == flat(want)


def test_train_cli_runs_on_cpu():
    res = t_train.run(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                       "--batch", "2", "--seq", "16"])
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    assert res["cfg"].attn_impl == "xla" and res["cfg"].d_model == 64


def test_train_with_the_flash_variant_on_cpu():
    res = t_train.run(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                       "--batch", "2", "--seq", "16", "--layers", "1"],
                      cfg_fn=t_profile.VARIANTS["qwen3_flash"])
    assert res["cfg"].attn_impl == "flash" and res["cfg"].num_layers == 1
    assert np.isfinite(res["losses"]).all()
