"""The reference's remaining transformer configs in the port: gemma-2b,
minitron-8b, qwen1.5-32b, pixtral-12b (embeddings in), whisper-base
(encoder-decoder, sinusoidal positions, cross-attention) and arctic-480b
(dense-residual MoE), against the JAX reference.

For each smoke config, with ``attn_impl`` "xla" (the port's chunked
attention) and "flash" (the flash wrapper, whose CPU route is its plain
version; the reference runs its Pallas kernel in interpret mode): the
config's fields, the full config's widths and dtypes, the parameter tree,
the final-norm features, the loss and every gradient, with the same
parameters (the reference's ``init_params`` tree, converted leaf for leaf),
the same batch (numpy, seeded) and the reference's NR masks injected per
layer and site (``enc/`` sites for whisper's encoder). Then: one bfloat16
step of each config against a float64 run; whisper's ``encode``, its
cross-K/V ``prefill`` and 8 ``decode_step``s; the sinusoidal rows;
pixtral's embeddings prefill and decode; ``remat="dots"`` (the same loss
and gradients as "full" and as the reference's "dots", and no matrix
product recomputed in the backward); ``attn_impl="identity"``;
``configs/shapes.py`` and every arch's ``applicable``; the trainer's
batches and the train CLI on the CPU; the serve CLI of whisper-base, whose
greedy tokens equal the reference's.

Tolerances are tests/test_torch_transformer.py's (float32, the same
arithmetic in another summation order): features rtol 1e-5, atol 1e-4, as
that file's "gelu_tied_scaled" case: none of these configs has qk-norm, so
attention logits grow large enough to amplify float32 rounding, and a
float64 run of the port on the same inputs (xla) puts both packages'
float32 features 2e-5 to 1.4e-4 from it (gemma: the reference 8.7e-5, the
port 8.3e-5; minitron 1.4e-4 / 1.2e-4; qwen1.5 5.7e-5 / 2.8e-5; pixtral
2.1e-5 / 1.9e-5; whisper 4.1e-5 / 6.8e-5; arctic 9.7e-5 / 8.4e-5); loss
rtol 1e-5; each gradient leaf rtol 1e-4 plus atol 1e-4 x max(1, its
largest entry).

whisper: as in the reference, the training forward uses the encoder output
only to switch the decoder's cross-attention on; that sub-layer projects
its keys and values from the decoder's own stream, so the loss does not
read the encoder and the reference's encoder gradients are exactly zero,
which the port's equal (``value_and_grad`` gives zeros to the leaves of
the subtrees ``transformer.unused_in_loss`` names, and raises for any
other leaf the loss does not read).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.configs import shapes as r_shapes  # noqa: E402
from repro.distributed.sharding import strip  # noqa: E402
from repro.launch import train as r_train  # noqa: E402
from repro.models import transformer as r_tf  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs import adapters as t_adapters  # noqa: E402
from repro_torch.configs import shapes as t_shapes  # noqa: E402
from repro_torch.convert import from_reference, to_reference  # noqa: E402
from repro_torch.data import synthetic as t_synth  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.optim import tree_leaves, tree_map, value_and_grad  # noqa: E402
from repro_torch.testing import (injection_from_ctx, to_numpy_tree,  # noqa: E402
                                 to_torch, transformer_sites)
from test_torch_bf16_models import _WideDots  # noqa: E402

torch.set_num_threads(1)

ARCHS = ("gemma-2b", "minitron-8b", "qwen1.5-32b", "pixtral-12b",
         "whisper-base", "arctic-480b")
B, S, STEP = 2, 16, 3
FEAT_TOL = dict(rtol=1e-5, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-4
BF16_TOL = 3e-2       # the bfloat16 gate of chip_smoke.check_bf16_small


def _cfgs(arch, **kw):
    return (r_configs.get_arch(arch).smoke(**kw),
            t_configs.get_arch(arch).smoke(**kw))


def _batch(cfg, seq=S, seed=3):
    """{"tokens" | "embeds", "labels", ["frames"]}: tokens from the seeded
    stream, embeddings and frames from a seeded numpy generator."""
    stream = t_synth.lm_stream(cfg.vocab, B * (seq + 1) + 1, seed=seed)
    chunk = stream[:B * (seq + 1)].reshape(B, seq + 1)
    d = {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}
    rng = np.random.default_rng(seed)
    if cfg.embeds_in:
        d["embeds"] = rng.standard_normal((B, seq, cfg.d_model)).astype(np.float32)
        del d["tokens"]
    if cfg.is_encoder_decoder:
        d["frames"] = (rng.standard_normal((B, cfg.enc_seq, cfg.d_model)) * 0.02
                       ).astype(np.float32)
    return d


def _r_inputs(cfg, jb):
    return jb["embeds"] if cfg.embeds_in else jb["tokens"]


def _r_forward(p, jb, cfg, ctx=None):
    memory = (r_tf.encode(p, jb["frames"], cfg, ctx=ctx)
              if cfg.is_encoder_decoder else None)
    return r_tf.forward(p, _r_inputs(cfg, jb), cfg, ctx=ctx, memory=memory)


def _t_forward(p, b, cfg, ctx=None):
    memory = (t_tf.encode(p, b["frames"], cfg, ctx=ctx)
              if cfg.is_encoder_decoder else None)
    inputs = b["embeds"] if cfg.embeds_in else b["tokens"]
    return t_tf.forward(p, inputs, cfg, ctx=ctx, memory=memory)


_REFS = {}


def _reference(arch, attn_impl="xla", **kw):
    """Params, batch, injected masks, features, loss and grads of the
    reference (once per config)."""
    key_ = (arch, attn_impl, tuple(sorted(kw.items())))
    if key_ not in _REFS:
        r_cfg, t_cfg = _cfgs(arch, attn_impl=attn_impl, **kw)
        params = to_numpy_tree(strip(r_tf.init_params(jax.random.PRNGKey(0), r_cfg)))
        batch = _batch(r_cfg)
        key = jax.random.PRNGKey(11)
        inj = injection_from_ctx(r_cfg.plan.bind(key, STEP),
                                 transformer_sites(t_cfg, B, S))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jp = jax.tree.map(jnp.asarray, params)
        feats = _r_forward(jp, jb, r_cfg, ctx=r_cfg.plan.bind(key, STEP))
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: r_tf.loss_fn(p, jb, r_cfg, drop_key=key, step=STEP)))(jp)
        _REFS[key_] = dict(params=params, batch=batch, inj=inj, loss=float(loss),
                           feats=np.asarray(feats), grads=to_numpy_tree(grads))
    return _REFS[key_]


def _port_loss_grads(ref, t_cfg):
    lfn = value_and_grad(
        lambda p, b, **kw: t_adapters.loss_fn("transformer")(p, b, t_cfg, **kw),
        t_adapters.unused_in_loss("transformer", t_cfg))
    loss, grads = lfn(from_reference(ref["params"]), to_torch(ref["batch"]),
                      seed=0, step=STEP, injected=to_torch(ref["inj"]))
    return float(loss), to_reference(grads)


def _assert_grads(got, want, what):
    assert len(tree_leaves(got)) == len(tree_leaves(want)), what
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.shape == w.shape, what
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * max(1.0, np.abs(w).max()),
                                   err_msg=what)


# the dense configs here; pixtral and whisper in
# test_torch_transformer_configs_whisper.py, arctic in
# test_torch_transformer_configs_arctic.py (files spread over test workers)
DENSE = ("gemma-2b", "minitron-8b", "qwen1.5-32b")
CASES = [(a, i) for a in DENSE for i in ("xla", "flash")]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def _same_fields(t_cfg, r_cfg):
    for f in dataclasses.fields(t_cfg):
        if f.name in ("param_dtype", "compute_dtype", "plan", "moe_impl", "moe"):
            continue
        assert getattr(t_cfg, f.name) == getattr(r_cfg, f.name), f.name
    assert t_cfg.plan.to_dict() == r_cfg.plan.to_dict()
    assert (t_cfg.moe is None) == (r_cfg.moe is None)
    if t_cfg.moe is not None:
        for f in ("num_experts", "top_k", "capacity_factor", "dense_ff", "local_shards"):
            assert getattr(t_cfg.moe, f) == getattr(r_cfg.moe, f), f
    assert str(t_cfg.param_dtype)[6:] == str(jnp.dtype(r_cfg.param_dtype))
    assert str(t_cfg.compute_dtype)[6:] == str(jnp.dtype(r_cfg.compute_dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_matches_reference(arch):
    _same_fields(*_cfgs(arch)[::-1])


# (d_model, n_heads, kv heads after kv_repeat, head_dim, d_ff, vocab, layers)
FULL_WIDTHS = {
    "gemma-2b": (2048, 8, 8, 256, 16384, 256000, 18),
    "minitron-8b": (4096, 32, 16, 128, 16384, 256000, 32),
    "qwen1.5-32b": (5120, 40, 40, 128, 27392, 152064, 64),
    "pixtral-12b": (5120, 32, 16, 128, 14336, 131072, 40),
    "whisper-base": (512, 8, 8, 64, 2048, 51865, 6),
    "arctic-480b": (7168, 56, 8, 128, 4864, 32000, 35),
}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_matches_reference(arch):
    """The reference's widths, heads, kv_repeat, chunks, plan, options and
    dtypes (bfloat16 parameters and compute); ``attn_impl`` "xla"."""
    r_cfg, t_cfg = r_configs.get_arch(arch).full(), t_configs.get_arch(arch).full()
    _same_fields(t_cfg, r_cfg)
    assert (t_cfg.d_model, t_cfg.n_heads, t_cfg.n_kv_eff, t_cfg.hd, t_cfg.d_ff,
            t_cfg.vocab, t_cfg.num_layers) == FULL_WIDTHS[arch]
    assert t_cfg.param_dtype == t_cfg.compute_dtype == torch.bfloat16
    assert t_cfg.attn_impl == "xla" and t_cfg.remat == "full"


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch):
    r_cfg, t_cfg = _cfgs(arch)
    want = to_numpy_tree(strip(r_tf.init_params(jax.random.PRNGKey(0), r_cfg)))
    got = to_reference(t_tf.init_params(torch.Generator().manual_seed(0), t_cfg))
    flat = lambda t, p="": ({p: t.shape} if not isinstance(t, dict) else
                            {k: v for n in t for k, v in flat(t[n], f"{p}/{n}").items()})
    assert flat(got) == flat(want)
    assert ("embed" in got) == (not t_cfg.embeds_in)
    assert ("enc_blocks" in got) == t_cfg.is_encoder_decoder


def test_registry_knows_the_reference_archs():
    for arch in ARCHS:
        assert t_configs.get_arch(arch).kind == "transformer"
    missing = set(r_configs.REGISTRY) - set(t_configs.REGISTRY)
    assert missing == {"zamba2-1.2b"}, missing
    assert [s.name for s in t_configs.ASSIGNED] == [
        n for n in r_configs.ASSIGNED_NAMES if n != "zamba2-1.2b"]


def test_shapes_match_reference():
    assert t_shapes.SHAPE_NAMES == r_shapes.SHAPE_NAMES
    for name in t_shapes.SHAPE_NAMES:
        assert dataclasses.asdict(t_shapes.SHAPES[name]) == \
            dataclasses.asdict(r_shapes.SHAPES[name])


@pytest.mark.parametrize("arch", sorted(t_configs.REGISTRY))
def test_applicable_matches_reference(arch):
    t_spec, r_spec = t_configs.get_arch(arch), r_configs.get_arch(arch)
    for name in t_shapes.SHAPE_NAMES:
        assert t_spec.applicable(name) == r_spec.applicable(name), name
    assert (t_spec.family, t_spec.kind) == (r_spec.family, r_spec.kind)


# ---------------------------------------------------------------------------
# training: features, loss, gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,attn_impl", CASES)
def test_features_match_reference(arch, attn_impl):
    ref = _reference(arch, attn_impl)
    _, t_cfg = _cfgs(arch, attn_impl=attn_impl)
    ctx = t_cfg.plan.bind(0, STEP, injected=to_torch(ref["inj"]))
    with torch.no_grad():
        feats = _t_forward(from_reference(ref["params"]), to_torch(ref["batch"]),
                           t_cfg, ctx=ctx)
    np.testing.assert_allclose(feats.numpy(), ref["feats"], **FEAT_TOL)


@pytest.mark.parametrize("arch,attn_impl", CASES)
def test_loss_and_grads_match_reference(arch, attn_impl):
    ref = _reference(arch, attn_impl)
    _, t_cfg = _cfgs(arch, attn_impl=attn_impl)
    loss, grads = _port_loss_grads(ref, t_cfg)
    np.testing.assert_allclose(loss, ref["loss"], **LOSS_TOL)
    _assert_grads(grads, ref["grads"], f"{arch}/{attn_impl}")
    if arch == "whisper-base":      # the loss does not read the encoder
        assert all(not g.any() for g in tree_leaves(grads["enc_blocks"]))


def test_identity_attention_matches_reference():
    """``attn_impl="identity"``: q times v repeated over each kv head's
    group (minitron smoke: 4 query heads over 2 kv heads)."""
    ref = _reference("minitron-8b", "identity")
    _, t_cfg = _cfgs("minitron-8b", attn_impl="identity")
    loss, grads = _port_loss_grads(ref, t_cfg)
    np.testing.assert_allclose(loss, ref["loss"], **LOSS_TOL)
    _assert_grads(grads, ref["grads"], "identity")
    q = torch.randn(1, 3, 4, 8)
    v = torch.randn(1, 3, 2, 8)
    got = t_tf._attend(q, v, v, t_cfg, True)
    torch.testing.assert_close(got[:, :, 1], q[:, :, 1] * v[:, :, 0])
    torch.testing.assert_close(got[:, :, 2], q[:, :, 2] * v[:, :, 1])


# ---------------------------------------------------------------------------
# remat="dots"
# ---------------------------------------------------------------------------


class _CountDots(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the aten.mm / aten.addmm calls made under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in t_tf._SAVED_DOTS
        return func(*args, **(kwargs or {}))


def _backward_dots(t_cfg, ref):
    """(loss, grads, mm + addmm calls in the backward alone)."""
    params = tree_map(lambda p: p.detach().requires_grad_(True),
                      from_reference(ref["params"]))
    loss = t_tf.loss_fn(params, to_torch(ref["batch"]), t_cfg, seed=0, step=STEP,
                        injected=to_torch(ref["inj"]))
    mode = _CountDots()
    with mode:
        grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True,
                                    materialize_grads=True)
    return float(loss.detach()), [g.numpy() for g in grads], mode.n


@pytest.mark.parametrize("arch", ["gemma-2b"])
def test_remat_dots_matches_full_and_reference(arch):
    """The same loss and gradients as "full" (bit for bit: the saved
    products are the ones "full" recomputes) and as the reference's "dots";
    the backward calls mm / addmm as often as without remat ("none"), so no
    saved product is recomputed, and "full" calls them more often."""
    ref = _reference(arch, remat="dots")
    runs = {r: _backward_dots(_cfgs(arch, remat=r)[1], ref) for r in ("dots", "full", "none")}
    loss, grads, n_dots = runs["dots"]
    np.testing.assert_allclose(loss, ref["loss"], **LOSS_TOL)
    _assert_grads(grads, tree_leaves(ref["grads"]), f"{arch}/dots")
    assert loss == runs["full"][0]
    for g, f in zip(grads, runs["full"][1]):
        np.testing.assert_array_equal(g, f)
    assert n_dots == runs["none"][2] < runs["full"][2], {r: v[2] for r, v in runs.items()}


# ---------------------------------------------------------------------------
# bfloat16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_bf16_step_against_float64(arch):
    """One bfloat16 training step (parameters and compute bfloat16, the full
    configs' dtypes) from the reference's bfloat16 init, against the same
    step in float64 on those parameters, widened (the port's, on the CPU).
    The smoke configs are ill-conditioned in bfloat16 (a gradient leaf of
    gemma's lands 15% of its largest entry off float64), so, as
    tests/test_torch_bf16_models.py, the yardstick is the reference's own
    bfloat16 step on the same parameters and masks: each gradient leaf's
    distance to float64 within 2 x the reference's + 1e-3 x max(1, |ref|),
    the loss within 2e-2 of float64 (one scalar is one draw of rounding
    noise). The reference's bfloat16 MoE einsums run with widened operands
    (``_WideDots``: XLA's CPU runtime cannot run them in bfloat16). arctic takes capacity factor 2.0 (every expert a slot for every
    token), as that file's mixtral: at 1.25 which token a full expert drops
    flips with the rounding."""
    bf, f64 = dict(param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16), torch.float64
    r_cfg = r_configs.get_arch(arch).smoke(**bf)
    t_kw = dict(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    if r_cfg.moe is not None:
        r_cfg = dataclasses.replace(r_cfg, moe=dataclasses.replace(r_cfg.moe,
                                                                   capacity_factor=2.0))
        t_kw["moe"] = dataclasses.replace(t_configs.get_arch(arch).smoke().moe,
                                          capacity_factor=2.0)
    t_bf = t_configs.get_arch(arch).smoke(**t_kw)
    params = to_numpy_tree(strip(r_tf.init_params(jax.random.PRNGKey(0), r_cfg)))
    batch = _batch(r_cfg)
    key = jax.random.PRNGKey(11)
    inj = to_torch(injection_from_ctx(r_cfg.plan.bind(key, STEP),
                                      transformer_sites(t_bf, B, S)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    saved = r_tf.jnp
    r_tf.jnp = _WideDots()
    try:
        r_loss, r_grads = jax.jit(jax.value_and_grad(lambda p: r_tf.loss_fn(
            p, jb, r_cfg, drop_key=key, step=STEP)))(jax.tree.map(jnp.asarray, params))
    finally:
        r_tf.jnp = saved
    t_params = from_reference(params)
    res = {}
    for name, cfg in (("bf16", t_bf), ("f64", dataclasses.replace(
            t_bf, param_dtype=f64, compute_dtype=f64,
            moe=None if t_bf.moe is None else dataclasses.replace(t_bf.moe, router_dtype=f64)))):
        lfn = value_and_grad(lambda p, b, **k: t_tf.loss_fn(p, b, cfg, **k),
                             t_tf.unused_in_loss(cfg))
        loss, grads = lfn(tree_map(lambda p: p.to(cfg.param_dtype), t_params),
                          to_torch(batch), seed=0, step=STEP, injected=inj)
        assert all(g.dtype == cfg.param_dtype for g in tree_leaves(grads))
        res[name] = (float(loss), [g.double().numpy() for g in tree_leaves(grads)])
    assert abs(res["bf16"][0] - res["f64"][0]) <= 2e-2 * abs(res["f64"][0])
    ref = [np.asarray(g, np.float64) for g in tree_leaves(to_numpy_tree(r_grads))]
    for i, (got, want, r) in enumerate(zip(res["bf16"][1], res["f64"][1], ref)):
        port, yard = np.abs(got - want).max(), np.abs(r - want).max()
        assert port <= 2 * yard + 1e-3 * max(1.0, np.abs(want).max()), (arch, i, port, yard)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma-2b"])
def test_trainer_batches_equal_reference(arch):
    """``make_batch_fn``: tokens, labels, embeddings and frames equal to the
    reference trainer's at steps 0 and 3."""
    r_spec = r_configs.get_arch(arch)
    cfg = r_spec.smoke()
    r_fn = r_train.make_batch_fn(r_spec, cfg, 2, 10, 4)
    t_fn = t_train.make_batch_fn("transformer", t_configs.get_arch(arch).smoke(),
                                 2, 10, 4, torch.device("cpu"))
    for step in (0, 3):
        want, got = r_fn(step), t_fn(step)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("arch", ["gemma-2b"])
def test_train_cli_runs_on_cpu(arch):
    res = t_train.run(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                       "--batch", "2", "--seq", "16"])
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    assert res["cfg"].name == t_configs.get_arch(arch).smoke().name
    assert all(torch.isfinite(p).all() for p in tree_leaves(res["params"]))


