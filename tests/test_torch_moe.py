"""The port's mixture-of-experts FFN and the mixtral training step against
the JAX reference.

``moe_ffn``: the port's against ``repro.models.transformer.moe_ffn(pl, x2d,
cfg, None)`` on the same layer parameters (the reference's init, unwrapped
by ``strip`` and converted leaf for leaf) and the same tokens: output, and
the gradients of ``sum(y * w)`` for x, the router and the three expert
weights, at top_k 1 and 2, capacity factor 1.25 and 0.5 (where tokens are
dropped) and local_shards 1 and 2. Router inputs are continuous random
draws, so the top-k never meets a tie (``jax.lax.top_k`` puts the lower
index first on ties, ``torch.topk`` promises no order). The ``"pallas"``
route (K12 through its autograd.Function; on the CPU its plain version)
against ``"xla"`` (``torch.matmul``).

The step: loss and every parameter gradient of the mixtral smoke config
(2 layers, d_model 64, 4 query heads over 2 kv heads, 4 experts top-2,
window 8, NR p=0.25 block 8) with injected reference masks, on the
``"xla"`` and ``"pallas"`` expert routes and with a dense-residual FFN
(arctic's ``dense_ff``). The port's mixtral-8x22b config against the
reference's, and the training CLI.

Tolerances (float32, the same arithmetic in another summation order):
moe_ffn output rtol 1e-5 plus atol 1e-5 x its largest entry (values reach
~1e2), gradients rtol 1e-5 plus atol 1e-5 x each leaf's largest entry; at
top_k 1 the router's exact gradient is zero (the renormalised gate is 1),
so there both sides must lie within 1e-6 x the largest x gradient of zero;
the pallas route against xla as moe_ffn; the step as
tests/test_torch_transformer.py: loss rtol 1e-5, gradients rtol 1e-4 plus
atol 1e-4 x each leaf's largest entry.
"""
import dataclasses
import math

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
from repro_torch.data import synthetic as t_synth  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.optim import tree_leaves, value_and_grad  # noqa: E402
from repro_torch.testing import (injection_from_ctx, to_numpy_tree,  # noqa: E402
                                 to_torch, transformer_sites)

torch.set_num_threads(1)

ARCH = "mixtral-8x22b"
T_TOK = 48                              # tokens through moe_ffn
B, S, STEP = 2, 16, 3
MOE_TOL = 1e-5
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-4
LEAVES = ("router", "we_gate", "we_up", "we_down")


def _moe_cfgs(top_k, cf, shards, dense_ff=0):
    r_smoke, t_smoke = r_configs.get_arch(ARCH).smoke(), t_configs.get_arch(ARCH).smoke()
    r_cfg = dataclasses.replace(r_smoke, moe=dataclasses.replace(
        r_smoke.moe, top_k=top_k, capacity_factor=cf, local_shards=shards,
        dense_ff=dense_ff))
    t_cfg = dataclasses.replace(t_smoke, moe=dataclasses.replace(
        t_smoke.moe, top_k=top_k, capacity_factor=cf, local_shards=shards,
        dense_ff=dense_ff))
    return r_cfg, t_cfg


_LAYER = {}


def _layer():
    """Layer 0 of the reference's mixtral smoke params (numpy), tokens and a
    cotangent."""
    if not _LAYER:
        r_cfg, _ = _moe_cfgs(2, 1.25, 1)
        p = to_numpy_tree(strip(r_tf.init_params(jax.random.PRNGKey(0), r_cfg)))
        rng = np.random.default_rng(5)
        _LAYER.update(
            pl={k: p["blocks"][k][0] for k in LEAVES},
            x=rng.standard_normal((T_TOK, r_cfg.d_model)).astype(np.float32),
            w=rng.standard_normal((T_TOK, r_cfg.d_model)).astype(np.float32))
    return _LAYER


def _ref_moe(r_cfg):
    d = _layer()
    jp = {k: jnp.asarray(v) for k, v in d["pl"].items()}

    def f(pl, x):
        y = r_tf.moe_ffn(pl, x, r_cfg, None)
        return (y * jnp.asarray(d["w"])).sum(), y
    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jp, jnp.asarray(d["x"]))
    return np.asarray(y), dict({k: np.asarray(v) for k, v in gp.items()}, x=np.asarray(gx))


def _port_moe(t_cfg):
    d = _layer()
    pl = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in d["pl"].items()}
    x = torch.from_numpy(d["x"].copy()).requires_grad_(True)
    y = t_tf.moe_ffn(pl, x, t_cfg)
    grads = torch.autograd.grad((y * torch.from_numpy(d["w"])).sum(),
                                [pl[k] for k in LEAVES] + [x])
    return y.detach().numpy(), dict(zip(LEAVES + ("x",), (g.numpy() for g in grads)))


def _close(got, want, rtol, atol_rel, what):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


MOE_MODES = [(1, 1.25, 1), (2, 1.25, 1), (1, 0.5, 1), (2, 0.5, 1),
             (2, 1.25, 2), (1, 0.5, 2), (2, 0.5, 2)]


@pytest.mark.parametrize("top_k,cf,shards", MOE_MODES)
def test_moe_ffn_matches_reference(top_k, cf, shards):
    r_cfg, t_cfg = _moe_cfgs(top_k, cf, shards)
    E = t_cfg.moe.num_experts
    C = max(1, int(math.ceil(T_TOK // shards * top_k / E * cf)))
    if cf < 1:      # fewer slots than assignments in every shard: drops happen
        assert E * C < T_TOK // shards * top_k
    y_r, g_r = _ref_moe(r_cfg)
    y_t, g_t = _port_moe(t_cfg)
    _close(y_t, y_r, MOE_TOL, MOE_TOL, "output")
    for k in g_r:
        assert g_t[k].shape == g_r[k].shape
        if k == "router" and top_k == 1:
            # the renormalised gate is exactly 1, so the router's gradient
            # is exactly zero: both sides are rounding noise (the
            # reference's reaches 3e-5 here, against dx entries of ~1e2)
            bound = 1e-6 * np.abs(g_r["x"]).max()
            assert np.abs(g_r[k]).max() <= bound and np.abs(g_t[k]).max() <= bound
            continue
        _close(g_t[k], g_r[k], MOE_TOL, MOE_TOL, f"d{k}")


@pytest.mark.parametrize("top_k,cf,shards", [(2, 1.25, 1), (2, 0.5, 2)])
def test_pallas_route_equals_xla(top_k, cf, shards):
    """The two expert-product routes compute one function: K12 (plain on
    the CPU) with the autograd.Function's library backward, and
    torch.matmul differentiated by autograd."""
    _, t_cfg = _moe_cfgs(top_k, cf, shards)
    y_x, g_x = _port_moe(t_cfg)
    y_p, g_p = _port_moe(dataclasses.replace(t_cfg, moe_impl="pallas"))
    _close(y_p, y_x, MOE_TOL, MOE_TOL, "output")
    for k in g_x:
        _close(g_p[k], g_x[k], MOE_TOL, MOE_TOL, f"d{k}")


# ---------------------------------------------------------------------------
# The training step
# ---------------------------------------------------------------------------

STEP_CASES = {"smoke": ({}, "xla"), "smoke_pallas": ({}, "pallas"),
              "dense_ff": (dict(dense_ff=32), "xla")}


def _step_cfgs(name):
    extra, impl = STEP_CASES[name]
    r_cfg, t_cfg = _moe_cfgs(2, 1.25, 1, **extra)
    return r_cfg, dataclasses.replace(t_cfg, moe_impl=impl)


_REFS = {}


def _reference(name):
    key_ = STEP_CASES[name][0].get("dense_ff", 0)
    if key_ not in _REFS:
        r_cfg, t_cfg = _step_cfgs(name)
        params = to_numpy_tree(strip(r_tf.init_params(jax.random.PRNGKey(0), r_cfg)))
        stream = t_synth.lm_stream(r_cfg.vocab, B * (S + 1) + 1, seed=3)
        chunk = stream[:B * (S + 1)].reshape(B, S + 1)
        batch = {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}
        key = jax.random.PRNGKey(11)
        inj = injection_from_ctx(r_cfg.plan.bind(key, STEP), transformer_sites(t_cfg, B, S))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: r_tf.loss_fn(p, jb, r_cfg, drop_key=key, step=STEP)))(
                jax.tree.map(jnp.asarray, params))
        _REFS[key_] = dict(params=params, batch=batch, inj=inj, loss=float(loss),
                           grads=to_numpy_tree(grads))
    return _REFS[key_]


def test_moe_sites_have_no_ffn_inner():
    """A MoE layer draws attn/nr and mlp/nr (the latter consumed only by a
    dense-residual FFN) and never mlp/ffn_inner, as the reference."""
    _, t_cfg = _step_cfgs("smoke")
    sites = t_tf.dropout_sites(t_cfg, B, S)
    assert [s[0] for s in sites] == ["attn/nr", "mlp/nr"] * t_cfg.num_layers
    assert set(_reference("smoke")["inj"]) == {"attn/nr", "mlp/nr"}


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_loss_and_grads_match_reference(name):
    ref = _reference(name)
    _, t_cfg = _step_cfgs(name)
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
                                   atol=GRAD_ATOL_REL * np.abs(w).max(), err_msg=name)


def test_param_tree_matches_reference():
    """Router, experts and the dense-residual FFN: the same leaves and
    shapes as the reference's tree."""
    r_cfg, t_cfg = _step_cfgs("dense_ff")
    want = to_numpy_tree(strip(r_tf.init_params(jax.random.PRNGKey(0), r_cfg)))
    got = to_reference(t_tf.init_params(torch.Generator().manual_seed(0), t_cfg))
    flat = lambda t, p="": ({p: t.shape} if not isinstance(t, dict) else
                            {k: v for n in t for k, v in flat(t[n], f"{p}/{n}").items()})
    assert flat(got) == flat(want)
    assert flat(got)["/blocks/we_down"] == (2, 4, 128, 64)


def test_full_config_matches_reference():
    """mixtral-8x22b: the reference's widths, heads, kv_repeat, window,
    experts, chunks, plan and every other field, and its dtypes (bfloat16
    parameters and compute, a float32 router); ``moe_impl`` is the port's
    own."""
    r_cfg, t_cfg = r_configs.get_arch(ARCH).full(), t_configs.get_arch(ARCH).full()
    for f in dataclasses.fields(t_cfg):
        if f.name in ("param_dtype", "compute_dtype", "plan", "moe", "moe_impl"):
            continue
        assert getattr(t_cfg, f.name) == getattr(r_cfg, f.name), f.name
    for f in dataclasses.fields(t_cfg.moe):
        if f.name != "router_dtype":
            assert getattr(t_cfg.moe, f.name) == getattr(r_cfg.moe, f.name), f.name
    assert t_cfg.plan.to_dict() == r_cfg.plan.to_dict()
    assert t_cfg.moe.router_dtype == torch.float32
    assert t_cfg.param_dtype == t_cfg.compute_dtype == torch.bfloat16
    assert str(jnp.dtype(r_cfg.param_dtype)) == str(jnp.dtype(r_cfg.compute_dtype)) == "bfloat16"
    assert str(jnp.dtype(r_cfg.moe.router_dtype)) == "float32"
    assert (t_cfg.d_model, t_cfg.n_heads, t_cfg.n_kv_eff, t_cfg.hd, t_cfg.d_ff,
            t_cfg.vocab, t_cfg.window, t_cfg.moe.num_experts, t_cfg.moe.top_k) == (
                6144, 48, 16, 128, 16384, 32768, 4096, 8, 2)
    assert t_cfg.moe_impl == "xla" and t_configs.get_arch(ARCH).family == "moe"


def test_bad_moe_impl_raises():
    with pytest.raises(ValueError):
        t_configs.get_arch(ARCH).smoke(moe_impl="cuda")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_train_cli_runs_on_cpu(impl):
    res = t_train.run(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
                       "--batch", "2", "--seq", "16"],
                      cfg_fn=lambda c: dataclasses.replace(c, moe_impl=impl))
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    assert res["cfg"].moe_impl == impl and res["cfg"].moe.num_experts == 4
