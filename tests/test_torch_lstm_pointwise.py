"""K5, the fused LSTM cell update, and the ``pointwise_impl`` knob of the
port's ``lstm_stack``, against the JAX reference.

The plain K5 against the reference's ``lstm_pointwise`` with
``impl="pallas"`` (the Pallas kernel in interpret mode, as the reference's
own tests run it on the CPU) and ``impl="xla"``, for forget_bias 0 and 1,
on shapes the reference's kernel takes as they are and on shapes it pads
(B past its 128-row tile, H past its 512-unit tile). The port's
``lstm_stack(..., pointwise_impl="pallas")`` forward, stepwise and
scheduled engines, against the reference's on the reference's masks
(threefry-sampled schedule tables, injected into the port); the fused
engine under the renamed knob (with the RH site inactive it picks the
scan), forward and gradients. K5 is forward-only in the reference
(``jax.grad`` through its Pallas call fails to linearize): the port raises
on a gradient through it. The ``cuda``-marked tests hold the CUDA kernel
against the plain version on the card (skipped without one).

Tolerances: float32 rtol/atol 1e-5 (the same formula; sigmoid and tanh
rounded differently); the stack 1e-5 forward, 1e-4 gradients (float32, the
same arithmetic in another order); on the card 1e-5 x max(1, |ref|),
bfloat16 1e-2.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import lstm as t_lstm
from repro_torch.core.dropout_plan import DropoutPlan
from repro_torch.kernels import lstm_pointwise as k5
from repro_torch.testing import require_cuda, to_torch

torch.set_num_threads(1)

T, B, D, H, L, STEP = 6, 3, 12, 16, 2, 2


def _gates(Bn, Hn, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((Bn, 4 * Hn)) * 2).astype(np.float32),
            rng.standard_normal((Bn, Hn)).astype(np.float32))


@pytest.mark.parametrize("Bn,Hn", [(3, 40), (130, 520), (5, 600)])
@pytest.mark.parametrize("forget_bias", [0.0, 1.0])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_plain_matches_reference(Bn, Hn, forget_bias, impl):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import lstm as r_lstm
    g, c = _gates(Bn, Hn, seed=Bn)
    want = r_lstm.lstm_pointwise(jnp.asarray(g), jnp.asarray(c),
                                 forget_bias=forget_bias, impl=impl)
    got = k5.lstm_pointwise(torch.from_numpy(g), torch.from_numpy(c),
                            forget_bias=forget_bias)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def _stack_inputs():
    rng = np.random.default_rng(7)
    params = [{"W": (rng.standard_normal((D if l == 0 else H, 4 * H)) * 0.3).astype(np.float32),
               "U": (rng.standard_normal((H, 4 * H)) * 0.3).astype(np.float32),
               "b": (rng.standard_normal(4 * H) * 0.1).astype(np.float32)}
              for l in range(L)]
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    h0, c0 = (rng.standard_normal((L, B, H)).astype(np.float32) * 0.3 for _ in range(2))
    return params, x, h0, c0


def _sites(sites):
    out = []
    for l in range(L):
        if "nr" in sites:
            out.append((f"lstm/layer{l}/nr", "schedule", T, B, D if l == 0 else H))
        if "rh" in sites:
            out.append((f"lstm/layer{l}/rh", "schedule", T, B, H))
    return out


def _reference_stack(engine, pointwise_impl, sites, forget_bias=0.0):
    """The reference's outputs and final states (numpy) and its masks."""
    import jax
    import jax.numpy as jnp
    from repro.core import lstm as r_lstm
    from repro.core.dropout_plan import DropoutPlan as RPlan
    from repro_torch.testing import injection_from_ctx
    params, x, h0, c0 = _stack_inputs()
    ctx = RPlan.parse("case3:0.5:bs4", sites=sites).bind(jax.random.PRNGKey(11), STEP)
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    ys, fin = r_lstm.lstm_stack(jp, jnp.asarray(x),
                                r_lstm.LSTMState(jnp.asarray(h0), jnp.asarray(c0)),
                                ctx=ctx, engine=engine, forget_bias=forget_bias,
                                pointwise_impl=pointwise_impl)
    inj = injection_from_ctx(ctx, _sites(sites))
    return [np.asarray(ys), np.asarray(fin.h), np.asarray(fin.c)], inj


def _port_stack(engine, pointwise_impl, sites, inj, forget_bias=0.0, grad=False):
    params, x, h0, c0 = (to_torch(a) for a in _stack_inputs())
    leaves = [x] + [p[k] for p in params for k in ("W", "U", "b")]
    for leaf in leaves:
        leaf.requires_grad_(grad)
    ctx = DropoutPlan.parse("case3:0.5:bs4", sites=sites).bind(
        0, STEP, injected=to_torch(inj))
    with torch.set_grad_enabled(grad):
        ys, fin = t_lstm.lstm_stack(params, x, t_lstm.LSTMState(h0, c0), ctx=ctx,
                                    engine=engine, forget_bias=forget_bias,
                                    pointwise_impl=pointwise_impl)
    out = [ys, fin.h, fin.c]
    grads = (torch.autograd.grad((ys ** 2).sum() + (fin.h * fin.c).sum(), leaves)
             if grad else None)
    return [o.detach().numpy() for o in out], grads


@pytest.mark.parametrize("engine", ["stepwise", "scheduled"])
@pytest.mark.parametrize("forget_bias", [0.0, 1.0])
def test_stack_pallas_pointwise_matches_reference(engine, forget_bias):
    """The forward of the stepwise and scheduled engines with K5 as the
    cell update, on the reference's NR and RH masks."""
    pytest.importorskip("jax")
    want, inj = _reference_stack(engine, "pallas", ("nr", "rh"), forget_bias)
    before = k5.LAUNCHES["lstm_pointwise"]
    got, _ = _port_stack(engine, "pallas", ("nr", "rh"), inj, forget_bias)
    assert k5.LAUNCHES["lstm_pointwise"] == before      # the CPU route: plain
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    xla, _ = _port_stack(engine, "xla", ("nr", "rh"), inj, forget_bias)
    for a, b in zip(got, xla):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_fused_engine_under_the_renamed_knob():
    """With the RH site inactive, ``pointwise_impl`` picks the fused
    engine's scan, as the reference's knob does: both impls give the
    reference's forward, and the same gradients."""
    pytest.importorskip("jax")
    want, inj = _reference_stack("fused", "pallas", ("nr",))
    outs = {}
    for impl in ("pallas", "xla"):
        outs[impl] = _port_stack("fused", impl, ("nr",), inj, grad=True)
        for a, b in zip(outs[impl][0], want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(outs["pallas"][1], outs["xla"][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_gradient_through_k5_raises():
    g, c = (torch.from_numpy(a) for a in _gates(3, 8))
    with pytest.raises(RuntimeError, match="no reverse mode"):
        k5.lstm_pointwise(g.requires_grad_(True), c)
    with torch.no_grad():
        h, c2 = k5.lstm_pointwise(g, c)
    assert h.shape == c2.shape == (3, 8)


@pytest.mark.parametrize("engine", ["stepwise", "scheduled"])
def test_training_through_pallas_pointwise_raises(engine):
    """A training step of the stepwise or scheduled engine with K5, as the
    reference's ``jax.grad`` through its Pallas kernel fails."""
    with pytest.raises(RuntimeError, match="forward-only"):
        _port_stack(engine, "pallas", ("nr", "rh"), None, grad=True)


def test_bad_shapes_raise():
    g, c = (torch.from_numpy(a) for a in _gates(3, 8))
    with pytest.raises(ValueError):
        k5.lstm_pointwise(g[:, :-1], c)
    with pytest.raises(ValueError):
        k5.lstm_pointwise(g, c[:2])


# ---------------------------------------------------------------------------
# On the card (skipped without one)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("Bn,Hn,forget_bias,dtype", [
    (20, 650, 0.0, torch.float32), (20, 1500, 1.0, torch.float32),
    (7, 33, 1.0, torch.float32), (64, 512, 0.0, torch.bfloat16)])
def test_cuda_kernel_matches_plain(Bn, Hn, forget_bias, dtype):
    dev = require_cuda()
    g, c = (torch.from_numpy(a).to(dev, dtype) for a in _gates(Bn, Hn, seed=Hn))
    before = k5.LAUNCHES["lstm_pointwise"]
    with torch.no_grad():
        got = k5.lstm_pointwise(g, c, forget_bias=forget_bias)
    torch.cuda.synchronize()
    assert k5.LAUNCHES["lstm_pointwise"] == before + 1
    want = k5.lstm_pointwise_plain(g, c, forget_bias=forget_bias)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert (a.float() - b.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["stepwise", "scheduled"])
def test_cuda_stack_pallas_equals_xla(engine):
    dev = require_cuda()
    params, x, h0, c0 = (to_torch(a, dev) for a in _stack_inputs())
    ctx = DropoutPlan.parse("case3:0.5:bs4", sites=("nr", "rh")).bind(5, STEP, device=dev)
    outs = {}
    before = k5.LAUNCHES["lstm_pointwise"]
    with torch.no_grad():
        for impl in ("pallas", "xla"):
            ys, fin = t_lstm.lstm_stack(params, x, t_lstm.LSTMState(h0, c0), ctx=ctx,
                                        engine=engine, pointwise_impl=impl)
            outs[impl] = [ys, fin.h, fin.c]
    assert k5.LAUNCHES["lstm_pointwise"] == before + T * L
    for a, b in zip(outs["pallas"], outs["xla"]):
        assert (a - b).abs().max().item() <= 1e-5
