"""The port's three LSTM engines compute one function, and its optimizer
update equals the reference's.

Engines: with the port's own sampler (counter-based rows: schedule row t is
``state(t=t)``), ``stepwise``, ``scheduled`` and ``fused`` give the same
outputs, final states and gradients for Case I-IV, ragged or not, under
both implementations. Tolerance: float32, different operation order:
rtol/atol 1e-5 forward, 1e-4 gradients.

Optimizer: clip_by_global_norm + AdamW with weight decay on the same
parameter tree and gradients, three steps, against ``repro.optim``
(rtol 1e-6, atol 1e-7; only the bias-correction constants round
differently).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import lstm as t_lstm
from repro_torch.core.dropout_plan import DropoutPlan
from repro_torch.optim import adamw, chain, clip_by_global_norm, tree_leaves

torch.set_num_threads(1)


def _stack(engine, plan, lengths=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = t_lstm.init_lstm_params(g, 12, 16, 2, init_scale=0.3)
    x = torch.randn(6, 3, 12, generator=g)
    st = t_lstm.LSTMState(h=torch.randn(2, 3, 16, generator=g) * 0.3,
                          c=torch.randn(2, 3, 16, generator=g) * 0.3)
    leaves = [x] + [p[k] for p in params for k in ("W", "U", "b")]
    for leaf in leaves:
        leaf.requires_grad_(True)
    ctx = plan.bind(5, 2)
    ys, fin = t_lstm.lstm_stack(params, x, st, ctx=ctx, engine=engine,
                                lengths=lengths)
    loss = (ys ** 2).sum() + (fin.h * fin.c).sum()
    return [ys.detach(), fin.h.detach(), fin.c.detach()], torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("case", ["case1", "case2", "case3", "case4"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("ragged", [False, True])
def test_engines_agree(case, impl, ragged):
    plan = DropoutPlan.parse(f"{case}:0.5:bs4:{impl}", sites=("nr", "rh"))
    lengths = torch.tensor([6, 3, 0], dtype=torch.int32) if ragged else None
    ref_out, ref_grads = _stack("stepwise", plan, lengths)
    for engine in ("scheduled", "fused"):
        out, grads = _stack(engine, plan, lengths)
        for a, b in zip(out, ref_out):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        for a, b in zip(grads, ref_grads):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_no_dropout_engines_agree():
    plan = DropoutPlan.off()
    ref_out, _ = _stack("stepwise", plan)
    for engine in ("scheduled", "fused"):
        for a, b in zip(_stack(engine, plan)[0], ref_out):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_unknown_engine_raises():
    with pytest.raises(ValueError):
        _stack("cudnn", DropoutPlan.off())


def test_adamw_chain_matches_reference():
    jax = pytest.importorskip("jax")
    from repro import optim as r_optim
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": [rng.standard_normal((5,)).astype(np.float32)]}
    grads = [{"a": rng.standard_normal((4, 3)).astype(np.float32) * s,
              "b": [rng.standard_normal((5,)).astype(np.float32) * s]}
             for s in (3.0, 0.1, 1e-3)]
    r_opt = r_optim.chain(r_optim.clip_by_global_norm(1.0),
                          r_optim.adamw(1e-2, weight_decay=0.1))
    t_opt = chain(clip_by_global_norm(1.0), adamw(1e-2, weight_decay=0.1))
    rp = jax.tree.map(jax.numpy.asarray, params)
    tp = {"a": torch.from_numpy(params["a"].copy()),
          "b": [torch.from_numpy(params["b"][0].copy())]}
    rs, ts = r_opt.init(rp), t_opt.init(tp)
    for g in grads:
        ru, rs = r_opt.update(jax.tree.map(jax.numpy.asarray, g), rs, rp)
        rp = r_optim.apply_updates(rp, ru)
        ts = t_opt.update_({"a": torch.from_numpy(g["a"].copy()),
                            "b": [torch.from_numpy(g["b"][0].copy())]}, ts, tp)
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(rp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
