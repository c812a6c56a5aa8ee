"""The port's in-place optimizer step (``Optimizer.update_``, which
``launch.steps.make_train_step`` runs) against the out-of-place AdamW and
global-norm clip arithmetic, written out here: the same float32 operations
in the same order, so the parameters and moments must be equal bit for
bit, over three steps of a random tree with clipping active and weight
decay on and off. (Its parity with the JAX reference is
tests/test_torch_engines.py::test_adamw_chain_matches_reference and
tests/test_torch_xlstm.py::test_train_step_update_matches_reference.)

Then the rest of the reference's optimizer package against the JAX
reference, on the same numpy inputs: ``sgd`` with a constant and a
scheduled learning rate (``lr(step)`` before the increment), ``nt_asgd``
through ``trigger_averaging`` and ``averaged_params``, every schedule over
a range of int and tensor steps, and ``gradient_accumulation`` with 1, 2
and 4 microbatches on the zaremba-medium smoke LM's loss and gradients
under case3 with the reference's tables injected (and ``make_train_step``
with ``n_micro``). Tolerances: updates rtol 1e-6 / atol 1e-7 (float32, the
same operations), schedules rtol 1e-6, accumulation the LM tests' loss
rtol 1e-5 and gradient rtol 1e-4 / atol 1e-6.
"""
import numpy as np
import pytest
import torch

from repro_torch import optim as t_optim
from repro_torch.optim import (adamw, chain, clip_by_global_norm, tree_leaves,
                               tree_map)
from repro_torch.optim import schedules as t_sched

torch.set_num_threads(1)

LR, B1, B2, EPS, MAX_NORM = 1e-2, 0.9, 0.999, 1e-8, 1.0


def _tree(seed):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return {"a": t(5, 7), "blocks": [{"w": t(3, 4, 6), "b": t(6)}, {"w": t(2, 2)}],
            "z": (t(9),)}


def _grads(step):
    # large entries, so the global norm is far above MAX_NORM: clipping on
    return tree_map(lambda x: x * 40.0, _tree(100 + step))


def _written_out(params, grads_seq, weight_decay):
    """Out-of-place clip + AdamW, as the port computed it before the update
    went in place."""
    m = tree_map(torch.zeros_like, params)
    v = tree_map(torch.zeros_like, params)
    for step, grads in enumerate(grads_seq, start=1):
        g = torch.sqrt(sum(torch.sum(torch.square(x.float()))
                           for x in tree_leaves(grads)))
        scale = torch.clamp(MAX_NORM / torch.clamp(g, min=1e-12), max=1.0)
        assert float(scale) < 1.0
        grads = tree_map(lambda x: x * scale, grads)
        m = tree_map(lambda m, g: B1 * m + (1 - B1) * g.float(), m, grads)
        v = tree_map(lambda v, g: B2 * v + (1 - B2) * torch.square(g.float()),
                     v, grads)
        c1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(step))
        c2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(step))
        upd = tree_map(lambda m, v, p: -LR * ((m / c1) / (torch.sqrt(v / c2) + EPS)
                                               + weight_decay * p.float()),
                       m, v, params)
        params = tree_map(lambda p, u: p + u.to(p.dtype), params, upd)
    return params, m, v


def _opt(weight_decay):
    return chain(clip_by_global_norm(MAX_NORM),
                 adamw(LR, B1, B2, EPS, weight_decay=weight_decay))


def _bitwise_equal(got, want):
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_in_place_step_is_bitwise_the_out_of_place_arithmetic(weight_decay):
    grads_seq = [_grads(s) for s in range(3)]
    want_p, want_m, want_v = _written_out(_tree(0), grads_seq, weight_decay)
    opt = _opt(weight_decay)
    params = _tree(0)
    state = opt.init(params)
    leaves = tree_leaves(params)
    for grads in grads_seq:
        state = opt.update_(tree_map(torch.clone, grads), state, params)
    assert all(a is b for a, b in zip(tree_leaves(params), leaves))   # in place
    assert state[1]["step"] == 3
    _bitwise_equal(params, want_p)
    _bitwise_equal(state[1]["m"], want_m)
    _bitwise_equal(state[1]["v"], want_v)


def test_train_step_updates_in_place():
    """``make_train_step`` returns the tensors it was given, updated."""
    from repro_torch import configs
    from repro_torch.configs import adapters
    from repro_torch.launch import steps
    spec = configs.get_arch("zaremba-medium")
    cfg = spec.smoke()
    params = adapters.init_params(spec.kind, torch.Generator().manual_seed(0), cfg)
    opt = steps.default_opt(1e-3)
    state = opt.init(params)
    first = [p.clone() for p in tree_leaves(params)]
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 5), generator=g),
             "labels": torch.randint(0, cfg.vocab, (2, 5), generator=g)}
    new_params, new_state, loss = steps.make_train_step(spec, cfg, opt)(
        params, state, batch, 0, 0)
    assert new_params is params and np.isfinite(float(loss))
    assert all(a is b for a, b in zip(tree_leaves(new_state[1]["m"]),
                                      tree_leaves(state[1]["m"])))
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(params), first))


# ---------------------------------------------------------------------------
# the rest of the optimizer package against the JAX reference
# ---------------------------------------------------------------------------

UPD_TOL = dict(rtol=1e-6, atol=1e-7)


def _jax():
    return pytest.importorskip("jax")


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((4, 3)) * scale).astype(np.float32),
            "b": [(rng.standard_normal((5,)) * scale).astype(np.float32)]}


def _run_both(r_opt, t_opt, n_steps, between=None):
    """``n_steps`` updates of a 2-leaf tree on both sides; ``between(i,
    r_state, t_state)`` may replace the states before step i. Returns the
    final (reference params, reference state, port params, port state)."""
    jax = _jax()
    params = _np_tree(0)
    rp = jax.tree.map(jax.numpy.asarray, params)
    tp = tree_map(lambda x: torch.from_numpy(x.copy()), params)
    rs, ts = r_opt.init(rp), t_opt.init(tp)
    from repro import optim as r_optim
    for i in range(n_steps):
        if between is not None:
            rs, ts = between(i, rs, ts)
        g = _np_tree(10 + i, scale=0.5)
        ru, rs = r_opt.update(jax.tree.map(jax.numpy.asarray, g), rs, rp)
        rp = r_optim.apply_updates(rp, ru)
        ts = t_opt.update_(tree_map(lambda x: torch.from_numpy(x.copy()), g),
                           ts, tp)
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(rp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **UPD_TOL)
    return rp, rs, tp, ts


@pytest.mark.parametrize("lr", ["constant", "step_decay"])
def test_sgd_matches_reference(lr):
    """Also through clip, as Table 1 trains (``chain(clip(5.0), sgd(.))``);
    the schedule's decay lands between steps 1 and 2, so ``lr(step)`` must
    see the count before the increment, as the reference's."""
    from repro import optim as r_optim
    r_lr = 0.7 if lr == "constant" else r_optim.step_decay(0.7, 0.5, every=2)
    t_lr = 0.7 if lr == "constant" else t_sched.step_decay(0.7, 0.5, every=2)
    _, rs, _, ts = _run_both(
        r_optim.chain(r_optim.clip_by_global_norm(5.0), r_optim.sgd(r_lr)),
        chain(clip_by_global_norm(5.0), t_optim.sgd(t_lr)), 4)
    assert ts[1] == int(rs[1]) == 4


def test_nt_asgd_matches_reference():
    """Two SGD steps, then averaging from step 2 for three more: params,
    the average and ``averaged_params``."""
    jax = _jax()
    from repro import optim as r_optim
    from repro.optim import optimizers as r_opts

    def trigger(i, rs, ts):
        if i == 2:
            return r_opts.trigger_averaging(rs), t_optim.trigger_averaging(ts)
        return rs, ts
    rp, rs, tp, ts = _run_both(r_optim.nt_asgd(0.1), t_optim.nt_asgd(0.1), 5,
                               between=trigger)
    assert ts["avg_on"] and ts["avg_start"] == int(rs["avg_start"]) == 2
    assert ts["step"] == int(rs["step"]) == 5
    for a, b in zip(tree_leaves(ts["avg"]), jax.tree.leaves(rs["avg"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **UPD_TOL)
    got = t_optim.averaged_params(ts, tp)
    want = r_opts.averaged_params(rs, rp)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **UPD_TOL)


@pytest.mark.parametrize("name,args", [
    ("constant", (0.3,)), ("step_decay", (1.0, 0.5, 3, 2)),
    ("cosine", (0.1, 20)), ("cosine", (0.1, 20, 0.0)),
    ("linear_warmup_cosine", (0.1, 5, 20)),
    ("linear_warmup_cosine", (0.1, 0, 20, 0.2))])
def test_schedules_match_reference(name, args):
    jax = _jax()
    from repro.optim import schedules as r_sched
    r_f, t_f = getattr(r_sched, name)(*args), getattr(t_sched, name)(*args)
    for step in range(0, 26):
        want = float(np.asarray(r_f(jax.numpy.int32(step))))
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            np.testing.assert_allclose(float(t_f(s)), want, rtol=1e-6, atol=0,
                                       err_msg=f"{name}{args} at {step}")


def _lm_case():
    """The zaremba-medium smoke LM under case3 (bs 8), a batch of 4 rows,
    and the reference's tables for one microbatch (structured tables do not
    depend on the batch size, so every microbatch gets the same)."""
    jax = _jax()
    from repro import configs as r_configs
    from repro.configs import adapters as r_adapters
    from repro.models import lstm_lm as r_lm
    from repro_torch import configs as t_configs
    from repro_torch.configs import adapters as t_adapters
    from repro_torch.data import synthetic
    from repro_torch.testing import injection_from_ctx, lm_sites, to_numpy_tree
    plan, B, S = "case3:0.5:bs8", 4, 6
    r_spec = r_configs.get_arch("zaremba-medium")
    r_cfg = r_adapters.apply_dropout(r_spec, r_spec.smoke(num_layers=1), plan)
    t_spec = t_configs.get_arch("zaremba-medium")
    t_cfg = t_adapters.apply_dropout(t_spec, t_spec.smoke(num_layers=1), plan)
    params = r_lm.init_params(jax.random.PRNGKey(0), r_cfg)
    stream = synthetic.lm_stream(r_cfg.vocab, B * (S + 1), seed=3)
    chunk = stream.reshape(B, S + 1)
    batch = {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}
    key = jax.random.PRNGKey(11)
    inj = injection_from_ctx(r_cfg.plan.bind(key, 2), lm_sites(r_cfg, B, S))
    return dict(r_cfg=r_cfg, t_cfg=t_cfg, t_spec=t_spec,
                params=to_numpy_tree(params), batch=batch, key=key, inj=inj,
                r_loss=r_lm.loss_fn, t_loss=t_adapters.loss_fn("lstm_lm"))


@pytest.fixture(scope="module")
def lm_case():
    return _lm_case()


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_gradient_accumulation_matches_reference(lm_case, n_micro):
    jax = _jax()
    from repro import optim as r_optim
    from repro_torch.convert import from_reference, to_reference
    from repro_torch.testing import to_numpy_tree, to_torch
    c = lm_case
    r_fn = r_optim.gradient_accumulation(
        lambda p, b, **kw: c["r_loss"](p, b, c["r_cfg"], **kw), n_micro)
    jb = {k: jax.numpy.asarray(v) for k, v in c["batch"].items()}
    r_l, r_g = r_fn(jax.tree.map(jax.numpy.asarray, c["params"]), jb,
                    drop_key=c["key"], step=2)
    t_fn = t_optim.gradient_accumulation(
        lambda p, b, **kw: c["t_loss"](p, b, c["t_cfg"], **kw), n_micro)
    t_l, t_g = t_fn(from_reference(c["params"]), to_torch(c["batch"]), seed=0,
                    step=2, injected=to_torch(c["inj"]))
    np.testing.assert_allclose(float(t_l), float(r_l), rtol=1e-5, atol=0)
    for a, b in zip(tree_leaves(to_reference(t_g)),
                    tree_leaves(to_numpy_tree(r_g))):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    if n_micro > 1:
        # the train step accumulates the same way before its one update
        from repro_torch.launch import steps
        opt = t_optim.sgd(0.0)
        params = from_reference(c["params"])
        _, _, loss = steps.make_train_step(c["t_spec"], c["t_cfg"], opt,
                                           n_micro=n_micro)(
            params, opt.init(params), to_torch(c["batch"]), 2, 0,
            injected=to_torch(c["inj"]))
        assert float(loss) == float(t_l)
        with pytest.raises(ValueError):
            t_fn(params, {k: v[:3] for k, v in to_torch(c["batch"]).items()},
                 seed=0, step=2, injected=to_torch(c["inj"]))
