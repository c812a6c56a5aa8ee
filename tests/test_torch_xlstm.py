"""The port's xlstm-1.3b training step against the JAX reference at a smoke
size: the mLSTM chunkwise cell alone, loss and every parameter gradient of
each port engine (also on a ragged batch), one clip + AdamW update, and the
training CLI.

Both sides get the same parameters (the reference's ``init_params`` tree
with the mLSTM causal-conv weights perturbed, since at init they are zero
and make every mLSTM cell output 0; converted leaf for leaf by
``repro_torch.convert``), the same batch (numpy, seeded) and the same
dropout masks (the reference's threefry-sampled tables, injected under the
reference's site names ``mlstm/nr``, ``slstm/nr`` and ``slstm{g}/rh``). The
reference runs engine ``fused`` with its RH kernel in interpret mode
(``:pallas``), once per dropout case; each port engine is held to it.

Size: 8 blocks (two groups of 3 mLSTM + 1 sLSTM), d_model 32, 4 heads,
vocab 64, mLSTM chunk 4 over a sequence of 12 (three chunks).

Tolerances (float32, same arithmetic in a different summation order): loss
rtol 1e-5; each gradient leaf rtol 1e-4 plus atol 1e-4 x its largest
entry (the leaves span four orders of magnitude and rounding errors follow
the leaf's scale, not each entry's: against a float64 run of the port, the
reference and the port in float32 are each within 4e-5 of every leaf's
largest entry); mLSTM cell outputs and gradients rtol/atol 1e-5 / 1e-4.
One AdamW step: from the same gradients the port's clip + AdamW equals the
reference's to rtol 1e-6, atol 1e-9; from each side's own gradients,
rtol 1e-5, atol 1e-7 wherever the gradient exceeds 1e-3 of its leaf's
largest entry. Adam's first step is lr g / (|g| + eps): below that the
step's size and sign are rounding's, so there the two only stay within
2 lr of each other.

The conv perturbation has std 0.1. With std 0.5 the blocks amplify float32
rounding until the reference is 1e-4 and the port 3.5e-4 of a leaf's
largest gradient away from the port's float64 run (which agrees with the
reference to the reference's own rounding): that size tests rounding, not
the port.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as r_configs  # noqa: E402
from repro import optim as r_optim  # noqa: E402
from repro.configs import adapters as r_adapters  # noqa: E402
from repro.distributed.sharding import strip  # noqa: E402
from repro.models import xlstm as r_xlstm  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs import adapters as t_adapters  # noqa: E402
from repro_torch.convert import from_reference, to_reference  # noqa: E402
from repro_torch.data import synthetic as t_synth  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import xlstm as t_xlstm  # noqa: E402
from repro_torch.optim import tree_leaves, value_and_grad  # noqa: E402
from repro_torch.testing import (injection_from_ctx, to_numpy_tree,  # noqa: E402
                                 to_torch, xlstm_sites)

torch.set_num_threads(1)

ARCH = "xlstm-1.3b"
SMALL = dict(num_layers=8, slstm_every=4, d_model=32, n_heads=4, vocab=64, chunk=4)
PLANS = {"case3": "case3:0.5:bs2:pallas", "case1": "case1:0.3:pallas"}
B, S, STEP = 2, 12, 3
CONV_STD = 0.1
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-4


def _cfgs(plan, engine="fused"):
    r_spec = r_configs.get_arch(ARCH)
    r_cfg = r_adapters.apply_engine(
        r_spec, r_adapters.apply_dropout(r_spec, r_spec.smoke(**SMALL), plan), "fused")
    t_spec = t_configs.get_arch(ARCH)
    t_cfg = t_adapters.apply_engine(
        t_spec, t_adapters.apply_dropout(t_spec, t_spec.smoke(**SMALL), plan), engine)
    return r_cfg, t_cfg


def _params(r_cfg):
    p = to_numpy_tree(strip(r_xlstm.init_params(jax.random.PRNGKey(0), r_cfg)))
    rng = np.random.default_rng(7)
    for name in ("conv_w", "conv_b"):
        leaf = p["mlstm"][name]
        p["mlstm"][name] = (rng.standard_normal(leaf.shape) * CONV_STD).astype(np.float32)
    return p


def _batch(vocab):
    stream = t_synth.lm_stream(vocab, B * (S + 1) + 1, seed=3)
    chunk = stream[:B * (S + 1)].reshape(B, S + 1)
    return {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}


_REFS = {}


def _reference(case):
    """Params, batch, injected masks, loss and grads of the reference's
    fused engine for one dropout case (computed once per case)."""
    if case not in _REFS:
        r_cfg, _ = _cfgs(PLANS[case])
        params = _params(r_cfg)
        batch = _batch(r_cfg.vocab)
        key = jax.random.PRNGKey(11)
        inj = injection_from_ctx(r_cfg.plan.bind(key, STEP), xlstm_sites(r_cfg, B, S))
        jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
        jp = jax.tree.map(jax.numpy.asarray, params)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: r_xlstm.loss_fn(p, jb, r_cfg, drop_key=key, step=STEP)))(jp)
        _REFS[case] = dict(params=params, batch=batch, inj=inj, loss=float(loss),
                           grads=to_numpy_tree(grads))
    return _REFS[case]


def _port_loss_grads(ref, cfg):
    lfn = value_and_grad(
        lambda p, b, **kw: t_adapters.loss_fn("xlstm")(p, b, cfg, **kw))
    return lfn(from_reference(ref["params"]), to_torch(ref["batch"]), seed=0,
               step=STEP, injected=to_torch(ref["inj"]))


def test_mlstm_chunkwise_matches_reference():
    """The chunkwise cell alone, fresh and from a carried state, with a
    chunk (5) that does not divide the sequence: h, the final (C, n, m) and
    the gradients of q, k, v, lf, li."""
    rng = np.random.default_rng(0)
    Bq, H, Sq, d = 2, 2, 12, 8
    f32 = np.float32
    q, k, v = (rng.standard_normal((Bq, H, Sq, d)).astype(f32) for _ in range(3))
    lf = np.log(1 / (1 + np.exp(-rng.standard_normal((Bq, H, Sq)) - 2))).astype(f32)
    li = rng.standard_normal((Bq, H, Sq)).astype(f32)
    init = (rng.standard_normal((Bq, H, d, d)).astype(f32) * 0.3,
            rng.standard_normal((Bq, H, d)).astype(f32) * 0.3,
            rng.standard_normal((Bq, H)).astype(f32) * 0.3)
    w = rng.standard_normal((Bq, H, Sq, d)).astype(f32)
    for chunk, initial in ((4, None), (5, init)):
        def r_loss(*a):
            h, (C, n, m) = r_xlstm.mlstm_chunkwise(
                *a, chunk, initial=None if initial is None else
                tuple(jax.numpy.asarray(x) for x in initial))
            return (h * w).sum() + C.sum() + n.sum() + m.sum(), (h, C, n, m)
        (_, r_out), r_g = jax.value_and_grad(r_loss, argnums=tuple(range(5)),
                                             has_aux=True)(q, k, v, lf, li)
        ins = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, lf, li)]
        h, (C, n, m) = t_xlstm.mlstm_chunkwise(
            *ins, chunk, initial=None if initial is None else
            tuple(torch.from_numpy(x) for x in initial))
        t_g = torch.autograd.grad((h * torch.from_numpy(w)).sum() + C.sum() + n.sum()
                                  + m.sum(), ins)
        for a, b in zip((h, C, n, m), r_out):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-5)
        for a, b in zip(t_g, r_g):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_injected_sites_cover_plan():
    inj = _reference("case3")["inj"]
    assert set(inj) == {"mlstm/nr", "slstm/nr", "slstm0/rh", "slstm1/rh"}
    assert inj["slstm0/rh"].shape == (S, 2)        # dh 8 / bs 2, p .5
    assert inj["mlstm/nr"].shape[0] == 7           # layer indices 0..6
    assert inj["slstm/nr"].shape[0] == 8           # layers 3 and 7


@pytest.mark.parametrize("engine", ["stepwise", "scheduled", "fused"])
@pytest.mark.parametrize("case", ["case3", "case1"])
def test_loss_and_grads_match_reference(case, engine):
    ref = _reference(case)
    loss, grads = _port_loss_grads(ref, _cfgs(PLANS[case], engine)[1])
    np.testing.assert_allclose(float(loss), ref["loss"], **LOSS_TOL)
    got, want = to_reference(grads), ref["grads"]
    assert len(tree_leaves(got)) == len(tree_leaves(want))
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * np.abs(w).max(),
                                   err_msg=f"{case}/{engine}")


@pytest.mark.parametrize("engine", ["stepwise", "fused"])
def test_ragged_batch_matches_reference(engine):
    """Per-row lengths freeze the sLSTM carries and mask the loss (chunked
    masked NLL) as the reference's fused engine does."""
    ref = _reference("case3")
    if "ragged" not in ref:
        r_cfg, _ = _cfgs(PLANS["case3"])
        key = jax.random.PRNGKey(11)
        jb = {k: jax.numpy.asarray(v) for k, v in ref["batch"].items()}
        jb["lengths"] = jax.numpy.asarray([S, 5], jax.numpy.int32)
        jp = jax.tree.map(jax.numpy.asarray, ref["params"])
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: r_xlstm.loss_fn(p, jb, r_cfg, drop_key=key, step=STEP)))(jp)
        ref["ragged"] = (float(loss), to_numpy_tree(grads))
    want_loss, want = ref["ragged"]
    batch = dict(ref["batch"], lengths=np.array([S, 5], np.int32))
    lfn = value_and_grad(lambda p, b, **kw: t_adapters.loss_fn("xlstm")(
        p, b, _cfgs(PLANS["case3"], engine)[1], **kw))
    loss, grads = lfn(from_reference(ref["params"]), to_torch(batch), seed=0,
                      step=STEP, injected=to_torch(ref["inj"]))
    np.testing.assert_allclose(float(loss), want_loss, **LOSS_TOL)
    for g, w in zip(tree_leaves(to_reference(grads)), tree_leaves(want)):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * np.abs(w).max())


def test_train_step_update_matches_reference():
    """One clip(1.0) + AdamW step: the port's optimizer on the reference's
    gradients equals the reference's, and the port's fused train step lands
    on the same parameters."""
    ref = _reference("case3")
    r_opt = r_optim.chain(r_optim.clip_by_global_norm(1.0), r_optim.adamw(1e-3))
    rp = jax.tree.map(jax.numpy.asarray, ref["params"])
    rg = jax.tree.map(jax.numpy.asarray, ref["grads"])
    rp2 = to_numpy_tree(jax.jit(lambda g, p: r_optim.apply_updates(
        p, r_opt.update(g, r_opt.init(p), p)[0]))(rg, rp))

    t_spec = t_configs.get_arch(ARCH)
    t_opt = t_steps.default_opt(1e-3)
    tp = from_reference(ref["params"])
    t_opt.update_(from_reference(ref["grads"]), t_opt.init(tp), tp)   # in place
    for g, w in zip(tree_leaves(to_reference(tp)), tree_leaves(rp2)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-9)

    tp = from_reference(ref["params"])
    t_step = t_steps.make_train_step(t_spec, _cfgs(PLANS["case3"], "fused")[1], t_opt)
    tp2, state, tloss = t_step(tp, t_opt.init(tp), to_torch(ref["batch"]), STEP, 0,
                               injected=to_torch(ref["inj"]))
    assert state[1]["step"] == 1
    np.testing.assert_allclose(float(tloss), ref["loss"], **LOSS_TOL)
    for g, w, dw in zip(tree_leaves(to_reference(tp2)), tree_leaves(rp2),
                        tree_leaves(ref["grads"])):
        big = np.abs(dw) > 1e-3 * np.abs(dw).max()
        np.testing.assert_allclose(g[big], w[big], rtol=1e-5, atol=1e-7)
        assert np.abs(g - w).max() <= 2e-3


def test_convert_keeps_missing_families():
    """A config without sLSTM blocks has ``"slstm": None`` in both trees."""
    r_cfg, t_cfg = _cfgs(PLANS["case3"])
    r_cfg = r_cfg.__class__(**{**r_cfg.__dict__, "num_layers": 3})
    p = to_numpy_tree(strip(r_xlstm.init_params(jax.random.PRNGKey(1), r_cfg)))
    assert p["slstm"] is None
    tp = from_reference(p)
    assert tp["slstm"] is None and to_reference(tp)["slstm"] is None
    t_cfg = t_cfg.__class__(**{**t_cfg.__dict__, "num_layers": 3})
    loss = t_adapters.loss_fn("xlstm")(tp, to_torch(_batch(64)), t_cfg, seed=0)
    assert torch.isfinite(loss)


def test_train_cli_runs_on_cpu():
    res = t_train.run(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--engine", "fused", "--steps", "2", "--batch", "2",
                       "--seq", "16"])
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    assert res["cfg"].engine == "fused" and res["cfg"].d_model == 64
