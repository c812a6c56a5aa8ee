"""The port's main-path slice against the JAX reference: the zaremba-medium
LM training step (loss, every parameter gradient, one clip + AdamW update)
and the port's training CLI.

Both sides get the same parameters (the reference's, converted leaf for leaf
by ``repro_torch.convert``), the same batch (numpy, seeded) and the same
dropout masks (the reference's threefry-sampled tables, injected into the
port's ``DropoutCtx``). The reference runs engine ``fused`` under
``case3:0.5:bs8:pallas`` (Pallas in interpret mode, as the reference's own
tests run it on the CPU); each port engine runs under the same plan string,
which on a CPU tensor takes the kernels' plain versions.

Tolerances (float32, same arithmetic in a different summation order):
loss rtol 1e-5; gradients rtol 1e-4 with atol 1e-6 (entries are O(1e-3)
and many are exactly zero where dropout removed a unit).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as r_configs  # noqa: E402
from repro import optim as r_optim  # noqa: E402
from repro.configs import adapters as r_adapters  # noqa: E402
from repro.launch import steps as r_steps  # noqa: E402
from repro.models import lstm_lm as r_lm  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs import adapters as t_adapters  # noqa: E402
from repro_torch.convert import from_reference, to_reference  # noqa: E402
from repro_torch.data import synthetic as t_synth  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.optim import tree_leaves, value_and_grad  # noqa: E402
from repro_torch.testing import (injection_from_ctx, lm_sites,  # noqa: E402
                                 to_numpy_tree, to_torch)

torch.set_num_threads(1)

PLAN = "case3:0.5:bs8:pallas"
B, S, STEP = 3, 6, 2
LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _cfgs(plan=PLAN):
    r_spec = r_configs.get_arch("zaremba-medium")
    r_cfg = r_adapters.apply_engine(
        r_spec, r_adapters.apply_dropout(r_spec, r_spec.smoke(), plan), "fused")
    t_spec = t_configs.get_arch("zaremba-medium")
    t_cfg = t_adapters.apply_dropout(t_spec, t_spec.smoke(), plan)
    return r_spec, r_cfg, t_spec, t_cfg


def _batch(vocab, lengths=None):
    stream = t_synth.lm_stream(vocab, B * (S + 1) + 1, seed=3)
    chunk = stream[:B * (S + 1)].reshape(B, S + 1)
    d = {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}
    if lengths is not None:
        d["lengths"] = np.asarray(lengths, np.int32)
    return d


@pytest.fixture(scope="module")
def reference():
    """Reference params, batch, injected masks, loss and grads (computed once)."""
    r_spec, r_cfg, _, t_cfg = _cfgs()
    params = r_lm.init_params(jax.random.PRNGKey(0), r_cfg)
    batch = _batch(r_cfg.vocab)
    key = jax.random.PRNGKey(11)
    ctx = r_cfg.plan.bind(key, STEP)
    inj = injection_from_ctx(ctx, lm_sites(r_cfg, B, S))
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(
        lambda p: r_lm.loss_fn(p, jb, r_cfg, drop_key=key, step=STEP))(params)
    return dict(params=to_numpy_tree(params), batch=batch, inj=inj, key=key,
                loss=float(loss), grads=to_numpy_tree(grads), r_spec=r_spec,
                r_cfg=r_cfg, t_cfg=t_cfg)


def _port_loss_grads(ref, cfg):
    params = from_reference(ref["params"])
    lfn = value_and_grad(
        lambda p, b, **kw: t_adapters.loss_fn("lstm_lm")(p, b, cfg, **kw))
    return lfn(params, to_torch(ref["batch"]), seed=0, step=STEP,
               injected=to_torch(ref["inj"]))


def test_injected_sites_cover_plan(reference):
    """Every active site of the forward gets a table; structured ones are
    sorted exact-k block ids."""
    inj = reference["inj"]
    assert set(inj) == {"embed", "out", "lstm/layer0/nr", "lstm/layer0/rh",
                        "lstm/layer1/nr", "lstm/layer1/rh"}
    assert inj["lstm/layer0/rh"].shape == (S, 4)       # 64 units / bs 8, p .5
    assert inj["embed"].shape == (1, 4)                # one row: t=None
    for table in inj.values():
        assert (np.diff(table, axis=-1) > 0).all()


@pytest.mark.parametrize("engine", ["stepwise", "scheduled", "fused"])
def test_loss_and_grads_match_reference(reference, engine):
    cfg = t_adapters.apply_engine(t_configs.get_arch("zaremba-medium"),
                                  reference["t_cfg"], engine)
    loss, grads = _port_loss_grads(reference, cfg)
    np.testing.assert_allclose(float(loss), reference["loss"], **LOSS_TOL)
    got = to_reference(grads)
    want = reference["grads"]
    for path, g, w in zip(_paths(want), tree_leaves(got), tree_leaves(want)):
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, err_msg=f"{engine} d{path}", **GRAD_TOL)


@pytest.mark.parametrize("engine", ["scheduled", "fused"])
def test_xla_impl_matches_pallas_impl(reference, engine):
    """':xla' (plain torch everywhere) computes the same step as ':pallas'."""
    cfg_p = t_adapters.apply_engine(t_configs.get_arch("zaremba-medium"),
                                    reference["t_cfg"], engine)
    cfg_x = _cfgs(PLAN.replace("pallas", "xla"))[3]
    cfg_x = t_adapters.apply_engine(t_configs.get_arch("zaremba-medium"),
                                    cfg_x, engine)
    lp, gp = _port_loss_grads(reference, cfg_p)
    lx, gx = _port_loss_grads(reference, cfg_x)
    np.testing.assert_allclose(float(lx), float(lp), **LOSS_TOL)
    for a, b in zip(tree_leaves(gx), tree_leaves(gp)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


def test_ragged_batch_matches_reference():
    """Per-row lengths freeze the carries and mask the loss identically
    (fused engine on both sides)."""
    _, r_cfg, _, t_cfg = _cfgs()
    t_cfg = t_adapters.apply_engine(t_configs.get_arch("zaremba-medium"),
                                    t_cfg, "fused")
    params = r_lm.init_params(jax.random.PRNGKey(1), r_cfg)
    batch = _batch(r_cfg.vocab, lengths=[6, 2, 0])
    key = jax.random.PRNGKey(5)
    inj = injection_from_ctx(r_cfg.plan.bind(key, 0), lm_sites(r_cfg, B, S))
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(
        lambda p: r_lm.loss_fn(p, jb, r_cfg, drop_key=key, step=0))(params)
    lfn = value_and_grad(
        lambda p, b, **kw: t_adapters.loss_fn("lstm_lm")(p, b, t_cfg, **kw))
    t_loss, t_grads = lfn(from_reference(to_numpy_tree(params)),
                          to_torch(batch), seed=0, step=0,
                          injected=to_torch(inj))
    np.testing.assert_allclose(float(t_loss), float(loss), **LOSS_TOL)
    for g, w in zip(tree_leaves(to_reference(t_grads)),
                    tree_leaves(to_numpy_tree(grads))):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


def test_train_step_update_matches_reference(reference):
    """One clip(1.0) + AdamW step: loss and updated params match the
    reference's ``make_train_step``."""
    r_opt = r_optim.chain(r_optim.clip_by_global_norm(1.0), r_optim.adamw(1e-3))
    r_step = r_steps.make_train_step(reference["r_spec"], reference["r_cfg"],
                                     r_opt, None)
    rp = jax.tree.map(jax.numpy.asarray, reference["params"])
    jb = {k: jax.numpy.asarray(v) for k, v in reference["batch"].items()}
    rp2, _, rloss = r_step(rp, r_opt.init(rp), jb, STEP, reference["key"])

    t_spec = t_configs.get_arch("zaremba-medium")
    cfg = t_adapters.apply_engine(t_spec, reference["t_cfg"], "fused")
    t_opt = t_steps.default_opt(1e-3)
    tp = from_reference(reference["params"])
    t_step = t_steps.make_train_step(t_spec, cfg, t_opt)
    tp2, state, tloss = t_step(tp, t_opt.init(tp), to_torch(reference["batch"]),
                               STEP, 0, injected=to_torch(reference["inj"]))
    assert state[1]["step"] == 1
    np.testing.assert_allclose(float(tloss), float(rloss), **LOSS_TOL)
    for g, w in zip(tree_leaves(to_reference(tp2)),
                    tree_leaves(to_numpy_tree(rp2))):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)


def test_convert_round_trip(reference):
    back = to_reference(from_reference(reference["params"]))
    for a, b in zip(tree_leaves(back), tree_leaves(reference["params"])):
        np.testing.assert_array_equal(a, b)


def test_train_cli_runs_on_cpu(capsys):
    res = t_train.run(["--arch", "zaremba-medium", "--smoke", "--steps", "3",
                       "--batch", "4", "--seq", "8", "--device", "cpu",
                       "--dropout", "case3:0.5:pallas", "--engine", "fused"])
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    out = capsys.readouterr().out
    assert out.count(" ms") >= 3 and "loss" in out
    assert t_train.main(["--arch", "awd-lstm", "--smoke", "--steps", "1",
                         "--batch", "2", "--seq", "4", "--device", "cpu"]) == 0


def test_entry_point_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_train.main(["--arch", "zaremba-medium", "--smoke", "--steps", "1"])


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}/{i}")]
    return [prefix]
