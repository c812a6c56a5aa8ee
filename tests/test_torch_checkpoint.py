"""The port's checkpoints (``repro_torch.checkpoint``) and the trainer's
``--ckpt-dir`` / ``--resume auto`` against the JAX reference's layout.

A round trip restores every leaf bit for bit (tensors, Python ints, bools)
into fresh tensors of the template's dtype; a step directory without its
manifest is skipped and removed by the next save; ``keep`` bounds the
complete steps kept. Across the packages: a checkpoint the reference
writes (its params and clip + AdamW state) restores into the port's tree
leaf for leaf, and one the port writes restores into the reference's, with
the manifest's ``meta`` (the dropout plan) read back by the other side's
``DropoutPlan.from_dict``. A CPU training run resumed from its checkpoint
gives the losses and parameters of a straight run, bit for bit.
"""
import os
import signal

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import checkpoint as r_ckpt  # noqa: E402
from repro import optim as r_optim  # noqa: E402
from repro.core.dropout_plan import DropoutPlan as RPlan  # noqa: E402
from repro.models import tagger as r_tag  # noqa: E402

from repro_torch import checkpoint as t_ckpt  # noqa: E402
from repro_torch import optim as t_optim  # noqa: E402
from repro_torch.checkpoint.store import read_manifest  # noqa: E402
from repro_torch.configs import adapters as t_adapters  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core.dropout_plan import DropoutPlan as TPlan  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import tagger as t_tag  # noqa: E402
from repro_torch.optim import tree_leaves  # noqa: E402
from repro_torch.testing import to_numpy_tree  # noqa: E402

torch.set_num_threads(1)

DIMS = dict(vocab=40, char_vocab=12, char_embed=4, char_filters=6,
            char_kernel=3, word_embed=10, hidden=8, num_tags=5)
PLAN = "case3:0.5:bs4"


def _tree():
    g = torch.Generator().manual_seed(0)
    params = t_tag.init_params(g, t_tag.TaggerConfig(**DIMS))
    params["char_conv"]["b"] = torch.randn(6, generator=g)
    opt = t_optim.chain(t_optim.clip_by_global_norm(1.0), t_optim.adamw(1e-3),
                        t_optim.nt_asgd(0.1))
    state = opt.init(params)
    state = (state[0], {**state[1], "step": 7},
             t_optim.trigger_averaging({**state[2], "step": 3}))
    return params, state


def _assert_same(got, want):
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if torch.is_tensor(y):
            assert torch.is_tensor(x) and x.dtype == y.dtype
            assert torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y


def test_round_trip(tmp_path):
    tree = _tree()
    meta = {"dropout_plan": TPlan.parse(PLAN, sites=("inp", "rh")).to_dict()}
    d = t_ckpt.save_checkpoint(str(tmp_path), 5, tree, meta=meta)
    assert sorted(os.listdir(d)) == ["MANIFEST.json", "shard_00000_of_00001.npz"]
    man = read_manifest(str(tmp_path), 5)
    assert man["meta"] == meta and man["step"] == 5
    assert "1/1/step" in man["keys"] and "0/fwd/0/W" in man["keys"]
    template = t_optim.tree_map(
        lambda x: torch.zeros_like(x) if torch.is_tensor(x) else type(x)(0), tree)
    got, step = t_ckpt.restore_checkpoint(str(tmp_path), template)
    assert step == 5
    _assert_same(got, tree)
    assert got[1][2]["avg_on"] is True and got[1][2]["avg_start"] == 3
    # fresh tensors
    assert all(a is not b for a, b in zip(tree_leaves(got), tree_leaves(tree))
               if torch.is_tensor(a))


def test_incomplete_step_is_skipped_and_collected(tmp_path):
    tree = _tree()
    t_ckpt.save_checkpoint(str(tmp_path), 2, tree)
    crashed = tmp_path / "step_000000004"
    crashed.mkdir()
    (crashed / "shard_00000_of_00001.npz").write_bytes(b"partial")
    assert t_ckpt.latest_step(str(tmp_path)) == 2
    _, step = t_ckpt.restore_checkpoint(str(tmp_path), tree)
    assert step == 2
    t_ckpt.save_checkpoint(str(tmp_path), 6, tree)
    assert not crashed.exists()
    assert t_ckpt.latest_step(str(tmp_path)) == 6
    with pytest.raises(FileNotFoundError):
        t_ckpt.restore_checkpoint(str(tmp_path / "none"), tree)


def test_keep(tmp_path):
    tree = _tree()
    for s in (1, 2, 3, 4, 5):
        t_ckpt.save_checkpoint(str(tmp_path), s, tree, keep=3)
    assert sorted(os.listdir(tmp_path)) == [f"step_{s:09d}" for s in (3, 4, 5)]


def _ref_tree():
    cfg = r_tag.TaggerConfig(**DIMS)
    params = r_tag.init_params(jax.random.PRNGKey(3), cfg)
    opt = r_optim.chain(r_optim.clip_by_global_norm(1.0), r_optim.adamw(1e-3))
    state = opt.init(params)
    g = jax.tree.map(lambda p: jax.numpy.ones_like(p) * 0.1, params)
    _, state = opt.update(g, state, params)               # moments and step 1
    return params, state


def test_reference_checkpoint_restores_into_port(tmp_path):
    params, state = _ref_tree()
    meta = {"dropout_plan": RPlan.parse(PLAN, sites=("inp", "rh")).to_dict()}
    r_ckpt.save_checkpoint(str(tmp_path), 3, (params, state), meta=meta)
    t_params = t_tag.init_params(torch.Generator().manual_seed(0),
                                 t_tag.TaggerConfig(**DIMS))
    opt = t_optim.chain(t_optim.clip_by_global_norm(1.0), t_optim.adamw(1e-3))
    (got, got_state), step = t_ckpt.restore_checkpoint(
        str(tmp_path), (t_params, opt.init(t_params)))
    assert step == 3 and got_state[1]["step"] == 1
    for a, b in zip(tree_leaves(got), tree_leaves(to_numpy_tree(params))):
        np.testing.assert_array_equal(a.numpy(), b)
    for k in ("m", "v"):
        for a, b in zip(tree_leaves(got_state[1][k]),
                        tree_leaves(to_numpy_tree(state[1][k]))):
            np.testing.assert_array_equal(a.numpy(), b)
    plan = TPlan.from_dict(read_manifest(str(tmp_path), 3)["meta"]["dropout_plan"])
    assert plan == TPlan.parse(PLAN, sites=("inp", "rh"))


def test_port_checkpoint_restores_into_reference(tmp_path):
    r_params, r_state = _ref_tree()
    params = from_reference(to_numpy_tree(r_params))
    opt = t_optim.chain(t_optim.clip_by_global_norm(1.0), t_optim.adamw(1e-3))
    state = opt.init(params)
    state = opt.update_(t_optim.tree_map(lambda p: torch.full_like(p, 0.1),
                                         params), state, params)
    meta = {"dropout_plan": TPlan.parse(PLAN, sites=("inp", "rh")).to_dict()}
    t_ckpt.save_checkpoint(str(tmp_path), 9, (params, state), meta=meta)
    (rp, rs), step = r_ckpt.restore_checkpoint(str(tmp_path), (r_params, r_state))
    assert step == 9 and int(rs[1]["step"]) == 1
    assert np.asarray(rs[1]["step"]).dtype == np.int32
    for a, b in zip(tree_leaves(to_numpy_tree(rp)), tree_leaves(params)):
        np.testing.assert_array_equal(a, b.numpy())
    for a, b in zip(jax.tree.leaves(rs[1]["m"]), tree_leaves(state[1]["m"])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    meta_back = read_manifest(str(tmp_path), 9)["meta"]
    assert RPlan.from_dict(meta_back["dropout_plan"]) == \
        RPlan.parse(PLAN, sites=("inp", "rh"))


def test_train_resume_matches_straight_run(tmp_path):
    args = ["--arch", "bilstm-ner", "--smoke", "--device", "cpu", "--engine",
            "fused", "--dropout", "case3:0.5:bs8:pallas", "--batch", "4",
            "--seq", "8", "--seed", "3"]
    straight = t_train.run(args + ["--steps", "4"])
    d = str(tmp_path / "ck")
    first = t_train.run(args + ["--steps", "2", "--ckpt-dir", d])
    assert t_ckpt.latest_step(d) == 2
    resumed = t_train.run(args + ["--steps", "4", "--ckpt-dir", d,
                                  "--resume", "auto"])
    assert resumed["start"] == 2 and t_ckpt.latest_step(d) == 4
    assert first["losses"] + resumed["losses"] == straight["losses"]
    _assert_same(resumed["params"], straight["params"])
    meta = read_manifest(d, 4)["meta"]
    spec = t_adapters.dropout_override("tagger", "case3:0.5:bs8:pallas")
    assert TPlan.from_dict(meta["dropout_plan"]) == spec


def test_preemption_hook_requests_a_save():
    prev = signal.getsignal(signal.SIGTERM)
    hook = t_ckpt.PreemptionHook()
    try:
        assert signal.getsignal(signal.SIGTERM) == hook._handler
        assert not hook.should_save
        hook._handler(signal.SIGTERM, None)
        assert hook.should_save
    finally:
        hook.restore()
    assert signal.getsignal(signal.SIGTERM) == prev
