"""The port's luong-nmt training slice against the JAX reference: the NMT
pairs, parameter conversion of the NMT tree, and for every engine
(stepwise, scheduled, fused) the loss and every parameter gradient of
``seq2seq.loss_fn``, plus the port's training CLI on the NMT model.

Both sides get the same parameters (the reference's, converted leaf for
leaf), the same batch (``nmt_pairs``, bit-equal in the two packages) and
the same dropout masks (the reference's threefry-sampled tables, injected
into the port's ``DropoutCtx`` through ``testing.nmt_sites``). The
reference runs its ``stepwise`` oracle; each port engine runs under the
same plan with ``:pallas``, which on a CPU tensor takes the kernels' plain
versions. embed (16) != hidden (24), so the hoisted "dec/layer0/nr" site
has its own width. Batches come masked ("src_mask"/"tgt_mask") or ragged
("src_lengths"/"tgt_lengths", masks derived).

Tolerances are the reference's own for its three NMT engines
(tests/test_engine.py): loss rtol 2e-5, gradients rtol/atol 2e-4.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core.dropout_plan import DropoutPlan as RPlan  # noqa: E402
from repro.data import synthetic as r_synth  # noqa: E402
from repro.models import seq2seq as r_s2s  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs import adapters as t_adapters  # noqa: E402
from repro_torch.convert import from_reference, to_reference  # noqa: E402
from repro_torch.core.dropout_plan import DropoutPlan as TPlan  # noqa: E402
from repro_torch.data import synthetic as t_synth  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import seq2seq as t_s2s  # noqa: E402
from repro_torch.optim import tree_leaves, value_and_grad  # noqa: E402
from repro_torch.testing import (injection_from_ctx, nmt_sites,  # noqa: E402
                                 to_numpy_tree, to_torch)

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=2e-5, atol=0)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
B, L, V, E, H, STEP = 3, 9, 60, 16, 24, 2
SITES = ("nr", "rh", "out")
PLANS = {"case1": "case1:0.5:pallas", "case3": "case3:0.5:bs4:pallas"}


@pytest.mark.parametrize("n,vocab,max_len,seed", [(8, 60, 11, 3), (64, 50000, 50, 0)])
def test_nmt_pairs_bit_equal(n, vocab, max_len, seed):
    want = r_synth.nmt_pairs(n, vocab, vocab, max_len=max_len, seed=seed)
    got = t_synth.nmt_pairs(n, vocab, vocab, max_len=max_len, seed=seed)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _batch(path):
    d = r_synth.nmt_pairs(B, V, V, max_len=L, seed=13)
    if path == "lengths":
        d["src_lengths"] = d.pop("src_mask").sum(1).astype(np.int32)
        d["tgt_lengths"] = d.pop("tgt_mask").sum(1).astype(np.int32)
    return d


_REF = {}


def _reference(case, path):
    """Reference params, batch, injected masks, loss and grads (cached)."""
    if (case, path) not in _REF:
        plan = RPlan.parse(PLANS[case], sites=SITES)
        cfg = r_s2s.NMTConfig(src_vocab=V, tgt_vocab=V, embed=E, hidden=H,
                              num_layers=2, plan=plan, engine="stepwise")
        params = r_s2s.init_params(jax.random.PRNGKey(7), cfg)
        batch = _batch(path)
        key = jax.random.PRNGKey(11)
        inj = injection_from_ctx(plan.bind(key, STEP), nmt_sites(cfg, B, L, L))
        jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
        loss, grads = jax.value_and_grad(
            lambda p: r_s2s.loss_fn(p, jb, cfg, drop_key=key, step=STEP))(params)
        _REF[case, path] = dict(params=to_numpy_tree(params), batch=batch,
                                inj=inj, loss=float(loss),
                                grads=to_numpy_tree(grads))
    return _REF[case, path]


def _port_cfg(case, engine):
    return t_s2s.NMTConfig(src_vocab=V, tgt_vocab=V, embed=E, hidden=H,
                           num_layers=2,
                           plan=TPlan.parse(PLANS[case], sites=SITES),
                           engine=engine)


def test_injected_sites_cover_plan():
    inj = _reference("case3", "masks")["inj"]
    assert set(inj) == {"enc/layer0/nr", "enc/layer0/rh", "enc/layer1/nr",
                        "enc/layer1/rh", "enc/out", "dec/layer0/nr",
                        "dec/feed/nr", "dec/layer0/rh", "dec/layer1/rh",
                        "dec/layer1/nr", "dec/out"}
    assert inj["dec/layer0/nr"].shape == (L, 2)       # 16 units / bs 4, p .5
    assert inj["dec/feed/nr"].shape == (L, 3)         # 24 units / bs 4
    assert inj["enc/out"].shape == (1, 3)


@pytest.mark.parametrize("engine", ["stepwise", "scheduled", "fused"])
@pytest.mark.parametrize("path", ["masks", "lengths"])
@pytest.mark.parametrize("case", ["case1", "case3"])
def test_loss_and_grads_match_reference(case, path, engine):
    ref = _reference(case, path)
    cfg = _port_cfg(case, engine)
    lfn = value_and_grad(
        lambda p, b, **kw: t_adapters.loss_fn("nmt")(p, b, cfg, **kw))
    loss, grads = lfn(from_reference(ref["params"]), to_torch(ref["batch"]),
                      seed=0, step=STEP, injected=to_torch(ref["inj"]))
    np.testing.assert_allclose(float(loss), ref["loss"], **LOSS_TOL)
    got, want = to_reference(grads), ref["grads"]
    for path_, g, w in zip(_paths(want), tree_leaves(got), tree_leaves(want)):
        assert g.shape == w.shape, path_
        np.testing.assert_allclose(g, w, err_msg=f"{case}/{path}/{engine} d{path_}",
                                   **GRAD_TOL)


def test_convert_nmt_tree():
    params = _reference("case3", "masks")["params"]
    port = from_reference(params)
    assert sorted(port) == sorted(params)
    assert isinstance(port["decoder"], list) and len(port["decoder"]) == 2
    assert port["decoder"][0]["W"].shape == (E, 4 * H)     # embed-only fan-in
    assert port["w_feed"].shape == (H, 4 * H)
    for a, b in zip(tree_leaves(to_reference(port)), tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    # the port's own init has the same tree and shapes
    own = t_s2s.init_params(torch.Generator().manual_seed(0),
                            _port_cfg("case3", "fused"))
    assert [tuple(x.shape) for x in tree_leaves(own)] == \
        [x.shape for x in tree_leaves(params)]


def test_luong_nmt_spec():
    spec = t_configs.get_arch("luong-nmt")
    cfg = spec.full()
    assert (spec.kind, cfg.src_vocab, cfg.tgt_vocab, cfg.embed, cfg.hidden,
            cfg.num_layers) == ("nmt", 50000, 50000, 512, 512, 2)
    assert t_adapters.apply_engine(spec, cfg, "fused").engine == "fused"
    over = t_adapters.apply_dropout(spec, cfg, "case3:0.3:pallas")
    assert over.plan.spec("dec/feed/nr").impl == "pallas"
    assert set(over.plan.active_sites()) == set(SITES)


def test_train_cli_runs_on_cpu():
    res = t_train.run(["--arch", "luong-nmt", "--smoke", "--device", "cpu",
                       "--engine", "fused", "--steps", "2"])
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    assert all(torch.isfinite(p).all() for p in tree_leaves(res["params"]))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}/{i}")]
    return [prefix]
