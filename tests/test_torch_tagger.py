"""The port's bilstm-ner slice (the paper's Table 3 tagger) against the JAX
reference: ``ner_examples`` and ``token_batches``, the tagger's parts
(``char_cnn``, ``crf_log_norm``, ``crf_score``, ``_reverse_valid``,
``viterbi``), and for every engine (stepwise, scheduled, fused) the loss and
every parameter gradient of ``tagger.loss_fn``, plus the port's training
CLI on the tagger.

Both sides get the same parameters (the reference's, converted leaf for
leaf), the same batch (``ner_examples``, bit-equal in the two packages) and
the same dropout masks (the reference's threefry-sampled tables, injected
into the port's ``DropoutCtx`` through ``tagger.dropout_sites``: "inp" and
each direction's RH schedule, "fwd/layer0/rh" and "bwd/layer0/rh", drawn
independently). The reference runs its ``stepwise`` oracle; each port
engine runs under the same plan with ``:pallas``, which on a CPU tensor
takes the kernels' plain versions. Batches come masked (``ner_examples``'
mask) or ragged ("lengths" with a row of length 0, masks derived: the
backward direction reads each row's valid prefix reversed).

Tolerances are the reference's own for its recurrent engines
(tests/test_engine.py): loss rtol 2e-5, gradients rtol/atol 2e-4; the parts
1e-5 (the same float32 operations in another summation order).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import metrics as r_metrics  # noqa: E402
from repro.core.dropout_plan import DropoutPlan as RPlan  # noqa: E402
from repro.data import synthetic as r_synth  # noqa: E402
from repro.models import tagger as r_tag  # noqa: E402

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs import adapters as t_adapters  # noqa: E402
from repro_torch.convert import from_reference, to_reference  # noqa: E402
from repro_torch.core import metrics as t_metrics  # noqa: E402
from repro_torch.core.dropout_plan import DropoutPlan as TPlan  # noqa: E402
from repro_torch.data import synthetic as t_synth  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import tagger as t_tag  # noqa: E402
from repro_torch.optim import tree_leaves, value_and_grad  # noqa: E402
from repro_torch.testing import (injection_from_ctx, to_numpy_tree,  # noqa: E402
                                 to_torch)

torch.set_num_threads(1)

LOSS_TOL = dict(rtol=2e-5, atol=0)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
PART_TOL = dict(rtol=1e-5, atol=1e-6)
B, S, WL, STEP = 4, 7, 5, 2
DIMS = dict(vocab=60, char_vocab=20, char_embed=6, char_filters=10,
            char_kernel=3, word_embed=14, hidden=16, num_tags=5)
SITES = ("inp", "rh")
PLANS = {"case1": "case1:0.5:pallas", "case3": "case3:0.5:bs4:pallas"}
LENGTHS = [7, 3, 0, 5]


@pytest.mark.parametrize("n,vocab,char_vocab,tags,seq,seed",
                         [(5, 60, 20, 5, 7, 3), (32, 20000, 100, 9, 64, 0)])
def test_ner_examples_bit_equal(n, vocab, char_vocab, tags, seq, seed):
    want = r_synth.ner_examples(n, vocab, char_vocab, tags, seq=seq, seed=seed)
    got = t_synth.ner_examples(n, vocab, char_vocab, tags, seq=seq, seed=seed)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_token_batches_bit_equal():
    stream = t_synth.lm_stream(50, 400, seed=2)
    got = list(t_synth.token_batches(stream, 4, 9))
    want = list(r_synth.token_batches(stream, 4, 9))
    assert len(got) == len(want) > 0
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def _batch(path):
    d = r_synth.ner_examples(B, DIMS["vocab"], DIMS["char_vocab"],
                             DIMS["num_tags"], seq=S, word_len=WL, seed=13)
    if path == "lengths":
        del d["mask"]
        d["lengths"] = np.asarray(LENGTHS, np.int32)
    return d


def _ref_cfg(case, engine="stepwise"):
    return r_tag.TaggerConfig(**DIMS, plan=RPlan.parse(PLANS[case], sites=SITES),
                              engine=engine)


def _port_cfg(case, engine):
    return t_tag.TaggerConfig(**DIMS, plan=TPlan.parse(PLANS[case], sites=SITES),
                              engine=engine)


_REF = {}


def _reference(case, path):
    """Reference params, batch, injected masks, loss and grads (cached)."""
    if (case, path) not in _REF:
        cfg = _ref_cfg(case)
        params = r_tag.init_params(jax.random.PRNGKey(7), cfg)
        batch = _batch(path)
        key = jax.random.PRNGKey(11)
        inj = injection_from_ctx(cfg.plan.bind(key, STEP),
                                 t_tag.dropout_sites(cfg, B, S))
        jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: r_tag.loss_fn(p, jb, cfg, drop_key=key, step=STEP)))(params)
        _REF[case, path] = dict(params=to_numpy_tree(params), batch=batch,
                                inj=inj, loss=float(loss),
                                grads=to_numpy_tree(grads))
    return _REF[case, path]


def test_injected_sites_cover_plan():
    inj = _reference("case3", "masks")["inj"]
    assert set(inj) == {"inp", "fwd/layer0/rh", "bwd/layer0/rh"}
    feat = DIMS["word_embed"] + DIMS["char_filters"]
    assert inj["inp"].shape == (1, feat // 4 // 2)          # 24 units / bs 4
    assert inj["fwd/layer0/rh"].shape == (S, 2)             # 16 units / bs 4
    # the two directions draw from their own streams
    assert not np.array_equal(inj["fwd/layer0/rh"], inj["bwd/layer0/rh"])


@pytest.mark.parametrize("engine", ["stepwise", "scheduled", "fused"])
@pytest.mark.parametrize("path", ["masks", "lengths"])
@pytest.mark.parametrize("case", ["case1", "case3"])
def test_loss_and_grads_match_reference(case, path, engine):
    ref = _reference(case, path)
    cfg = _port_cfg(case, engine)
    lfn = value_and_grad(
        lambda p, b, **kw: t_adapters.loss_fn("tagger")(p, b, cfg, **kw))
    loss, grads = lfn(from_reference(ref["params"]), to_torch(ref["batch"]),
                      seed=0, step=STEP, injected=to_torch(ref["inj"]))
    np.testing.assert_allclose(float(loss), ref["loss"], **LOSS_TOL)
    got, want = to_reference(grads), ref["grads"]
    for name, g, w in zip(_paths(want), tree_leaves(got), tree_leaves(want)):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=f"{case}/{path}/{engine} d{name}",
                                   **GRAD_TOL)


def _rng_params(seed=0):
    params = r_tag.init_params(jax.random.PRNGKey(seed), _ref_cfg("case3"))
    return to_numpy_tree(params)


def test_char_cnn_matches_reference():
    """Values and gradients, with tied maxima: rows of period-2 chars repeat
    their conv windows, and ``amax`` must split a tie's gradient evenly as
    ``jnp.max`` does."""
    cfg = _ref_cfg("case3")
    params = _rng_params()
    rng = np.random.default_rng(5)
    chars = rng.integers(0, DIMS["char_vocab"], (B, S, 8)).astype(np.int32)
    chars[:2] = np.tile(chars[:2, :, :2], (1, 1, 4))       # a b a b ...
    w_out = rng.standard_normal((B, S, DIMS["char_filters"])).astype(np.float32)

    def r_obj(p):
        return (r_tag.char_cnn(p, jax.numpy.asarray(chars), cfg) * w_out).sum()
    r_val = np.asarray(r_tag.char_cnn(params, jax.numpy.asarray(chars), cfg))
    r_grad = to_numpy_tree(jax.grad(r_obj)(params))
    tp = {k: from_reference(params[k]) for k in ("char_embed", "char_conv")}
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    out = t_tag.char_cnn(tp, torch.from_numpy(chars), _port_cfg("case3", "fused"))
    np.testing.assert_allclose(out.detach().numpy(), r_val, **PART_TOL)
    (out * torch.from_numpy(w_out)).sum().backward()
    np.testing.assert_allclose(tp["char_embed"].grad.numpy(),
                               r_grad["char_embed"], **PART_TOL)
    np.testing.assert_allclose(tp["char_conv"]["w"].grad.numpy(),
                               r_grad["char_conv"]["w"], **PART_TOL)
    np.testing.assert_allclose(tp["char_conv"]["b"].grad.numpy(),
                               r_grad["char_conv"]["b"], **PART_TOL)


def test_crf_matches_reference():
    """crf_log_norm and crf_score: values and gradients (emissions and
    transitions), with some positions masked out."""
    rng = np.random.default_rng(6)
    T = DIMS["num_tags"]
    emit = rng.standard_normal((B, S, T)).astype(np.float32)
    trans = rng.standard_normal((T, T)).astype(np.float32)
    tags = rng.integers(0, T, (B, S)).astype(np.int32)
    mask = np.arange(S)[None, :] < np.asarray([S, 4, 1, 6])[:, None]

    def r_fn(e, tr):
        jm, jt = jax.numpy.asarray(mask), jax.numpy.asarray(tags)
        return r_tag.crf_log_norm(e, tr, jm), r_tag.crf_score(e, jt, tr, jm)
    (r_z, r_s), vjp = jax.vjp(r_fn, jax.numpy.asarray(emit),
                              jax.numpy.asarray(trans))
    cz = rng.standard_normal(B).astype(np.float32)
    cs = rng.standard_normal(B).astype(np.float32)
    r_de, r_dt = vjp((jax.numpy.asarray(cz), jax.numpy.asarray(cs)))
    te = torch.from_numpy(emit).requires_grad_(True)
    tt = torch.from_numpy(trans).requires_grad_(True)
    tm = torch.from_numpy(mask)
    z = t_tag.crf_log_norm(te, tt, tm)
    s = t_tag.crf_score(te, torch.from_numpy(tags), tt, tm)
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(r_z), **PART_TOL)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(r_s), **PART_TOL)
    ((z * torch.from_numpy(cz)).sum() + (s * torch.from_numpy(cs)).sum()).backward()
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(r_de), **PART_TOL)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(r_dt), **PART_TOL)


def test_reverse_valid_and_resolve_mask_match_reference():
    rng = np.random.default_rng(7)
    xs = rng.standard_normal((S, B, 3)).astype(np.float32)
    lengths = np.asarray(LENGTHS, np.int32)
    want = np.asarray(r_tag._reverse_valid(jax.numpy.asarray(xs),
                                           jax.numpy.asarray(lengths)))
    got = t_tag._reverse_valid(torch.from_numpy(xs), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), want)
    # an involution: pads stay in place
    back = t_tag._reverse_valid(got, torch.from_numpy(lengths))
    np.testing.assert_array_equal(back.numpy(), xs)
    words = np.zeros((B, S), np.int32)
    r_mask = r_metrics.resolve_mask({"lengths": jax.numpy.asarray(lengths)},
                                    jax.numpy.asarray(words))
    t_mask = t_metrics.resolve_mask({"lengths": torch.from_numpy(lengths)},
                                    torch.from_numpy(words))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(r_mask))
    assert t_metrics.resolve_mask({}, torch.from_numpy(words)) is None


@pytest.mark.parametrize("path", ["masks", "lengths", "ties"])
def test_viterbi_matches_reference(path):
    """Equal paths on converted params; "ties" zeroes the emission weights
    and sets integer biases and transitions, so that every step's maxima tie
    and the first maximal index must win on both sides."""
    cfg = _ref_cfg("case3")
    params = _rng_params(1)
    batch = _batch("masks" if path == "ties" else path)
    if path == "ties":
        rng = np.random.default_rng(8)
        T = DIMS["num_tags"]
        params["fc"]["w"] = np.zeros_like(params["fc"]["w"])
        params["fc"]["b"] = np.asarray([1, 3, 3, 0, 3], np.float32)
        params["crf"] = rng.integers(-1, 2, (T, T)).astype(np.float32)
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    want = np.asarray(r_tag.viterbi(params, jb, cfg))
    got = t_tag.viterbi(from_reference(params), to_torch(batch),
                        _port_cfg("case3", "fused"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_convert_tagger_tree():
    params = _reference("case3", "masks")["params"]
    port = from_reference(params)
    assert sorted(port) == sorted(params)
    for a, b in zip(tree_leaves(to_reference(port)), tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    own = t_tag.init_params(torch.Generator().manual_seed(0),
                            _port_cfg("case3", "fused"))
    assert [tuple(x.shape) for x in tree_leaves(own)] == \
        [x.shape for x in tree_leaves(params)]


def test_bilstm_ner_spec():
    spec = t_configs.get_arch("bilstm-ner")
    cfg = spec.full()
    assert (spec.kind, cfg.vocab, cfg.char_vocab, cfg.char_embed,
            cfg.char_filters, cfg.char_kernel, cfg.word_embed, cfg.hidden,
            cfg.num_tags, cfg.engine) == ("tagger", 20000, 100, 30, 30, 3, 100,
                                          200, 9, "scheduled")
    assert t_adapters.apply_engine(spec, cfg, "fused").engine == "fused"
    over = t_adapters.apply_dropout(spec, cfg, "case3:0.5:pallas")
    assert over.plan.spec("bwd/layer0/rh").impl == "pallas"
    assert not over.plan.spec("fwd/layer0/nr").active
    assert set(over.plan.active_sites()) == set(SITES)


def test_train_cli_runs_on_cpu():
    res = t_train.run(["--arch", "bilstm-ner", "--smoke", "--device", "cpu",
                       "--engine", "fused", "--steps", "2", "--batch", "4",
                       "--seq", "8"])
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    assert all(torch.isfinite(p).all() for p in tree_leaves(res["params"]))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}/{i}")]
    return [prefix]


def test_profile_groups_port_kernels_only():
    """``launch.profile`` names a kernel's group after it only when it is one
    of the port's csrc kernels: PyTorch's indexing backward (the tagger's
    table lookups) also sits in an anonymous namespace."""
    from repro_torch.launch import profile as t_profile
    assert {"lstm_fwd_kernel", "lstm_bwd_kernel", "gather_mm_kernel",
            "dec_fwd_tma", "flash_fwd_kernel"} <= t_profile.port_kernels()
    group = t_profile.kernel_group
    assert group("void (anonymous namespace)::lstm_bwd_kernel<true>(float "
                 "const*)") == "lstm_bwd_kernel"
    assert group("void (anonymous namespace)::indexing_backward_kernel_small_"
                 "stride<float>(long const*)") == "other"
    assert group("sm90_xmma_gemm_f32f32_f32f32") == "matrix products"
    assert group("nvjet_tst_320x128_64x3_1x2_h_bz_coopB_NNT") == "matrix products"
