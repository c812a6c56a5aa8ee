"""The port's serving stack (``repro_torch.serving``, the models' ``prefill``
/ ``decode_step`` and the serving half of ``configs/adapters.py``) against
the JAX reference, and the reference's own serving tests mirrored on the
port's engine.

Reference parity, for the qwen3 smoke config (``attn_impl`` "xla", and
"flash": the port's CPU route is K9's plain version, the reference runs its
Pallas kernel in interpret mode), the mixtral smoke config (MoE decode, the
port's ``moe_impl`` "xla" and "pallas" routes against the reference's one),
the xlstm smoke config (its mLSTM conv weights drawn at random, so the
matrix memory is not zero) and the luong-nmt smoke config. Both sides get
the reference's parameters converted leaf for leaf and the same numpy
prompts (batch 2, prompt 12: 11 tokens of prefill, past mixtral's window
of 8; NMT sources of 9 tokens):

  * ``prefill``: features (where the model returns them) and every state
    leaf;
  * ``decode_step`` from the reference's prefilled state: logits and every
    state leaf;
  * the engine's greedy tokens (8 of them, the reference's ``DecodeEngine``
    without a mesh): token for token.

Tolerances (float32, the same arithmetic in another order): each float
leaf within rtol 1e-4 plus atol 1e-4 x its largest magnitude, as
tests/test_torch_xlstm.py holds gradients (the rounding follows each
leaf's scale; luong-nmt's leaves are of order 1e-2 to 1e-4). Against a
float64 run of the port, the xlstm prefill of the reference is within
6.3e-5 of each leaf's largest entry and the port's within 9.1e-6. Entries
at the -1e30 "nothing seen" floor (score_bias, the stabilizers m) exactly;
tokens exactly.

The mirrored engine tests run the port alone on tiny configs of its own
init: ``sample_logits`` properties; a ragged replay equals a dedicated
replay of each row; native and replay prefill continue identically; the
chunked loop equals the per-token host loop (greedy); a budget under the
chunk pads -1; ``admit`` equals rectangular ``generate``; the transformer's
ragged and active-batch admits raise.
(tests/test_torch_scheduler.py holds the captured graph loop to the eager
loops on the card.)
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as r_configs  # noqa: E402
from repro.configs import adapters as r_adapters  # noqa: E402
from repro.distributed.sharding import strip  # noqa: E402
from repro.serving import DecodeEngine as RDecodeEngine  # noqa: E402
from repro.serving import prompt_prefill as r_prompt_prefill  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import adapters  # noqa: E402
from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.serving import (DecodeEngine, Request, prompt_prefill,  # noqa: E402
                                 replay_prefill, sample_logits, serve)
from repro_torch.testing import serve_rectangular, to_numpy_tree  # noqa: E402

torch.set_num_threads(1)

B, L, GEN, MAX_SEQ, SRC = 2, 12, 8, 32, 9
# name: (arch, config overrides on both sides, port-only overrides)
FAMILIES = {
    "qwen3_xla": ("qwen3-8b", dict(attn_impl="xla"), {}),
    "qwen3_flash": ("qwen3-8b", dict(attn_impl="flash"), {}),
    "mixtral_xla": ("mixtral-8x22b", {}, dict(moe_impl="xla")),
    "mixtral_pallas": ("mixtral-8x22b", {}, dict(moe_impl="pallas")),
    "xlstm": ("xlstm-1.3b", {}, {}),
    "nmt": ("luong-nmt", {}, {}),
}
RTOL, ATOL_REL = 1e-4, 1e-4


def assert_leaf(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    floor = np.abs(want) >= 1e29
    np.testing.assert_array_equal(got[floor], want[floor], err_msg=what)
    g, w = got[~floor], want[~floor]
    if w.size:
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=ATOL_REL * np.abs(w).max(),
                                   err_msg=what)


def _inputs(kind, cfg):
    rng = np.random.default_rng(5)
    vocab = cfg.tgt_vocab if kind == "nmt" else cfg.vocab
    prompt = rng.integers(3, vocab, (B, L)).astype(np.int32)
    if kind == "nmt":
        return prompt, {"src": rng.integers(3, cfg.src_vocab, (B, SRC)).astype(np.int32),
                        "tgt_in": prompt[:, :-1]}
    return prompt, {"tokens": prompt[:, :-1]}


_REFS = {}


def _reference(name):
    """The reference's parameters, inputs, prefill, one decode step and
    greedy engine tokens (computed once per family; the two mixtral routes
    share theirs)."""
    arch, kw, _ = FAMILIES[name]
    key = (arch, tuple(sorted(kw.items())))
    if key not in _REFS:
        spec = r_configs.get_arch(arch)
        cfg = spec.smoke(**kw)
        params = to_numpy_tree(strip(r_adapters.init_params(
            spec.kind, jax.random.PRNGKey(0), cfg)))
        if spec.kind == "xlstm":     # the reference's init zeroes the conv
            rng = np.random.default_rng(9)
            m = params["mlstm"]
            m["conv_w"] = (rng.standard_normal(m["conv_w"].shape) * 0.5).astype(np.float32)
            m["conv_b"] = (rng.standard_normal(m["conv_b"].shape) * 0.1).astype(np.float32)
        prompt, batch = _inputs(spec.kind, cfg)
        jp = jax.tree.map(jnp.asarray, params)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        feats, state = r_adapters.prefill_fn(spec)(
            jp, jb, cfg, r_adapters.init_decode_state(spec, cfg, B, MAX_SEQ))
        logits, state2 = r_adapters.decode_fn(spec)(
            jp, cfg, state, jnp.asarray(prompt[:, -1:]), L - 1)
        eng = RDecodeEngine(spec=spec, cfg=cfg, params=jp, max_seq=MAX_SEQ,
                            batch=B)
        if spec.kind == "nmt":
            eng.prefill(jb)
            tok0, pos0 = jnp.asarray(prompt[:, -1:]), L - 1
        else:
            eng.state, tok0, pos0 = r_prompt_prefill(
                spec, cfg, jp, jnp.asarray(prompt), state=eng.state)
        tokens = eng.generate(tok0, GEN, start_pos=pos0)
        _REFS[key] = dict(
            params=params, prompt=prompt, batch=batch,
            feats=None if feats is None else np.asarray(feats),
            state=to_numpy_tree(state), logits=np.asarray(logits),
            state2=to_numpy_tree(state2), tokens=np.asarray(tokens))
    return _REFS[key]


def _port(name):
    arch, kw, port_kw = FAMILIES[name]
    spec = configs.get_arch(arch)
    return spec, spec.smoke(**kw, **port_kw)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_prefill_matches_reference(name):
    ref = _reference(name)
    spec, cfg = _port(name)
    state = adapters.init_decode_state(spec, cfg, B, MAX_SEQ)
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    with torch.no_grad():
        feats, state = adapters.prefill_fn(spec)(from_reference(ref["params"]),
                                                 batch, cfg, state)
    if ref["feats"] is not None:
        assert_leaf(feats.numpy(), ref["feats"], f"{name} features")
    assert set(state) == set(ref["state"])
    for k, v in ref["state"].items():
        assert_leaf(state[k].numpy(), v, f"{name} state {k}")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_decode_step_matches_reference(name):
    ref = _reference(name)
    spec, cfg = _port(name)
    state = from_reference(ref["state"])
    with torch.no_grad():
        logits, state = adapters.decode_fn(spec)(
            from_reference(ref["params"]), cfg, state,
            torch.from_numpy(ref["prompt"][:, -1:]), L - 1)
    assert logits.dtype == torch.float32 and logits.shape[:2] == (B, 1)
    assert_leaf(logits.numpy(), ref["logits"], f"{name} logits")
    for k, v in ref["state2"].items():
        assert_leaf(state[k].numpy(), v, f"{name} state {k}")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_engine_greedy_tokens_match_reference(name):
    ref = _reference(name)
    spec, cfg = _port(name)
    params = from_reference(ref["params"])
    eng = DecodeEngine(spec=spec, cfg=cfg, params=params, max_seq=MAX_SEQ,
                       batch=B, chunk=3)
    prompt = torch.from_numpy(ref["prompt"])
    if spec.kind == "nmt":
        eng.prefill({k: torch.from_numpy(v) for k, v in ref["batch"].items()})
        tok0, pos0 = prompt[:, -1:], L - 1
    else:
        eng.state, tok0, pos0 = prompt_prefill(spec, cfg, params, prompt,
                                               state=eng.state)
    np.testing.assert_array_equal(eng.generate(tok0, GEN, start_pos=pos0),
                                  ref["tokens"])


def test_nmt_token_prompt_prefill_raises():
    """A token prompt has no source sentence: the native prefill names the
    encoder batch instead of failing on a missing key."""
    spec = configs.get_arch("luong-nmt")
    cfg = spec.smoke()
    params = adapters.init_params(spec.kind, torch.Generator().manual_seed(0), cfg)
    state = adapters.init_decode_state(spec, cfg, 2, 16)
    with pytest.raises(ValueError, match="encoder batch"):
        prompt_prefill(spec, cfg, params, torch.ones((2, 5), dtype=torch.int32),
                       state=state)


def test_ssm_serving_not_ported():
    from repro_torch.configs.base import ArchSpec
    spec = ArchSpec(name="ssm", family="ssm", kind="ssm", full=None, smoke=None)
    for call in (lambda: adapters.init_decode_state(spec, None, 1, 8),
                 lambda: adapters.decode_fn(spec),
                 lambda: adapters.prefill_fn(spec),
                 lambda: adapters.has_native_prefill(spec)):
        with pytest.raises(NotImplementedError, match="ROADMAP A11"):
            call()


# ---------------------------------------------------------------------------
# the reference's serving tests, mirrored on the port's engine
# ---------------------------------------------------------------------------


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


class TestSampleLogits:
    def test_greedy_is_argmax(self):
        lg = torch.randn((3, 1, 16), generator=_gen())
        out = sample_logits(lg, temperature=0.0)
        assert out.shape == (3, 1) and out.dtype == torch.int32
        np.testing.assert_array_equal(out[:, 0], lg[:, 0].argmax(-1))

    def test_topk_restricts_support(self):
        lg = torch.randn((2, 1, 32), generator=_gen())
        top = [set(r.tolist()) for r in torch.topk(lg[:, 0], 4).indices]
        g = _gen(1)
        for _ in range(32):
            tok = sample_logits(lg, temperature=1.0, top_k=4, generator=g)
            for b in range(2):
                assert int(tok[b, 0]) in top[b]

    def test_topk_mask_below_minus_1e30(self):
        # every real logit below -1e30: a hard-coded -1e30 mask would raise
        # the rejected entries above the kept ones; finfo.min keeps the true
        # top-2 as the only support
        lg = (-1e32 * torch.arange(1, 9, dtype=torch.float32))[None, None]
        g = _gen(2)
        for _ in range(32):
            tok = sample_logits(lg, temperature=1.0, top_k=2, generator=g)
            assert int(tok[0, 0]) in (0, 1)

    def test_all_extreme_edge_stays_valid(self):
        lg = torch.full((1, 1, 8), torch.finfo(torch.float32).min)
        tok = sample_logits(lg, temperature=1.0, top_k=3, generator=_gen())
        assert 0 <= int(tok[0, 0]) < 8

    def test_temperature_scales_entropy(self):
        lg = torch.tensor([[[0.0, 1.0, 0.0, 0.0]]])
        g = _gen(3)
        cold = {int(sample_logits(lg, temperature=0.05, generator=g)[0, 0])
                for _ in range(16)}
        hot = {int(sample_logits(lg, temperature=5.0, generator=g)[0, 0])
               for _ in range(64)}
        assert cold == {1} and len(hot) > 1


@pytest.fixture(scope="module")
def tiny_xlstm():
    spec = configs.get_arch("xlstm-1.3b")
    cfg = spec.smoke(num_layers=2, slstm_every=2, d_model=32, vocab=64,
                     n_heads=2)
    params = adapters.init_params(spec.kind, _gen(0), cfg)
    params["mlstm"]["conv_w"].normal_(0.0, 0.5, generator=_gen(4))
    return spec, cfg, params


@pytest.fixture(scope="module")
def tiny_qwen3():
    spec = configs.get_arch("qwen3-8b")
    cfg = spec.smoke(num_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                     d_ff=64, vocab=64, max_seq=64)
    return spec, cfg, adapters.init_params(spec.kind, _gen(1), cfg)


@pytest.fixture(scope="module")
def tiny_nmt():
    spec = configs.get_arch("luong-nmt")
    cfg = spec.smoke()
    return spec, cfg, adapters.init_params(spec.kind, _gen(2), cfg)


def _prompt(shape, vocab, seed):
    return torch.randint(3, vocab, shape, generator=_gen(seed), dtype=torch.int32)


class TestReplayPrefill:
    def test_ragged_equals_dedicated_replay(self, tiny_xlstm):
        spec, cfg, params = tiny_xlstm
        toks = _prompt((3, 6), cfg.vocab, 5)
        lens = [6, 4, 1]
        batched = replay_prefill(spec, cfg, params,
                                 adapters.init_decode_state(spec, cfg, 3, 32),
                                 toks, torch.tensor(lens))
        for b, lb in enumerate(lens):
            one = replay_prefill(spec, cfg, params,
                                 adapters.init_decode_state(spec, cfg, 1, 32),
                                 toks[b:b + 1, :lb])
            for k in batched:
                torch.testing.assert_close(batched[k][:, b], one[k][:, 0],
                                           rtol=1e-5, atol=1e-5,
                                           msg=f"row {b} leaf {k}")

    def test_zero_length_replay_is_identity(self, tiny_xlstm):
        spec, cfg, params = tiny_xlstm
        st0 = adapters.init_decode_state(spec, cfg, 2, 16)
        before = {k: v.clone() for k, v in st0.items()}
        st1 = replay_prefill(spec, cfg, params, st0,
                             torch.zeros((2, 0), dtype=torch.int32))
        for k in before:
            torch.testing.assert_close(st1[k], before[k], rtol=0, atol=0)

    @pytest.mark.parametrize("fix", ["tiny_xlstm", "tiny_qwen3"])
    def test_native_and_replay_methods_agree(self, fix, request):
        spec, cfg, params = request.getfixturevalue(fix)
        prompt = _prompt((2, 7), cfg.vocab, 6)
        outs = {}
        for method in ("native", "replay"):
            eng = DecodeEngine(spec=spec, cfg=cfg, params=params, max_seq=32,
                               batch=2)
            eng.state, tok0, pos0 = prompt_prefill(
                spec, cfg, params, prompt, state=eng.state, method=method)
            assert pos0 == 6
            outs[method] = eng.generate(tok0, 6, start_pos=pos0)
        np.testing.assert_array_equal(outs["native"], outs["replay"])


class TestDeviceLoop:
    @pytest.mark.parametrize("fix", ["tiny_xlstm", "tiny_qwen3", "tiny_nmt"])
    def test_matches_per_token_host_loop_greedy(self, fix, request):
        spec, cfg, params = request.getfixturevalue(fix)
        vocab = getattr(cfg, "vocab", None) or cfg.tgt_vocab
        prompt = _prompt((2, 9), vocab, 7)
        np.testing.assert_array_equal(
            serve_rectangular(spec, cfg, params, prompt, "device", chunk=4),
            serve_rectangular(spec, cfg, params, prompt, "python"))

    def test_sampled_is_seeded_and_in_vocab(self, tiny_xlstm):
        spec, cfg, params = tiny_xlstm
        prompt = _prompt((2, 5), cfg.vocab, 8)
        kw = dict(temperature=1.0, top_k=8, chunk=4)
        a = serve_rectangular(spec, cfg, params, prompt, "device", **kw)
        b = serve_rectangular(spec, cfg, params, prompt, "device", **kw)
        np.testing.assert_array_equal(a, b)
        assert a.min() >= 0 and a.max() < cfg.vocab

    def test_budget_early_exit_pads_minus_one(self, tiny_xlstm):
        spec, cfg, params = tiny_xlstm
        eng = DecodeEngine(spec=spec, cfg=cfg, params=params, max_seq=32,
                           batch=2, chunk=8)
        eng.admit([0, 1], [np.array([5, 6, 7], np.int32),
                           np.array([9], np.int32)], [2, 5])
        toks, n_gen, active = eng.decode_chunk()
        np.testing.assert_array_equal(n_gen, [2, 5])
        assert not active.any()
        assert (toks[0, :2] >= 0).all() and (toks[0, 2:] == -1).all()
        assert (toks[1, :5] >= 0).all() and (toks[1, 5:] == -1).all()

    def test_admit_matches_rectangular_generate(self, tiny_xlstm):
        spec, cfg, params = tiny_xlstm
        prompt = _prompt((1, 6), cfg.vocab, 9)
        eng = DecodeEngine(spec=spec, cfg=cfg, params=params, max_seq=32,
                           batch=1, chunk=8)
        eng.state, tok0, pos0 = prompt_prefill(spec, cfg, params, prompt,
                                               state=eng.state)
        rect = eng.generate(tok0, 8, start_pos=pos0)
        eng.reset()
        eng.admit([0], [prompt[0].numpy()], [8])
        toks, n_gen, _ = eng.decode_chunk(8)
        np.testing.assert_array_equal(toks, rect)
        np.testing.assert_array_equal(n_gen, [8])


class TestTransformerRectangularGuard:
    def test_ragged_admit_raises(self, tiny_qwen3):
        spec, cfg, params = tiny_qwen3
        eng = DecodeEngine(spec=spec, cfg=cfg, params=params, max_seq=32, batch=2)
        with pytest.raises(NotImplementedError, match="rectangular"):
            eng.admit([0, 1], [np.array([5, 6], np.int32),
                               np.array([5], np.int32)], [4, 4])

    def test_admit_into_active_batch_raises(self, tiny_qwen3):
        spec, cfg, params = tiny_qwen3
        eng = DecodeEngine(spec=spec, cfg=cfg, params=params, max_seq=32, batch=2)
        eng.admit([0], [np.array([5, 6], np.int32)], [16])
        eng.decode_chunk(2)             # slot 0 still active
        with pytest.raises(NotImplementedError, match="rectangular"):
            eng.admit([1], [np.array([5, 6], np.int32)], [4])

    def test_uniform_group_admit_works(self, tiny_qwen3):
        spec, cfg, params = tiny_qwen3
        eng = DecodeEngine(spec=spec, cfg=cfg, params=params, max_seq=32, batch=2)
        outs = serve(eng, [Request(rid=0, prompt=np.array([5, 6, 7]), max_new=4),
                           Request(rid=1, prompt=np.array([8, 9, 10]), max_new=4)],
                     policy="batch")
        assert len(outs) == 2 and all(len(v) == 4 for v in outs.values())
