"""The port's continuous-batching scheduler (``repro_torch.serving.scheduler``)
and ``launch/serve.py``, mirroring tests/test_scheduler.py.

Unit layer (no device work): request validation, FIFO admission, slot
reuse only after eviction, duplicate-rid rejection, the "batch" policy's
all-free gate, admitted == evicted accounting.

End-to-end layer (a tiny xlstm engine of the port's own init, on the CPU):
every request is served its full budget; under greedy decoding the same
request set under two arrival orders gives identical per-request outputs;
the continuous policy equals the "batch" policy token for token in fewer
chunks; EOS evicts early; more requests than slots reuse slots.

CLI: ``python -m repro_torch.launch.serve --smoke --device cpu``
rectangular and with ``--trace``, and luong-nmt's rectangular path, which
has no source sentence and raises a ``ValueError`` naming the encoder batch.

``cuda``-marked tests (no JAX here, so they run on a card machine with
``--noconftest -m cuda``) hold the engine's captured CUDA-graph loop to the
per-token host loop on the card and to the CPU, greedy, for xlstm, qwen3,
luong-nmt and whisper (prefilled over frames), and check that sampled
decoding in a graph is seeded; they skip without a card.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs import adapters
from repro_torch.launch import serve as serve_cli
from repro_torch.serving import DecodeEngine, Request, Scheduler, serve
from repro_torch.optim import tree_map
from repro_torch.serving.scheduler import POLICIES
from repro_torch.testing import require_cuda, serve_rectangular

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _req(rid, plen, max_new, vocab=64, seed=None):
    rng = np.random.default_rng(rid if seed is None else seed)
    return Request(rid=rid, prompt=rng.integers(3, vocab, plen),
                   max_new=max_new)


class TestRequestValidation:
    def test_empty_prompt_rejected(self):
        with pytest.raises(ValueError, match="empty prompt"):
            Request(rid=0, prompt=np.zeros((0,), np.int32), max_new=4)

    def test_zero_budget_rejected(self):
        with pytest.raises(ValueError, match="max_new"):
            Request(rid=0, prompt=np.array([5]), max_new=0)

    def test_prompt_coerced_int32_1d(self):
        r = Request(rid=0, prompt=[[1, 2, 3]], max_new=1)
        assert r.prompt.dtype == np.int32 and r.prompt.shape == (3,)


class TestSchedulerInvariants:
    def test_unknown_policy(self):
        with pytest.raises(ValueError, match="policy"):
            Scheduler(2, policy="round-robin")
        assert POLICIES == ("continuous", "batch")

    def test_duplicate_rid_rejected(self):
        s = Scheduler(2)
        s.submit(_req(7, 3, 2))
        with pytest.raises(ValueError, match="duplicate"):
            s.submit(_req(7, 4, 2))

    def test_fifo_admission_into_free_slots(self):
        s = Scheduler(2)
        for rid in range(4):
            s.submit(_req(rid, 3, 2))
        adm = s.admit()
        assert [(slot, r.rid) for slot, r in adm] == [(0, 0), (1, 1)]
        assert s.free_slots == [] and s.busy_slots == [0, 1]
        assert s.admit() == []
        assert [r.rid for r in s.queue] == [2, 3]

    def test_slot_reused_only_after_eviction(self):
        s = Scheduler(1)
        s.submit(_req(0, 3, 2))
        s.submit(_req(1, 3, 2))
        (slot, r0), = s.admit()
        assert s.admit() == []
        assert s.evict(slot) == r0.rid
        (slot2, r1), = s.admit()
        assert slot2 == slot and r1.rid == 1
        s.evict(slot2)
        with pytest.raises(ValueError, match="not busy"):
            s.evict(slot2)
        assert s.admitted == s.evicted == 2

    def test_batch_policy_waits_for_all_slots(self):
        s = Scheduler(2, policy="batch")
        for rid in range(3):
            s.submit(_req(rid, 3, 2))
        assert len(s.admit()) == 2
        s.evict(0)
        assert s.admit() == []
        s.evict(1)
        assert [r.rid for _, r in s.admit()] == [2]

    def test_has_work(self):
        s = Scheduler(1)
        assert not s.has_work
        s.submit(_req(0, 2, 1))
        assert s.has_work
        s.admit()
        assert s.has_work
        s.evict(0)
        assert not s.has_work


@pytest.fixture(scope="module")
def tiny_xlstm():
    spec = configs.get_arch("xlstm-1.3b")
    cfg = spec.smoke(num_layers=2, slstm_every=2, d_model=32, vocab=64,
                     n_heads=2)
    params = adapters.init_params(spec.kind, torch.Generator().manual_seed(0),
                                  cfg)
    params["mlstm"]["conv_w"].normal_(0.0, 0.5,
                                      generator=torch.Generator().manual_seed(4))
    return spec, cfg, params


def _engine(tiny_xlstm, **kw):
    spec, cfg, params = tiny_xlstm
    kw.setdefault("max_seq", 64)
    kw.setdefault("batch", 2)
    kw.setdefault("chunk", 4)
    return DecodeEngine(spec=spec, cfg=cfg, params=params, **kw)


# prompt lengths and budgets staggered so eviction happens mid-group
TRACE = [(0, 5, 4), (1, 3, 8), (2, 7, 4), (3, 2, 8), (4, 4, 4)]


def _trace_requests(order=None):
    items = TRACE if order is None else [TRACE[i] for i in order]
    return [_req(rid, plen, mnew) for rid, plen, mnew in items]


class TestServeEndToEnd:
    def test_all_requests_served_full_budget(self, tiny_xlstm):
        outs = serve(_engine(tiny_xlstm), _trace_requests())
        assert sorted(outs) == [t[0] for t in TRACE]
        for rid, _, max_new in TRACE:
            assert len(outs[rid]) == max_new, rid
            assert outs[rid].min() >= 0

    def test_deterministic_across_arrival_orders(self, tiny_xlstm):
        eng = _engine(tiny_xlstm)
        a = serve(eng, _trace_requests())
        b = serve(eng, _trace_requests(order=[4, 2, 0, 3, 1]))
        for rid in a:
            np.testing.assert_array_equal(a[rid], b[rid], err_msg=str(rid))

    def test_continuous_matches_batch_with_fewer_chunks(self, tiny_xlstm):
        eng = _engine(tiny_xlstm)
        cont = serve(eng, _trace_requests(), policy="continuous")
        cont_chunks = eng.chunks_run
        rect = serve(eng, _trace_requests(), policy="batch")
        for rid in cont:
            np.testing.assert_array_equal(cont[rid], rect[rid], err_msg=str(rid))
        assert cont_chunks < eng.chunks_run, (cont_chunks, eng.chunks_run)

    def test_eos_evicts_early(self, tiny_xlstm):
        free = serve(_engine(tiny_xlstm), _trace_requests())
        eos = int(free[0][1])           # a token greedy decoding does emit
        outs = serve(_engine(tiny_xlstm, eos_id=eos), _trace_requests())
        stopped = 0
        for rid, _, max_new in TRACE:
            o = outs[rid]
            assert len(o) <= max_new
            hits = np.nonzero(o == eos)[0]
            if hits.size:
                assert hits[0] == len(o) - 1, (rid, o)
                stopped += 1
            else:
                assert len(o) == max_new
        assert stopped >= 1

    def test_more_requests_than_slots_slot_reuse(self, tiny_xlstm):
        reqs = [_req(rid, 2 + rid % 3, 3) for rid in range(7)]
        outs = serve(_engine(tiny_xlstm, batch=2), reqs)
        assert len(outs) == 7
        assert all(len(v) == 3 for v in outs.values())


# ---------------------------------------------------------------------------
# launch/serve.py
# ---------------------------------------------------------------------------

SMALL = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "6",
         "--gen", "8", "--chunk", "4"]


def test_cli_rectangular_module_runs():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "xlstm-1.3b", *SMALL], capture_output=True, text=True, env=env,
        timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "device loop" in out.stdout and "sample continuation ids" in out.stdout


@pytest.mark.parametrize("arch", ["qwen3-8b", "luong-nmt"])
def test_cli_rectangular_loops_agree(arch, capsys):
    if arch == "luong-nmt":
        with pytest.raises(ValueError, match="encoder batch"):
            serve_cli.run(["--arch", arch, *SMALL])
        return
    dev = serve_cli.run(["--arch", arch, *SMALL])["tokens"]
    py = serve_cli.run(["--arch", arch, *SMALL, "--loop", "python"])["tokens"]
    assert dev.shape == (2, 8)
    np.testing.assert_array_equal(dev, py)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "luong-nmt"])
def test_cli_trace(arch, capsys):
    res = serve_cli.run(["--arch", arch, *SMALL, "--trace", "5"])
    assert sorted(res["tokens"]) == list(range(5))
    cfg = configs.get_arch(arch).smoke()
    vocab = cfg.tgt_vocab if arch == "luong-nmt" else cfg.vocab
    want = {r.rid: r.max_new for r in serve_cli.ragged_trace(5, vocab, 6, 8, 0)}
    assert {rid: len(v) for rid, v in res["tokens"].items()} == want
    assert "continuous trace: 5 requests" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# on the card: the captured graph loop
# ---------------------------------------------------------------------------


def _tiny(arch):
    spec = configs.get_arch(arch)
    kw = {"xlstm-1.3b": dict(num_layers=2, slstm_every=2, d_model=32,
                             vocab=64, n_heads=2),
          "qwen3-8b": dict(num_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                           d_ff=64, vocab=64, max_seq=64),
          "luong-nmt": {}}[arch]
    cfg = spec.smoke(**kw)
    return spec, cfg, adapters.init_params(
        spec.kind, torch.Generator().manual_seed(0), cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "qwen3-8b", "luong-nmt"])
def test_graph_loop_matches_host_loop_and_cpu(arch):
    dev = require_cuda()
    spec, cfg, params = _tiny(arch)
    vocab = cfg.tgt_vocab if spec.kind == "nmt" else cfg.vocab
    prompt = torch.randint(3, vocab, (2, 9), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(7))
    cpu = serve_rectangular(spec, cfg, params, prompt, "device", chunk=4)
    on_card = tree_map(lambda a: a.to(dev), params)
    graph = serve_rectangular(spec, cfg, on_card, prompt.to(dev), "device", chunk=4)
    host = serve_rectangular(spec, cfg, on_card, prompt.to(dev), "python")
    np.testing.assert_array_equal(graph, host)
    np.testing.assert_array_equal(graph, cpu)


@pytest.mark.cuda
def test_sampled_graph_loop_is_seeded():
    dev = require_cuda()
    spec, cfg, params = _tiny("xlstm-1.3b")
    params = tree_map(lambda a: a.to(dev), params)
    prompt = torch.randint(3, cfg.vocab, (2, 5), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(8)).to(dev)
    kw = dict(temperature=1.0, top_k=8, chunk=4)
    a = serve_rectangular(spec, cfg, params, prompt, "device", **kw)
    b = serve_rectangular(spec, cfg, params, prompt, "device", **kw)
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 0 and a.max() < cfg.vocab


@pytest.mark.cuda
def test_whisper_graph_loop_matches_host_loop_and_cpu():
    """whisper smoke, ``attn_impl="flash"``: ``DecodeEngine.prefill`` of a
    prompt over frames (the cross K/V written in place into the engine's
    buffers, which the captured graphs read), then greedy tokens of the
    graph loop equal to the host loop's and the CPU's."""
    dev = require_cuda()
    spec = configs.get_arch("whisper-base")
    cfg = spec.smoke(attn_impl="flash")
    params = adapters.init_params(spec.kind, torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(7)
    prompt = torch.randint(3, cfg.vocab, (2, 9), dtype=torch.int32, generator=g)
    frames = torch.randn(2, cfg.enc_seq, cfg.d_model, generator=g) * 0.02
    cpu = serve_rectangular(spec, cfg, params, prompt, "device", chunk=4, frames=frames)
    on_card = tree_map(lambda a: a.to(dev), params)
    kw = dict(chunk=4, frames=frames.to(dev))
    graph = serve_rectangular(spec, cfg, on_card, prompt.to(dev), "device", **kw)
    host = serve_rectangular(spec, cfg, on_card, prompt.to(dev), "python", **kw)
    np.testing.assert_array_equal(graph, host)
    np.testing.assert_array_equal(graph, cpu)
