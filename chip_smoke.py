"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
source, in parallel) and holds each kernel of the ported paths against its
plain PyTorch version at that path's full shapes, and times it:

  * zaremba-medium (T=35, B=20, H=D=650, block size 1, p=0.5): K1/K2
    gather matmul, K3/K4 LSTM scan (also in dense, FIXED and ragged modes
    and at H=1500, zaremba-large);
  * luong-nmt (T=S=50, B=64, H=E=512, 2 layers, block size 1, p=0.3):
    K1/K2 and K3/K4 at the encoder's and decoder's shapes, and K7/K8, the
    fused decoder scan (also in dense, FIXED, off, mixed and ragged modes on
    small inputs); at the main-path shapes K3, K4, K7 and K8 are also
    launched a second time for the same bits and held to a float64 run of
    their plain versions within 10 x the float32 plain version's distance + 1e-6 x
    max(1, |ref|), and their rows carry a latency floor (T x the cheapest
    per-step exchange on the kernel's grid, ``launch/scan_bench.py``'s
    probes); K3 and K7 alike, against a float64 run of their plain
    forward, their floors from the forward probes (K7: T x four exchanges);
  * bilstm-ner (T=64, B=32, H=200, block size 1, p=0.5: one direction of
    the tagger's BiLSTM): K3/K4 on a grid of 13 clusters of 8, held to
    their plain versions, to a float64 run of them, to their own bits on a
    second launch, with their latency floors, and again with ragged rows
    (lengths in 1..64); K1 FP/BP at the scheduled engine's in-scan product
    (M=32, 100 of 200 units kept, N=800);
  * xlstm-1.3b (T=2048, B=2, 4 heads of dh=512, RH block 64, p=0.25, fresh
    start): K6, the fused sLSTM scan, whose backward computes dR after the
    scan with its WG kernel (``slstm_wg``, split-precision TF32 on the
    tensor cores, also timed alone with ``torch.bmm`` on masked operands as
    its yardstick, held to a float64 product over head 0 x 256 columns
    within 1e-5 x max(1, |ref|) with ``torch.bmm``'s distance printed
    beside it, and its SASS must hold TF32 HMMA); both directions are
    also held to a float64 run of the plain versions within 10 x the float32
    plain version's distance + 1e-6 x max(1, |ref|), and every K6 check
    launches each direction twice for the same bits (also in dense, FIXED,
    off, ragged and mid-stream handoff modes on small inputs, 3 heads of
    16, and with one head of 2048, whose R columns do not fit in shared
    memory); then K6 at the reference's dtype contract, bfloat16 xg and R
    with float32 states, at the same shape in the structured, dense,
    FIXED, ragged and handoff modes (and two small ones): each output in
    its dtype, each direction and WG within 10 x the bfloat16 plain
    version's distance to float64 + 1e-6, twice for the same bits, the
    main mode timed (rows ``slstm_*/bf16``);
  * qwen3-8b (B=1, S=4096, 32 query heads over 16 kv heads after
    kv_repeat, head_dim 128, causal): K9 flash forward, K10 dq, K11 dk/dv,
    with ``scaled_dot_product_attention`` timed beside them as the library
    yardstick; all three run on the TF32 tensor cores in split precision
    (3xTF32), so they are also held to a float64 forward (K9) and backward
    (K10, K11) over one (batch, kv head) group within 1e-5 x max(1, |ref|)
    (SDPA's distances printed beside theirs), launched twice for the same
    bits, and the SASS of every float32 instantiation must hold TF32 HMMA
    instructions (also
    non-causal, windowed, MQA, G=4, G=3 (mixtral's group),
    ragged, Sq != Sk, head_dim 16 / 64 / 256 and bfloat16 modes on small
    inputs; and K9-K11 with bfloat16 inputs at that shape, beside SDPA in
    bfloat16, rows ``flash_*/bf16``: bfloat16 K9, K10 and K11 at head_dim
    64, 128 and 256 take the wgmma route, ``csrc/flash_attention_sm90.cu``,
    whose SASS must hold HGMMA instructions, timed in turns with the tf32
    route on the same inputs, ``tf32_route_ms``; the launches of the main
    paths are counted by route and each bfloat16 pass must take its
    route);
  * mixtral-8x22b (the expert products over the (8 experts x 1280 slots)
    capacity buffer: x (10240, 6144) by w (8, 6144, 16384), and x (10240,
    16384) by w (8, 16384, 6144)): K12 grouped matmul, split-precision
    TF32 ("3xTF32") on the tensor cores, with ``torch.bmm`` on the (E, C,
    .) buffer timed as the library yardstick; both are held to a float64
    product over one row block by 256 columns, K12 within 1e-5 x max(1,
    |ref|) (float32's accuracy, which single-pass TF32 misses), and the
    float32 instantiation's SASS must hold TF32 HMMA instructions; the same
    in bfloat16, rows ``grouped_matmul*/bf16``, on the wgmma route
    (``csrc/grouped_matmul_sm90.cu``, HGMMA in its SASS, timed in turns with
    the tf32 route on the same inputs, ``tf32_route_ms``; every bfloat16 K12
    of the mixtral paths must take it) (also
    the reference test's four shapes in float32 and bfloat16, bm not a
    multiple of the tile, an empty expert, unsorted repeated ids and
    ragged T, D, F);
  * zaremba-medium's cell update (B=20, H=650, and H=1500): K5 fused LSTM
    pointwise, with forget_bias 0 and 1 and odd shapes;
  * gemma-2b (B=1, S=4096, 8 query heads over its one kv head repeated 8
    times, head_dim 256, causal: bfloat16 K9-K11 on the wgmma route, K10
    also timed in turns with the tf32 route; the small d 256 modes also for
    the same bits and against float64 over every group) and
    whisper-base (8 heads of 64 on the wgmma route: the encoder non-causal
    at B=32 over its 1500 frames, the decoder causal over 448 tokens):
    bfloat16 K9-K11 held to their plain versions, to float64 over every
    group, to their own bits, and timed beside SDPA (rows
    ``flash_*@gemma-2b/bf16``, ``@whisper-enc``, ``@whisper-dec``), after
    small modes at d 64 non-causal over S 100 and 1500 and causal over 448.

Then it checks on small inputs that the kernel engines agree with the plain
stepwise oracle (the four recurrent models; bilstm-ner on a masked and a
ragged batch), that Viterbi decodes the same emissions to the same paths
on the card and on the CPU (ties included), that the qwen3 smoke config
with ``attn_impl="flash"`` agrees with ``attn_impl="xla"`` and the mixtral
smoke config with ``moe_impl="pallas"`` with ``"xla"``, and the bfloat16
steps of the xlstm, qwen3 and mixtral smoke configs with a float64 run
(``check_bf16_small``); runs the
``lstm_stack`` forward at zaremba-medium width (T=35, B=20, H=D=650, 2
layers, ``case3:0.5:pallas``) under ``torch.no_grad()`` with the scheduled
and stepwise engines, ``pointwise_impl="pallas"`` (K5) against ``"xla"``;
and drives each main path — the
training step of ``repro_torch.launch.train`` at full width, zaremba-medium
under ``case3:0.5:pallas``, luong-nmt (batch 64, max_len 50) under
``case3:0.3:pallas`` and bilstm-ner (Ma & Hovy's widths, batch 32, 64
words of 12 chars) under ``case3:0.5:pallas`` (its launches a step
asserted: K3/K4 2 + 2 fused, K1 128 + 128 scheduled, nothing else; the
CRF's loss and backward timed beside the step), and
``launch.steps.make_train_step`` on the three configs in their
bfloat16: xlstm-1.3b cut to 16 of 48 blocks (batch 2 x 2048, its own plan
with ``impl="pallas"``) with the fused engine, qwen3-8b cut to 19 of 36 layers
(batch 1 x 4096, its own plan) with ``attn_impl="flash"`` and then
``"xla"``, and mixtral-8x22b cut to 1 of 56 layers (batch 1 x 4096, its
own plan, flash attention) with ``moe_impl="pallas"`` and then ``"xla"``
— the deepest cuts whose measured peak leaves 8 GB of the card free,
asserted — each followed by one step traced for its device-time split,
asserting that every kernel's launch counter grew in that path's run (K6
once a sLSTM block and step, and neither K9-K11 under xla nor K12 under
the mixtral xla route). Last, it resumes
bilstm-ner fused from a checkpoint (2 steps, save, restore into fresh
tensors, 2 more) and requires the losses and final parameters of 4
straight steps, bit for bit.

Then the reference's remaining transformer configs (``drive_configs``),
each at full width in its bfloat16 with flash attention, 5 steps and one
traced step, asserting the K9-K11 launches the code implies on the route of
its head_dim and 8 GB of the card free: gemma-2b whole (18 of 18 layers,
batch 1 x 4096; K9 36, K10 and K11 18 a step, all on wgmma) with remat
"full" and again with "dots", whisper-base whole (6 + 6 layers, batch 32,
1500 frames, 448 tokens; K9 18, K10 6, K11 6 a step on wgmma: the encoder's
forward once a layer and no encoder backward, since, as in the reference,
the loss does not read the encoder), and minitron-8b, qwen1.5-32b and
pixtral-12b (random embeddings) cut to ``CUT_LAYERS`` at batch 1 x 4096.

Then the serving phase (``drive_serving``, under ``torch.inference_mode()``,
random weights from a CUDA generator seeded 0), every model whole but
xlstm-1.3b:
qwen3-8b (36 of 36 layers, bfloat16, ``attn_impl="flash"``) prefills batch 8
x 511 tokens natively (K9 36 times a prefill and no other kernel,
asserted), then generates 64 tokens by the engine's captured-CUDA-graph
loop (chunks of 16; twice, the first run capturing) and by the per-token
python loop, token for token equal, and the first decode logits after a
native and a replay prefill of 63 tokens agree within ``BF16_TOL``;
xlstm-1.3b (cut to 16 of 48 blocks, bfloat16) serves a trace of 32 ragged
requests over 8 slots through ``serve()`` twice (the same tokens; admission and decode
time apart), then rectangular at batch 8 (graph loop = python loop);
luong-nmt prefills 64 sentences of 50 source tokens and an 8-token target
prefix through ``DecodeEngine.prefill`` and generates 50 tokens (graph loop
= python loop); gemma-2b (18 layers) serves as qwen3-8b does (K9 18 times a
prefill, wgmma route); whisper-base prefills 8 x 3 tokens over 8 x 1500
frames through ``DecodeEngine.prefill`` (K9 12 times: 6 encoder, 6 decoder
layers) and generates 64 tokens (graph loop = python loop). Each model's graph loop runs once more under
``torch.profiler`` (device-busy ms a token). At smoke width, for the three
families and whisper, the card's greedy tokens equal the CPU's and a small trace gives
the same outputs in two arrival orders, on the card and on the CPU. K9 is
also held to its plain version and a float64 forward and timed at the
prefill's shape (B=8, S=511; row ``flash_fwd@prefill``, its launches the
serving phase's).

K1/K2 rows and the bfloat16 flash rows carry the kernel's and the library
call's device time from ``torch.profiler`` (``device_ms``,
``library_device_ms``) beside their CUDA-event times, K1/K2 also the
wrapper's launch plan; the cluster-split K1 BP
is launched twice at the zaremba-medium shape and must give the same bits.

Prints the card's name and power limit, one JSON line of per-kernel
numbers, and as its last line ``{"ok": true, "device": {...}}``. Exits non-zero
(and prints no result) without a CUDA device, outside the repository, or on
any failed phase. Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

# Peaks of one H100 SXM (NVIDIA data sheet, 700 W), used only for the
# bound_ms column: float32 outside the tensor cores, HBM3 bandwidth, dense
# TF32 on the tensor cores (K12's route) and dense bfloat16 (the rows of
# bfloat16 inputs).
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12

T, B, H, D, P = 35, 20, 650, 650, 0.5          # zaremba-medium
NT_, NB, NH, NS, NP = 50, 64, 512, 50, 0.3      # luong-nmt: T=S, B, H=E, p
XT, XB, XNH, XDH, XBS, XP = 2048, 2, 4, 512, 64, 0.25   # xlstm-1.3b sLSTM
# depth cut from 48 to 16 (two sLSTM blocks) to keep the script's time
X_LAYERS = 16
XS_LAYERS = 8      # the scheduled engine's cut: one sLSTM block (host-bound)
QB, QS, QHQ, QHKV, QD = 1, 4096, 32, 16, 128   # qwen3-8b attention (kv_repeat 2)
Q_LAYERS = 19                                   # depth cut from 36
MB, MS, MD, MF, ME, MK = 1, 4096, 6144, 16384, 8, 2   # mixtral-8x22b
MC = math.ceil(MB * MS * MK / ME * 1.25)              # capacity: 1280 slots
M_LAYERS = 1                                          # depth cut from 56
STEPS = 5
# the training drives' depth cut: the deepest whose measured peak leaves at
# least this much of the card's memory free
FREE_BYTES = 8 * 10**9
BF16_TOL = 3e-2       # the bfloat16 gate (the reference's bfloat16 tolerance)
LM, NMT, XLSTM, QWEN = "zaremba-medium", "luong-nmt", "xlstm-1.3b", "qwen3-8b"
NER = "bilstm-ner"
ES, EB, EH, EP = 64, 32, 200, 0.5                # bilstm-ner: seq, batch, H, p
MIXTRAL, STACK = "mixtral-8x22b", "lstm_stack"
# the reference's remaining transformer configs, at full width in their
# bfloat16 with flash attention: gemma-2b and whisper-base whole, the others
# cut to the deepest depth whose measured peak leaves FREE_BYTES free
GEMMA, WHISPER = "gemma-2b", "whisper-base"
MINITRON, QWEN15, PIXTRAL = "minitron-8b", "qwen1.5-32b", "pixtral-12b"
WB, WT, WS = 32, 1500, 448     # whisper-base: batch, frames (enc_seq), tokens
CUT_LAYERS = {MINITRON: 16, QWEN15: 6, PIXTRAL: 15}
FULL_LAYERS = {GEMMA: 18, WHISPER: 6, MINITRON: 32, QWEN15: 64, PIXTRAL: 40}
# (d_model, query heads, kv heads after kv_repeat, head_dim, d_ff, vocab)
WIDTHS = {GEMMA: (2048, 8, 8, 256, 16384, 256000),
          WHISPER: (512, 8, 8, 64, 2048, 51865),
          MINITRON: (4096, 32, 16, 128, 16384, 256000),
          QWEN15: (5120, 40, 40, 128, 27392, 152064),
          PIXTRAL: (5120, 32, 16, 128, 14336, 131072)}


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


# Written before each timed run of a cold-cache timing: twice the H100's
# 50 MB L2, so nothing of the previous run stays there.
_FLUSH_BYTES = 128 << 20
_flush_buf = None


def time_ms(fn, reps: int = 20, warmup: int = 3, cold_l2: bool = False) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs. With ``cold_l2``
    a 128 MiB buffer is written (outside the timed span) before each run,
    so ``fn`` finds its operands in HBM, not in L2."""
    global _flush_buf
    if cold_l2 and _flush_buf is None:
        _flush_buf = torch.empty(_FLUSH_BYTES // 4, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if cold_l2:
            _flush_buf.fill_(1.0)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, reps: int = 20, warmup: int = 3, cold_l2: bool = False):
    """Mean device time of the kernels one call of ``fn`` launches, from
    ``torch.profiler`` over ``reps`` calls (with ``cold_l2`` each after the
    same flush as ``time_ms``, whose own kernels are left out), and None,
    or where the time is an estimate, each kernel's recorded launches, or
    where the profiler recorded no kernel in five runs, the string
    "cuda events" beside ``time_ms``'s time, which includes the host's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def kernels(prof):
        return {e.key: (getattr(e, "self_device_time_total", 0.0), e.count)
                for e in prof.key_averages()
                if getattr(e, "device_type", None) == DeviceType.CUDA}

    global _flush_buf
    if cold_l2 and _flush_buf is None:
        _flush_buf = torch.empty(_FLUSH_BYTES // 4, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    flush = set()
    if cold_l2:
        with profile(activities=acts) as prof:
            _flush_buf.fill_(1.0)
            torch.cuda.synchronize()
        flush = set(kernels(prof))
    # the profiler has been seen to drop kernel records on the card, some of
    # a run's or all of them: a run whose kernel counts are not a multiple of
    # reps is taken again; after five such runs the last one that recorded
    # any kernel gives each kernel's mean recorded duration times its
    # launches a call (its count over reps, rounded), and where none did,
    # the CUDA-event time stands in
    seen = []
    for _ in range(5):
        with profile(activities=acts) as prof:
            for _ in range(reps):
                if cold_l2:
                    _flush_buf.fill_(1.0)
                fn()
            torch.cuda.synchronize()
        rows = [v for k_, v in kernels(prof).items() if k_ not in flush]
        if rows and all(n % reps == 0 for _, n in rows):
            return sum(us for us, _ in rows) / reps / 1e3, None
        seen = rows or seen
    if not seen:
        print("  (device_ms: the profiler recorded no kernel in 5 runs; the "
              "CUDA-event time stands in)")
        return time_ms(fn, reps, warmup, cold_l2), "cuda events"
    counts = [n for _, n in seen]
    print(f"  (device_ms: kernel records lost in 5 runs, counts {counts} for "
          f"{reps} calls; mean recorded duration x launches a call, an "
          f"estimate)")
    return sum(us / n * max(1, round(n / reps)) for us, n in seen) / 1e3, counts


def device_times(fn, lib, cold_l2: bool = False):
    """A row's device times beside its CUDA-event times (the difference is
    the host's): ``device_ms`` of ``fn`` and of its library call ``lib`` as
    ``device_ms`` and ``library_device_ms``, and where the profiler lost
    records in five runs and a time is an estimate, what it was estimated
    from (``*_estimated_from``: the recorded launches or "cuda events").
    ``lib`` may also be the library call's ``device_ms`` result, where rows
    share one library call."""
    dms, lost = device_ms(fn, cold_l2=cold_l2)
    ldms, llost = lib if isinstance(lib, tuple) else device_ms(lib, cold_l2=cold_l2)
    return dict(device_ms=dms, library_device_ms=ldms,
                **{k_: v for k_, v in (("device_ms_estimated_from", lost),
                                       ("library_device_ms_estimated_from", llost))
                   if v is not None})


def bound_ms(nbytes: float, flops, rate: float = F32_FLOPS):
    """The larger of the bytes' time and the operations' time: ``flops`` at
    ``rate``, or (flops, rate) pairs, one for each kind of unit the work
    runs on, their times added."""
    pairs = [(flops, rate)] if isinstance(flops, (int, float)) else flops
    tb, tf = nbytes / HBM_BYTES * 1e3, sum(f / r for f, r in pairs) * 1e3
    return (tf, "operations") if tf >= tb else (tb, "bytes")


def compare(name, got, want, tol_rel):
    """Max abs/rel error of ``got`` vs ``want``; fail beyond
    ``tol_rel * max(1, max|want|)``."""
    got = [got] if torch.is_tensor(got) else list(got)
    want = [want] if torch.is_tensor(want) else list(want)
    err, rel = 0.0, 0.0
    for g, w in zip(got, want):
        w = w.to(g.device)
        d = (g.double() - w.double()).abs().max().item()
        scale = max(1.0, w.float().abs().max().item())
        err, rel = max(err, d), max(rel, d / scale)
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite output")
    ok = rel <= tol_rel
    print(f"  {name}: max_abs_err {err:.3e}  max_rel_err {rel:.3e}  "
          f"(tol {tol_rel:g} x max(1, |ref|))  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def keep_table(gen, rows, hidden, rate):
    from repro_torch.core import masks
    return torch.stack([masks.sample_keep_blocks(gen, hidden, rate, 1)
                        for _ in range(rows)]).cuda()


def row_name(counter, arch):
    """JSON row name: the launch counter's name, tagged with the arch where
    a kernel of the zaremba path is timed at the luong-nmt shapes too."""
    own = counter.startswith(("decoder_scan", "slstm_", "flash_",
                              "grouped_matmul", "lstm_pointwise"))
    return counter if arch == LM or own else f"{counter}@{arch}"


def add_row(out, counter, arch, src, replaces, err, ms, pms, lms, nbytes,
            flops, l2, name=None, rate=F32_FLOPS, **extra):
    b, by = bound_ms(nbytes, flops, rate)
    name = name or row_name(counter, arch)
    print(f"  {name}: {ms:.4f} ms  plain {pms:.4f} ms  library "
          f"{'n/a' if lms is None else f'{lms:.4f} ms'}  bound {b:.4f} ms "
          f"({by}), L2 {l2}"
          + "".join(f"  {k_} {v}" for k_, v in extra.items()))
    out[name] = dict(name=name, route="cuda", source=src, replaces=replaces,
                     max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b,
                     bound_by=by, library_ms=lms, l2=l2, arch=arch,
                     counter=counter, **extra)


def check_gather_matmul(gen, out, arch=LM, T=T, B=B, H=H, D=D, P=P,
                        extras=True, k2=True):
    """K1 (and, with ``k2``, K2) at one path's shapes against their plain
    versions, timed beside the plain version and ``torch.matmul``."""
    from repro_torch.kernels import gather_matmul as gm
    k = H - math.ceil(P * H)
    U = torch.randn(H, 4 * H, generator=gen).cuda() * 0.05
    W = torch.randn(D, 4 * H, generator=gen).cuda() * 0.05
    kb1 = keep_table(gen, 1, H, P)[0]
    kbT = keep_table(gen, T, D, P)
    scale = H / k
    uniq = int(torch.unique(kbT).numel())
    print(f"K1{'/K2' if k2 else ''} gather_matmul ({arch}): M={B} k={k} "
          f"N={4 * H} T={T} (rows of W kept at some step: {uniq})")

    def row(name, route_src, replaces, got, want, tol, fn, plain, lib,
            nbytes, flops, cold_l2, plan):
        err = compare(row_name(name, arch), got, want, tol)
        ms = time_ms(fn, cold_l2=cold_l2)
        pms = time_ms(plain, cold_l2=cold_l2)
        lms = time_ms(lib, cold_l2=cold_l2)
        add_row(out, name, arch, route_src, replaces, err, ms, pms, lms,
                nbytes, flops, "cold" if cold_l2 else "warm",
                **device_times(fn, lib, cold_l2),
                plan=dict(bm=plan.bm, bn=plan.bn, split=plan.split,
                          ctas=math.prod(plan.grid)))

    src = "src/repro_torch/csrc/gather_matmul.cu"

    def plan(mode, T_, a_, b_):
        """The wrapper's launch plan for this call (tiles, cluster split)."""
        C_, O_ = (k, 4 * H) if mode == "fp" else (4 * H, k)
        return gm._plan(mode, T_, B, C_, O_, gm._vec_ok(a_, a_.shape[-1]),
                        gm._vec_ok(b_, b_.shape[1]), gm._sms(0))

    # K1 runs once per time step on the same U, so its caller finds U in L2
    # (timed warm); K2 runs once per layer and phase, after other work
    # (timed cold).
    # K1 FP: the scheduled engine's in-scan RH product h_c @ U[kept].
    a = torch.randn(B, k, generator=gen).cuda()
    af = torch.zeros(B, H, device="cuda").index_copy_(1, kb1.long(), a)
    kw = dict(block_size=1, a_is_compact=True, alpha=scale)
    f = lambda: gm.gather_matmul(a, U, kb1, **kw)
    p = lambda: gm.gather_matmul_plain(a, U, kb1, **kw)
    row("gather_matmul/fp", src, "src/repro/kernels/gather_matmul.py:40",
        f(), p(), 2e-4, f, p, lambda: torch.matmul(af, U),
        4 * (B * k + k * 4 * H + k + B * 4 * H), 2 * B * k * 4 * H, False,
        plan("fp", 1, a, U))
    # K1 BP: its backward, dy @ U[kept].T (compact).
    dy = torch.randn(B, 4 * H, generator=gen).cuda()
    kw = dict(block_size=1, transpose_b=True, alpha=scale)
    f = lambda: gm.gather_matmul(dy, U, kb1, **kw)
    p = lambda: gm.gather_matmul_plain(dy, U, kb1, **kw)
    row("gather_matmul/bp", src, "src/repro/kernels/gather_matmul.py:40",
        f(), p(), 2e-4, f, p, lambda: torch.matmul(dy, U.t()),
        4 * (B * 4 * H + k * 4 * H + k + B * k), 2 * B * k * 4 * H, False,
        plan("bp", 1, dy, U))
    if extras:
        # the cluster-split BP twice: its partial tiles are summed in rank
        # order, so the two results must be the same bits
        pl = plan("bp", 1, dy, U)
        y1, y2 = f(), f()
        torch.cuda.synchronize()
        same = torch.equal(y1, y2)
        print(f"  gather_matmul/bp cluster split {pl.split}: two launches "
              f"bit-identical: {same}")
        if pl.split < 2 or not same:
            raise AssertionError("the cluster-split BP is not deterministic")
    if not k2:
        return
    # K2 FP: Phase A NR, x_c (T, B, k) @ W[kept_t].
    x = torch.randn(T, B, k, generator=gen).cuda()
    xf = torch.zeros(T, B, D, device="cuda").scatter_(
        2, kbT.long()[:, None, :].expand(T, B, k), x)
    kw = dict(block_size=1, a_is_compact=True, alpha=scale)
    f = lambda: gm.gather_matmul_stepped(x, W, kbT, **kw)
    p = lambda: gm.gather_matmul_stepped_plain(x, W, kbT, **kw)
    row("gather_matmul_stepped/fp", src, "src/repro/kernels/gather_matmul.py:158",
        f(), p(), 2e-4, f, p, lambda: torch.matmul(xf, W),
        4 * (T * B * k + uniq * 4 * H + T * k + T * B * 4 * H),
        2 * T * B * k * 4 * H, True, plan("fp", T, x, W))
    # K2 BP: dy (T, B, 4H) @ W[kept_t].T.
    dyT = torch.randn(T, B, 4 * H, generator=gen).cuda()
    kw = dict(block_size=1, transpose_b=True, alpha=scale)
    f = lambda: gm.gather_matmul_stepped(dyT, W, kbT, **kw)
    p = lambda: gm.gather_matmul_stepped_plain(dyT, W, kbT, **kw)
    row("gather_matmul_stepped/bp", src, "src/repro/kernels/gather_matmul.py:158",
        f(), p(), 2e-4, f, p, lambda: torch.matmul(dyT, W.t()),
        4 * (T * B * 4 * H + uniq * 4 * H + T * k + T * B * k),
        2 * T * B * k * 4 * H, True, plan("bp", T, dyT, W))
    if not extras:
        return
    # b_cols (FFN-out variant; no model of this slice calls it) and the
    # a-gathered FP variant: correctness only.
    a2 = torch.randn(B, D, generator=gen).cuda()
    kw = dict(block_size=1, gather="b_cols")
    compare("gather_matmul/cols", gm.gather_matmul(a2, W, kb1, **kw),
            gm.gather_matmul_plain(a2, W, kb1, **kw), 2e-4)
    # the kernels against a float64 product on the host, independent of cuBLAS
    ids64 = kbT.long().cpu()
    want = torch.bmm(x.double().cpu(), W.double().cpu()[ids64]) * scale
    compare("gather_matmul_stepped/fp vs float64", gm.gather_matmul_stepped(
        x, W, kbT, block_size=1, a_is_compact=True, alpha=scale), want, 2e-4)
    want = torch.bmm(dyT.double().cpu(),
                     W.double().cpu()[ids64].transpose(1, 2)) * scale
    compare("gather_matmul_stepped/bp vs float64", gm.gather_matmul_stepped(
        dyT, W, kbT, block_size=1, transpose_b=True, alpha=scale), want, 2e-4)
    compare("gather_matmul/fp a-gathered", gm.gather_matmul(af, U, kb1, block_size=1),
            gm.gather_matmul_plain(af, U, kb1, block_size=1), 2e-4)
    kb8 = torch.stack([torch.sort(torch.randperm(80, generator=gen)[:40]).values
                       for _ in range(T)]).to(torch.int32).cuda()
    W8 = W[:640].contiguous()
    compare("gather_matmul_stepped/fp a-gathered bs=8",
            gm.gather_matmul_stepped(xf[..., :640].contiguous(), W8, kb8, block_size=8),
            gm.gather_matmul_stepped_plain(xf[..., :640], W8, kb8, block_size=8), 2e-4)


def scan_inputs(gen, T_, B_, H_, rate, mode, fixed=False, ragged=False,
                min_len=0):
    gx = (torch.randn(T_, B_, 4 * H_, generator=gen) * 0.5).cuda()
    U = (torch.randn(H_, 4 * H_, generator=gen) * 0.05).cuda()
    h0 = (torch.randn(B_, H_, generator=gen) * 0.5).cuda()
    c0 = (torch.randn(B_, H_, generator=gen) * 0.5).cuda()
    rows = 1 if fixed else T_
    ids = mask = lengths = None
    scale = 1.0
    if mode == "structured":
        ids = keep_table(gen, rows, H_, rate)
        scale = H_ / ids.shape[1]
    elif mode == "dense":
        mask = (torch.rand(rows, B_, H_, generator=gen) >= rate).float().cuda()
        scale = 1.0 / (1.0 - rate)
    if ragged:
        lengths = torch.randint(min_len, T_ + 1, (B_,), generator=gen,
                                dtype=torch.int32).cuda()
    dy = torch.randn(T_, B_, H_, generator=gen).cuda()
    dcT = torch.randn(B_, H_, generator=gen).cuda()
    return gx, U, h0, c0, ids, mask, lengths, scale, dy, dcT


def check_scan(gen, T_, B_, H_, rate, mode, *, fixed=False, ragged=False,
               min_len=0, out=None, deep=False, tag="", arch=LM):
    """K3 and K4 against their plain versions; with ``out`` (a main-path
    shape, timed into a row of ``out``) or ``deep``, also against a second
    launch for the same bits and a float64 run of the plain versions."""
    from repro_torch.kernels import cell_scan as cs_mod
    from repro_torch.kernels import lstm_scan as ls
    cell = ls.lstm_cell_spec(0.0)
    gx, U, h0, c0, ids, mask, lengths, scale, dy, dcT = scan_inputs(
        gen, T_, B_, H_, rate, mode, fixed, ragged, min_len)
    rh = (ids, mask, lengths, scale)
    fwd_k = lambda: ls.lstm_scan_fwd_cuda(gx, U, h0, (c0,), *rh, forget_bias=0.0)
    fwd_p = lambda: cs_mod.plain_fwd(cell, gx, U, h0, (c0,), *rh)
    hs, gates, (cs,) = fwd_k()
    hs_p, gates_p, (cs_p,) = fwd_p()
    print(f"lstm_scan T={T_} B={B_} H={H_} {mode}"
          f"{' FIXED' if fixed else ''}{' ragged' if ragged else ''}")
    e_f = compare("  lstm_scan_fwd " + tag, [hs, gates, cs],
                  [hs_p, gates_p, cs_p], 1e-3)
    saved = (gates_p, (cs_p,), (c0,), hs_p, h0, U)
    bwd_k = lambda: ls.lstm_scan_bwd_cuda(dy, (dcT,), *saved, *rh, forget_bias=0.0)
    bwd_p = lambda: cs_mod.plain_bwd(cell, dy, (dcT,), *saved, *rh)
    dgx, dU, dh0, (dc0,) = bwd_k()
    dgx_p, dU_p, dh0_p, (dc0_p,) = bwd_p()
    e_b = compare("  lstm_scan_bwd " + tag, [dgx, dU, dh0, dc0],
                  [dgx_p, dU_p, dh0_p, dc0_p], 1e-3)
    if out is None and not deep:
        return
    # the main path: second launches for the same bits, and float64 runs of
    # the plain versions (the reverse on the same float32 residuals)
    same_bits("  lstm_scan_fwd second launch " + tag, [hs, gates, cs],
              lambda: (lambda o: (o[0], o[1], o[2][0]))(fwd_k()))
    d = lambda t: None if t is None else t.double()
    ref = cs_mod.plain_fwd(cell, d(gx), d(U), d(h0), (d(c0),), ids, d(mask), lengths, scale)
    f_f64 = f64_gate("  lstm_scan_fwd " + tag, [hs, gates, cs], [hs_p, gates_p, cs_p],
                     [ref[0], ref[1], ref[2][0]])
    flat = lambda o: (o[0], o[1], o[2], o[3][0])
    same_bits("  lstm_scan_bwd second launch " + tag, [dgx, dU, dh0, dc0],
              lambda: flat(bwd_k()))
    ref = flat(cs_mod.plain_bwd(cell, d(dy), (d(dcT),), d(gates_p), (d(cs_p),), (d(c0),),
                                d(hs_p), d(h0), d(U), *rh))
    b_f64 = f64_gate("  lstm_scan_bwd " + tag, [dgx, dU, dh0, dc0],
                     [dgx_p, dU_p, dh0_p, dc0_p], ref)
    del ref
    if out is None:
        return
    k = ids.shape[1] if ids is not None else H_
    uniq = int(torch.unique(ids).numel()) if ids is not None else H_
    G = 4 * H_
    # K3's and K4's latency floors: T x the cheapest per-step exchange on
    # their grids
    f_floor = scan_floor(T_, B_, H_, k, forward=True)
    floor = scan_floor(T_, B_, H_, k)
    src = "src/repro_torch/csrc/lstm_scan.cu"
    for name, fk, fp, err, nbytes, flops, rep, extra in (
            ("lstm_scan_fwd", fwd_k, fwd_p, e_f,
             4 * (T_ * B_ * G + uniq * G + 2 * B_ * H_ + T_ * k
                  + 2 * T_ * B_ * H_ + T_ * B_ * G),
             k3_ops(T_, B_, H_, k), "src/repro/kernels/cell_scan.py:172",
             dict(floor_ms=f_floor, f64_rel_err=f_f64)),
            ("lstm_scan_bwd", bwd_k, bwd_p, e_b,
             4 * (T_ * B_ * H_ + B_ * H_ + T_ * B_ * G + 2 * T_ * B_ * H_
                  + 2 * B_ * H_ + uniq * G + T_ * k
                  + T_ * B_ * G + H_ * G + 2 * B_ * H_),
             k4_ops(T_, B_, H_, k), "src/repro/kernels/cell_scan.py:215",
             dict(floor_ms=floor, f64_rel_err=b_f64))):
        # once per layer and step, after other work: timed with a cold L2
        ms = time_ms(fk, cold_l2=True)
        pms = time_ms(fp, reps=5, warmup=1, cold_l2=True)
        add_row(out, name, arch, src, rep, err, ms, pms, None, nbytes, flops,
                "cold", **extra)


def k3_ops(T_, B_, H_, k):
    """K3's operations as (FLOPs, rate) pairs: its product on FFMA."""
    from repro_torch.launch import scan_bench
    ops = scan_bench.k3_fwd_ops(T_, B_, H_, k)
    return [(ops["tf32"], TF32_FLOPS), (ops["f32"], F32_FLOPS)]


def k4_ops(T_, B_, H_, k):
    """K4's operations as (FLOPs, rate) pairs: BP and WG on the TF32
    tensor cores (3xTF32)."""
    from repro_torch.launch import scan_bench
    ops = scan_bench.k4_bwd_ops(T_, B_, H_, k)
    return [(ops["tf32"], TF32_FLOPS), (ops["f32"], F32_FLOPS)]


def scan_floor(T_, B_, H_, k, forward=False, exchanges=1):
    """K3's, K4's, K7's or K8's latency floor at a shape: T x ``exchanges``
    x the cheapest per-step exchange on the kernel's grid
    (``launch/scan_bench.py``'s probes; ``forward``: the forwards'
    probes, k the inputs an exchange moves)."""
    from repro_torch.launch import scan_bench
    fl = scan_bench.floor_probes(sys.modules[__name__], T_, B_, H_, k, forward=forward)
    print(f"  {'forward' if forward else 'backward'} latency floor probes (us a step): "
          + ", ".join(f"{n} {v:.3f}" for n, v in fl["us_per_step"].items()))
    return scan_bench.floor_ms(fl["us_per_step"], T_, exchanges)


def decoder_inputs(gen, T_, B_, S_, H_, kind, rate, bs, ragged):
    """K7/K8 operands on the card: nl=2, the last source positions of each
    row padded (score_bias -1e30), sites of one ``kind`` (off / sf / sp /
    df / dp structured-or-dense FIXED-or-per-step, or a mixed assignment),
    and non-zero cotangents for every output, finals included."""
    from repro_torch.kernels import decoder_scan as ds
    nl, G = 2, 4 * H_
    r = lambda *shape, std: (torch.randn(*shape, generator=gen) * std).cuda()
    pad = torch.arange(S_)[None, :] >= (S_ - 1 - torch.arange(B_)[:, None] % 7)
    ops = dict(gx0=r(T_, B_, G, std=0.5), us=[r(H_, G, std=0.05) for _ in range(nl)],
               ws=[r(H_, G, std=0.05)], bs=[r(G, std=0.05)], w_feed=r(H_, G, std=0.05),
               w_comb=r(2 * H_, H_, std=0.05), enc_proj=r(B_, S_, H_, std=0.3),
               enc_out=r(B_, S_, H_, std=0.3),
               score_bias=torch.where(pad, -1e30, 0.0).float().cuda(),
               h0=r(nl, B_, H_, std=0.5), c0=r(nl, B_, H_, std=0.5),
               feed0=r(B_, H_, std=0.5))
    sites = []
    for i in range(2 * nl):
        k = ("off", "sf", "sp", "dp")[i % 4] if kind == "mixed" else kind
        if k == "off":
            sites.append((None, None, 1, 1.0))
        elif k in ("sf", "sp"):
            from repro_torch.core import masks
            nb = H_ // bs
            kb = torch.stack([masks.sample_keep_blocks(gen, H_, rate, bs)
                              for _ in range(1 if k == "sf" else T_)]).cuda()
            sites.append((kb, None, bs, nb / kb.shape[1]))
        else:
            rows = 1 if k == "df" else T_
            m = (torch.rand(rows, B_, H_, generator=gen) >= rate).float().cuda()
            sites.append((None, m, 1, 1.0 / (1.0 - rate)))
    pairs = [ds._mk_site(*s_) for s_ in sites]
    descs = tuple(p_[0] for p_ in pairs)
    tables = tuple(None if t_ is None else t_.contiguous() for _, t_ in pairs)
    lengths = (torch.randint(0, T_ + 1, (B_,), generator=gen, dtype=torch.int32).cuda()
               if ragged else None)
    dout = (r(T_, B_, H_, std=1.0), r(nl, B_, H_, std=1.0), r(nl, B_, H_, std=1.0),
            r(B_, H_, std=1.0))
    return descs, tables, ops, lengths, dout


def check_decoder(gen, T_, B_, S_, H_, kind, *, rate=0.5, bs=4, ragged=False,
                  out=None, tag=""):
    """K7/K8 against the plain decoder_scan on the same inputs: every
    forward output (h~, gates, h, c, alpha) and every gradient (dgx0,
    dW_feed, dU, dW, db, dW_comb, d enc_proj, d enc_out, dh0, dc0,
    dfeed0)."""
    from repro_torch.kernels import decoder_scan as ds
    descs, tables, o, lengths, dout = decoder_inputs(gen, T_, B_, S_, H_, kind,
                                                     rate, bs, ragged)
    fargs = (descs, tables, o["gx0"], o["us"], o["ws"], o["bs"], o["w_feed"],
             o["w_comb"], o["enc_proj"], o["enc_out"], o["score_bias"], o["h0"],
             o["c0"], o["feed0"], lengths)
    fwd_k = lambda: ds.kernel_fwd(*fargs)
    fwd_p = lambda: ds.plain_fwd(*fargs)
    print(f"decoder_scan T={T_} B={B_} S={S_} H={H_} nl=2 {kind}"
          f"{' ragged' if ragged else ''}")
    res = fwd_p()
    got_f = fwd_k()
    e_f = compare("  decoder_scan_fwd " + tag, got_f, res, 1e-3)
    bargs = (descs, tables, res, dout, o["us"], o["ws"], o["w_feed"], o["w_comb"],
             o["enc_proj"], o["enc_out"], o["h0"], o["c0"], o["feed0"], lengths)
    flat = lambda g: [x for v in g for x in (v if isinstance(v, list) else [v])]
    bwd_k = lambda: ds.kernel_bwd(*bargs)
    bwd_p = lambda: ds.plain_bwd(*bargs)
    got_b, plain_b = flat(bwd_k()), flat(bwd_p())
    e_b = compare("  decoder_scan_bwd " + tag, got_b, plain_b, 1e-3)
    if out is None:
        return
    # the main path: second launches for the same bits, and float64 runs of
    # the plain versions (the reverse on the same float32 residuals)
    same_bits("  decoder_scan_fwd second launch " + tag, got_f, fwd_k)
    d = lambda v: [x.double() for x in v] if isinstance(v, (list, tuple)) else v.double()
    keys = ("gx0", "us", "ws", "bs", "w_feed", "w_comb", "enc_proj", "enc_out", "score_bias",
            "h0", "c0", "feed0")
    ref = ds.plain_fwd(descs, tables, *(d(o[k_]) for k_ in keys), lengths)
    f_f64 = f64_gate("  decoder_scan_fwd " + tag, got_f, res, ref)
    del got_f, ref
    same_bits("  decoder_scan_bwd second launch " + tag, got_b, lambda: flat(bwd_k()))
    ref = flat(ds.plain_bwd(descs, tables, tuple(d(res)), tuple(d(dout)), d(o["us"]),
                            d(o["ws"]), d(o["w_feed"]), d(o["w_comb"]), d(o["enc_proj"]),
                            d(o["enc_out"]), d(o["h0"]), d(o["c0"]), d(o["feed0"]), lengths))
    b_f64 = f64_gate("  decoder_scan_bwd " + tag, got_b, plain_b, ref)
    del ref, got_b, plain_b
    # the work this call's data needs: kept rows per site, kept units per step
    nl, G, H2 = 2, 4 * H_, 2 * H_
    kept = [H_ if t_ is None or d.mode == "dense" else t_.shape[1]
            for d, t_ in zip(descs, tables)]
    uniq = [H_ if t_ is None or d.mode == "dense" else int(torch.unique(t_).numel())
            for d, t_ in zip(descs, tables)]
    ids = sum(0 if t_ is None else t_.numel() for t_ in tables)
    # the gate products on the TF32 tensor cores in split precision (3xTF32),
    # the backward's too; the rest of the readout and the attention on FFMA
    from repro_torch.launch import scan_bench
    f_ops = scan_bench.k7_fwd_ops(T_, B_, S_, H_, kept)
    f_flops = [(f_ops["tf32"], TF32_FLOPS), (f_ops["f32"], F32_FLOPS)]
    b_ops = scan_bench.k8_bwd_ops(T_, B_, S_, H_, kept)
    b_flops = [(b_ops["tf32"], TF32_FLOPS), (b_ops["f32"], F32_FLOPS)]
    wbytes = sum(u * G for u in uniq) + H2 * H_ + (nl - 1) * G
    f_bytes = 4 * (T_ * B_ * G + wbytes + 2 * B_ * S_ * H_ + B_ * S_
                   + (2 * nl + 1) * B_ * H_ + ids
                   + T_ * B_ * H_ + T_ * B_ * S_ + nl * T_ * B_ * G
                   + 2 * nl * T_ * B_ * H_)
    b_bytes = 4 * (T_ * B_ * H_ + (2 * nl + 1) * B_ * H_ + nl * T_ * B_ * G
                   + 2 * nl * T_ * B_ * H_ + T_ * B_ * H_ + T_ * B_ * S_
                   + (2 * nl + 1) * B_ * H_ + wbytes + 2 * B_ * S_ * H_ + ids
                   + T_ * B_ * G + 2 * nl * H_ * G + (nl - 1) * G + H2 * H_
                   + 2 * B_ * S_ * H_ + (2 * nl + 1) * B_ * H_)
    # K7's latency floor: T x four dependent exchanges a step (a layer's
    # two sites' inputs each), K8's: T x the cheapest per-step exchange
    f_floor = scan_floor(T_, B_, H_, kept[0] + kept[1], forward=True, exchanges=4)
    floor = scan_floor(T_, B_, H_, kept[1])
    src = "src/repro_torch/csrc/decoder_scan.cu"
    for name, fk, fp, err, nbytes, flops, rep, extra in (
            ("decoder_scan_fwd", fwd_k, fwd_p, e_f, f_bytes, f_flops,
             "src/repro/kernels/decoder_scan.py:413", dict(floor_ms=f_floor, f64_rel_err=f_f64)),
            ("decoder_scan_bwd", bwd_k, bwd_p, e_b, b_bytes, b_flops,
             "src/repro/kernels/decoder_scan.py:598",
             dict(floor_ms=floor, f64_rel_err=b_f64))):
        # once per training step, after other work: timed with a cold L2
        ms = time_ms(fk, cold_l2=True)
        pms = time_ms(fp, reps=3, warmup=1, cold_l2=True)
        add_row(out, name, NMT, src, rep, err, ms, pms, None, nbytes, flops,
                "cold", **extra)


def slstm_inputs(gen, T_, B_, NH_, dh_, rate, mode, bs, fixed, ragged, fresh,
                 mask_heads):
    """K6 operands on the card: xg (std 0.5), R at the model's init scale,
    fresh (zeros, m0 = -1e30) or mid-stream (random h0, c0, m0, n0 > 0)
    states, an RH mode, optional lengths, and non-zero cotangents."""
    r = lambda *shape, std: (torch.randn(*shape, generator=gen) * std).cuda()
    gx = r(T_, B_, NH_, 4 * dh_, std=0.5)
    R = r(NH_, dh_, 4 * dh_, std=dh_ ** -0.5)
    if fresh:
        z = torch.zeros(B_, NH_, dh_, device="cuda")
        h0, st0 = z, (z, z, torch.full_like(z, -1e30))
    else:
        h0 = r(B_, NH_, dh_, std=0.5)
        st0 = (r(B_, NH_, dh_, std=0.5), r(B_, NH_, dh_, std=1.0).abs() + 0.5,
               r(B_, NH_, dh_, std=0.3))
    rows = 1 if fixed else T_
    ids = mask = lengths = None
    scale = 1.0
    if mode == "structured":
        from repro_torch.core import masks
        kb = torch.stack([masks.sample_keep_blocks(gen, dh_, rate, bs)
                          for _ in range(rows)])
        ids = masks.keep_blocks_to_unit_ids(kb, bs).to(torch.int32).cuda()
        scale = dh_ / ids.shape[1]
    elif mode == "dense":
        mask = (torch.rand(rows, B_, mask_heads, dh_, generator=gen)
                >= rate).float().cuda()
        scale = 1.0 / (1.0 - rate)
    if ragged:
        lengths = torch.randint(0, T_ + 1, (B_,), generator=gen,
                                dtype=torch.int32).cuda()
    dy = r(T_, B_, NH_, dh_, std=1.0)
    dstT = tuple(r(B_, NH_, dh_, std=1.0) for _ in range(3))
    return gx, R, h0, st0, ids, mask, lengths, scale, dy, dstT


def check_slstm(gen, T_, B_, NH_, dh_, rate, mode, *, bs=1, fixed=False,
                ragged=False, fresh=False, mask_heads=1, out=None, tag="",
                dtype=torch.float32):
    """K6 forward (hs, gates, c, n, m) and backward (dxg, dR, dh0, dc0, dn0,
    dm0; the scan, then dR from the WG kernel) against the plain cell_scan
    with SLSTM_CELL on the same inputs, and a second launch of each for the
    same bits. At the main path (``out``) also against a float64 run of the
    plain versions, beside the float32 plain version's distance to it, and
    the WG kernel alone against its plain version.

    ``dtype=torch.bfloat16``: xg and R rounded to bfloat16 (states float32),
    the reference's dtype contract. Every output must come back in its
    dtype; the kernels are held to the plain versions within 3e-2 x max(1,
    |ref|) (a gate value's or cotangent's bfloat16 rounding may flip where
    the float32 sums differ in their last bits), and, in every mode, to a
    float64 run of the plain versions on the same rounded inputs within 10 x
    the bfloat16 plain version's distance + 1e-6 (its outputs rounded to
    their dtypes, as the autograd wrapper returns them); WG alone too."""
    from repro_torch.kernels import cell_scan as cs_mod
    from repro_torch.kernels import slstm_scan as ss
    gx, R, h0, st0, ids, mask, lengths, scale, dy, dstT = slstm_inputs(
        gen, T_, B_, NH_, dh_, rate, mode, bs, fixed, ragged, fresh, mask_heads)
    bf = dtype == torch.bfloat16
    gx, R = gx.to(dtype), R.to(dtype)
    f32, tol = torch.float32, 3e-2 if bf else 1e-3
    sfx = "/bf16" if bf else ""
    rh = (ids, mask, lengths, scale)
    fwd_k = lambda: ss.slstm_scan_fwd_cuda(gx, R, h0, st0, *rh)
    fwd_p = lambda: cs_mod.plain_fwd(ss.SLSTM_CELL, gx, R, h0, st0, *rh)
    hs, gates, sts = fwd_k()
    hs_p, gates_p, sts_p = fwd_p()
    print(f"slstm_scan T={T_} B={B_} heads={NH_} dh={dh_} {mode}"
          f"{' FIXED' if fixed else ''}{' ragged' if ragged else ''}"
          f"{' fresh' if fresh else ' handoff'} {str(dtype)[6:]}")
    e_f = compare("  slstm_scan_fwd " + tag, [hs, gates, *sts],
                  [hs_p, gates_p, *sts_p], tol)
    saved = (gates_p, sts_p, st0, hs_p, h0, R)
    bwd_k = lambda: ss.slstm_scan_bwd_cuda(dy, dstT, *saved, *rh)
    bwd_p = lambda: cs_mod.plain_bwd(ss.SLSTM_CELL, dy, dstT, *saved, *rh)
    dgx, dR, dh0, dst0 = bwd_k()
    dgx_p, dR_p, dh0_p, dst0_p = bwd_p()      # float32 dgates and dR
    e_b = compare("  slstm_scan_bwd " + tag, [dgx, dR, dh0, *dst0],
                  [dgx_p, dR_p, dh0_p, *dst0_p], tol)
    want = [f32, dtype, f32, f32, f32, dtype, dtype, f32, f32, f32, f32]
    got_dt = [x.dtype for x in (hs, gates, *sts, dgx, dR, dh0, *dst0)]
    if got_dt != want:
        raise AssertionError(f"slstm_scan {tag}: dtypes {got_dt}, want {want}")
    same_bits("  slstm_scan_fwd/bwd second launch " + tag,
              [hs, gates, *sts, dgx, dR, dh0, *dst0],
              lambda: (*(lambda o: (o[0], o[1], *o[2]))(fwd_k()),
                       *(lambda o: (o[0], o[1], o[2], *o[3]))(bwd_k())))
    if out is None and not bf:
        return
    # float64 runs of the plain versions: the backward's on the plain
    # forward's residuals, so that each measures its own rounding
    d = lambda t: t.double()
    ref_f = cs_mod.plain_fwd(ss.SLSTM_CELL, d(gx), d(R), d(h0), tuple(map(d, st0)), *rh)
    ref_b = cs_mod.plain_bwd(ss.SLSTM_CELL, d(dy), tuple(map(d, dstT)), d(gates_p),
                             tuple(map(d, sts_p)), tuple(map(d, st0)), d(hs_p), d(h0),
                             d(R), *rh)
    f64_gate("  slstm_scan_fwd " + tag, [hs, gates, *sts], [hs_p, gates_p, *sts_p],
             [ref_f[0], ref_f[1], *ref_f[2]])
    f64_gate("  slstm_scan_bwd " + tag, [dgx, dR, dh0, *dst0],
             [dgx_p.to(dtype), dR_p.to(dtype), dh0_p, *dst0_p],
             [ref_b[0], ref_b[1], ref_b[2], *ref_b[3]])
    del ref_f, ref_b
    # WG alone on the plain scan's float32 dgates, with the wrapper's tables
    tables = ss.wg_tables(ids, T_, dh_, gx.device)
    wg_k = lambda: ss.slstm_wg(dgx_p, hs_p, h0, tables, mask, scale, out_dtype=dtype)
    wg_p = lambda: ss.plain_wg(dgx_p, hs_p, h0, tables, mask, scale)
    dR_w = wg_k()
    e_w = compare("  slstm_wg " + tag, dR_w, wg_p(), tol)
    if bf:
        ref = ss.plain_wg(d(dgx_p), d(hs_p), d(h0), tables, mask, scale)
        w_f64 = f64_gate("  slstm_wg " + tag, [dR_w], [wg_p().to(dtype)], [ref])
        del ref
    if out is None:
        return
    # the library yardstick: one torch.bmm over the heads on masked operands
    hp = torch.cat([h0[None], hs_p[:-1]])
    hp = hp * tables[2][:, None, None, :] if ids is not None else hp
    hp_t = hp.permute(2, 3, 0, 1).reshape(NH_, dh_, T_ * B_).contiguous()
    dg_t = dgx_p.permute(2, 0, 1, 3).reshape(NH_, T_ * B_, 4 * dh_).contiguous()
    wg_lib = lambda: torch.bmm(hp_t, dg_t)
    sc = scale if ids is not None else 1.0
    if not bf:
        # float32's accuracy (3xTF32): head 0 x 256 columns against a
        # float64 product of the same masked operands, torch.bmm's beside it
        ref = (hp_t[0].double() @ dg_t[0, :, :256].double()) * sc
        w_f64 = compare("  slstm_wg " + tag + " vs float64, head 0 x 256",
                        dR_w[0, :, :256], ref, 1e-5) / max(1.0, ref.abs().max().item())
        w_lib_f64 = ((wg_lib()[0, :, :256].double() * sc - ref).abs().max().item()
                     / max(1.0, ref.abs().max().item()))
        print(f"  torch.bmm vs float64, head 0 x 256: max_rel_err {w_lib_f64:.3e} "
              f"(the yardstick's own)")
        del ref
        hmma = sass_hmma("slstm_scan")
        wg_syms = [tf for sym, (tf, _) in hmma.items() if "slstm_wg_kernel" in sym]
        if not wg_syms or not all(wg_syms):
            raise AssertionError("slstm_wg_kernel: no TF32 HMMA in its SASS")
    else:
        w_lib_f64 = None
    del dR_w
    # the work this call's data needs: k kept units a step, R rows kept at
    # some step
    k = ids.shape[1] if ids is not None else dh_
    uniq = int(torch.unique(ids).numel()) if ids is not None else dh_
    G, st = 4 * dh_, B_ * NH_ * dh_
    idsz = 0 if ids is None else ids.numel()
    e = gx.element_size()      # xg, R, the gates residual, dgx and dR
    f_bytes = (e * (T_ * B_ * NH_ * G + NH_ * uniq * G + T_ * B_ * NH_ * G)
               + 4 * (4 * st + idsz + 4 * T_ * st))
    b_bytes = (e * (T_ * B_ * NH_ * G + NH_ * uniq * G + T_ * B_ * NH_ * G
                    + NH_ * dh_ * G)
               + 4 * (T_ * st + 3 * st + 3 * T_ * st + 3 * st + T_ * st + st
                      + idsz + 4 * st))
    kept_steps = int(tables[1].sum()) * ss.WG_UNITS if ids is not None else T_ * dh_
    w_bytes = (4 * (T_ * st + st + T_ * B_ * NH_ * G + tables[0].numel()
                    + tables[1].numel()
                    + sum(0 if x is None else x.numel() for x in tables[2:]))
               + e * NH_ * dh_ * G)
    src = "src/repro_torch/csrc/slstm_scan.cu"
    # the scans on FFMA; WG on the TF32 tensor cores, three TF32 products
    # for each float32 product (3xTF32)
    for name, fk, fp, fl, err, nbytes, flops, rate, extra, rep in (
            ("slstm_scan_fwd", fwd_k, fwd_p, None, e_f, f_bytes,
             2 * T_ * B_ * NH_ * k * G, F32_FLOPS, {}, "src/repro/kernels/cell_scan.py:172"),
            ("slstm_scan_bwd", bwd_k, bwd_p, None, e_b, b_bytes,
             4 * T_ * B_ * NH_ * k * G, F32_FLOPS, {}, "src/repro/kernels/cell_scan.py:215"),
            ("slstm_wg", wg_k, wg_p, wg_lib, e_w, w_bytes,
             3 * 2 * B_ * NH_ * kept_steps * G, TF32_FLOPS,
             dict(f64_rel_err=w_f64, library_f64_rel_err=w_lib_f64),
             "src/repro/kernels/cell_scan.py:215")):
        # once per sLSTM block and step, after other work: cold L2
        ms = time_ms(fk, cold_l2=True)
        pms = time_ms(fp, reps=3, warmup=1, cold_l2=True)
        lms = None if fl is None else time_ms(fl, cold_l2=True)
        add_row(out, name, XLSTM, src, rep, err, ms, pms, lms, nbytes, flops,
                "cold", rate=rate, name=name + sfx, dtype=str(dtype)[6:], **extra)


def same_bits(name, first, again):
    """Fail unless a second launch (``again()``) gives the same bits."""
    ok = all(torch.equal(a, b) for a, b in zip(first, again()))
    print(f"  {name}: {'same bits' if ok else 'FAIL: bits differ'}")
    if not ok:
        raise AssertionError(f"{name}: a second launch gave other bits")


def f64_gate(name, got, plain, ref):
    """Distances to a float64 run, max |err| / max(1, |ref|) over a group:
    fail where the kernel's exceeds 10 x the plain version's in the same
    dtype (the rounding yardstick) + 1e-6."""
    def dist(xs):
        return max((x.double() - r).abs().max().item() / max(1.0, r.abs().max().item())
                   for x, r in zip(xs, ref))
    dk, dp = dist(got), dist(plain)
    ok = dk <= 10 * dp + 1e-6
    print(f"  {name} vs float64: kernel {dk:.3e}, plain {dp:.3e} "
          f"(gate 10 x plain + 1e-6)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: float64 distance {dk:.3e} beyond its gate")
    return dk


def check_flash(gen, B_, Sq_, Sk_, Hq_, Hkv_, d_, *, causal=True, window=None,
                dtype=torch.float32, out=None, tag="", want_route=None, arch=QWEN,
                label="", gates=False):
    """K9 (o, lse), K10 (dq) and K11 (dk, dv) against their plain versions
    on the same inputs; both backward passes take the plain forward's lse
    and delta. float32 within 1e-3 x max(1, |ref|), bfloat16 within 3e-2
    (the reference's bf16 tolerance). With ``want_route`` ("wgmma" or
    "tf32"), each of the three passes must have launched on that route and
    on no other. With ``gates`` (bfloat16 on small inputs), also the same
    bits from a second launch and, over every
    (batch, kv head) group, float64 within 10 x the bfloat16 plain
    version's distance + 1e-6 (``flash_f64_bf16``). With ``out`` (the main
    path's shape):
    K9 also against a float64 forward and K10 and K11 against a float64
    backward over one (batch, kv head) group within ``FLASH_F64_TOL``
    (SDPA's distances printed beside theirs), all three launched twice for
    the same bits, timed beside SDPA, and their SASS must hold TF32 HMMA at
    every head dim (bfloat16: HGMMA on the wgmma route). A bfloat16 row
    also carries the tf32 route's time on the same inputs, in turns
    (``wgmma_vs_tf32``), and the kernel's and SDPA's device times
    (``device_times``)."""
    from repro_torch.kernels import flash_attention as fa
    r = lambda *shape: torch.randn(*shape, generator=gen).to("cuda", dtype)
    q, k, v, do = (r(B_, Sq_, Hq_, d_), r(B_, Sk_, Hkv_, d_),
                   r(B_, Sk_, Hkv_, d_), r(B_, Sq_, Hq_, d_))
    tol = 1e-3 if dtype == torch.float32 else 3e-2
    print(f"flash_attention B={B_} Sq={Sq_} Sk={Sk_} Hq={Hq_} Hkv={Hkv_} d={d_} "
          f"{'causal' if causal else 'full'}"
          f"{'' if window is None else f' window {window}'} {dtype}")
    o_p, lse_p = fa.attention_plain(q, k, v, causal, window)
    delta = fa.flash_delta(o_p, do)
    bargs = (q, k, v, do, lse_p, delta, causal, window)
    fwd_k = lambda: fa.flash_fwd_cuda(q, k, v, causal, window)
    fwd_p = lambda: fa.attention_plain(q, k, v, causal, window)
    dq_k = lambda: fa.flash_dq_cuda(*bargs)
    dq_p = lambda: fa.flash_dq_plain(*bargs)
    dkv_k = lambda: fa.flash_dkv_cuda(*bargs)
    dkv_p = lambda: fa.flash_dkv_plain(*bargs)
    before = read_counts()
    e9 = compare("  flash_fwd " + tag, list(fwd_k()), [o_p, lse_p], tol)
    e10 = compare("  flash_dq " + tag, dq_k(), dq_p(), tol)
    e11 = compare("  flash_dkv " + tag, list(dkv_k()), list(dkv_p()), tol)
    if want_route is not None:
        moved = {k_: n - before[k_] for k_, n in read_counts().items()
                 if k_.startswith("flash_") and "/" in k_ and n != before[k_]}
        assert moved == {f"{name}/{want_route}": 1 for name in FLASH_PASSES}, (tag, moved)
    if out is None and not gates:
        return
    del o_p
    bf = dtype == torch.bfloat16
    same_bits("flash_fwd, flash_dq, flash_dkv second launch", [*fwd_k(), dq_k(), *dkv_k()],
              lambda: [*fwd_k(), dq_k(), *dkv_k()])
    if bf:
        f64 = flash_f64_bf16(fa, q, k, v, do, causal, window)
        if out is None:
            return
        check_wgmma_sass(fa)
    else:
        f64 = flash_f64(fa, q, k, v, do, causal, window)
        f64.update(flash_fwd_f64(fa, q, k, v, causal, window))
        hmma = sass_hmma("flash_attention")
        for name in ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel"):
            for d in fa.HEAD_DIMS:
                f32 = [tf for sym, (tf, _) in hmma.items() if f"{name}IfLi{d}E" in sym]
                if not f32 or not all(f32):
                    raise AssertionError(f"{name} (float32, d={d}): no TF32 HMMA in its SASS")
    # the work this call's data needs: the visible (query, key) pairs
    pairs = int(fa._visible(Sq_, Sk_, causal, window, "cuda").sum())
    prod = 2 * B_ * Hq_ * pairs * d_              # flops of one product
    es = torch.finfo(dtype).bits // 8
    qb, kb = B_ * Sq_ * Hq_ * d_ * es, B_ * Sk_ * Hkv_ * d_ * es
    rows = 4 * B_ * Hq_ * Sq_                     # one float32 per query row
    assert window is None, "the library yardstick has no window"
    sdpa_f, sdpa_b = sdpa_calls(q, k, v, do, causal)
    lib_f, lib_b = time_ms(sdpa_f, cold_l2=True), time_ms(sdpa_b, cold_l2=True)
    # SDPA's device times, once: K10's and K11's rows share its backward
    dev_f, dev_b = ((device_ms(sdpa_f, cold_l2=True), device_ms(sdpa_b, cold_l2=True))
                    if bf else (None, None))
    rep = "src/repro/kernels/flash_attention.py:"
    # float32: on the TF32 tensor cores, three TF32 products for each
    # float32 product (3xTF32); bfloat16 inputs: the products themselves at
    # the bfloat16 rate, the route-independent least
    passes, rate = (1, BF16_FLOPS) if bf else (3, TF32_FLOPS)
    for name, fk, fp, err, nbytes, flops, lms, ldev, line in (
            ("flash_fwd", fwd_k, fwd_p, e9, qb + 2 * kb + qb + rows, passes * 2 * prod,
             lib_f, dev_f, "45"),
            ("flash_dq", dq_k, dq_p, e10, 3 * qb + 2 * kb + 2 * rows, passes * 3 * prod,
             lib_b, dev_b, "127"),
            ("flash_dkv", dkv_k, dkv_p, e11, 2 * qb + 4 * kb + 2 * rows,
             passes * 4 * prod, lib_b, dev_b, "158")):
        rt = fa.route(name, dtype, d_)
        counter = f"{name}/{rt}" if bf else name
        # once per layer and pass, after other work: cold L2; bfloat16 at the
        # main paths' head dims takes the wgmma route, timed in turns with
        # the tf32 route
        assert rt == ("wgmma" if bf else "tf32"), (name, rt)
        ms, prev = wgmma_vs_tf32(fa, fk) if bf else (time_ms(fk, cold_l2=True), None)
        pms = time_ms(fp, cold_l2=True)
        if bf:
            extra = dict(dtype="bfloat16", f64_rel_err=f64[name], kernel_route=rt,
                         tf32_route_ms=prev, **device_times(fk, ldev, cold_l2=True))
            if name != "flash_fwd":
                # the route's own work: K10 s, dp and ds in two terms; K11
                # s^T, dp^T and p, ds in two terms each
                extra["route_bound_ms"] = bound_ms(
                    nbytes, (4 if name == "flash_dq" else 6) * prod, BF16_FLOPS)[0]
        elif name == "flash_fwd":
            extra = dict(f64_rel_err=f64[name], library_f64_rel_err=f64["sdpa_fwd"])
        else:
            extra = dict(f64_rel_err=f64[name], library_f64_rel_err=f64["sdpa"],
                         library_covers="flash_dq + flash_dkv (one backward)")
        add_row(out, counter, arch, FLASH_SRC[rt], rep + line, err, ms, pms, lms, nbytes,
                flops, "cold", rate=rate,
                name=name + (f"@{label}" if label else "") + ("/bf16" if bf else ""),
                **extra)


FLASH_SRC = {"tf32": "src/repro_torch/csrc/flash_attention.cu",
             "wgmma": "src/repro_torch/csrc/flash_attention_sm90.cu"}
FLASH_PASSES = ("flash_fwd", "flash_dq", "flash_dkv")


def wgmma_routes(flash):
    """The launches by route that bfloat16 K9-K11 at head_dim 64, 128 or
    256 make for the pass counts ``flash``: all on wgmma."""
    return {"flash_fwd/wgmma": flash["flash_fwd"], "flash_fwd/tf32": 0,
            "flash_dq/wgmma": flash["flash_dq"], "flash_dq/tf32": 0,
            "flash_dkv/wgmma": flash["flash_dkv"], "flash_dkv/tf32": 0}


def wgmma_vs_tf32(mod, fn, **kw):
    """Cold-L2 times of ``fn`` on the wgmma route and on the tf32 route of
    kernel module ``mod`` (``tf32_route``), in turns (wgmma, tf32, tf32,
    wgmma): the means of each route's two medians (``kw`` to ``time_ms``)."""
    a = time_ms(fn, cold_l2=True, **kw)
    with tf32_route(mod):
        b = time_ms(fn, cold_l2=True, **kw) + time_ms(fn, cold_l2=True, **kw)
    a += time_ms(fn, cold_l2=True, **kw)
    return a / 2, b / 2


# K9 against a float64 forward, K10 / K11 against a float64 backward
# (float32's accuracy, which single-pass TF32 misses). The FFMA kernels K10
# / K11 replaced read dq 3.3e-7, dk 3.7e-6, dv 5.2e-6 there
# (launch/flash_bench.py, H100 80GB HBM3 at 700 W), inside this gate, so
# the gate is not loosened to them.
FLASH_F64_TOL = 1e-5


def flash_f64(fa, q, k, v, do, causal, window, b=0, hk=0):
    """dq of the group's G query heads and dk, dv of kv head ``hk`` (batch
    ``b``) from K10 / K11 and from SDPA's backward, against the same
    backward in float64 on the card (scores, softmax and products in
    float64). The kernels get the group's lse and delta from that float64
    forward, rounded to float32, so that only their own arithmetic is
    measured; SDPA runs its own forward. Fails the kernels beyond
    ``FLASH_F64_TOL`` x max(1, |ref|); returns {"flash_dq", "flash_dkv",
    "sdpa": max relative error}."""
    G = q.shape[2] // k.shape[2]
    hs = slice(hk * G, (hk + 1) * G)
    scale = fa.softmax_scale(q.shape[3])
    lse64, delta64, *want = fa.backward_float64(q, k, v, do, causal, window, b, hk)
    lse = fa.attention_plain(q, k, v, causal, window)[1]
    lse[b, hs] = lse64.float()
    delta = torch.zeros_like(lse)
    delta[b, hs] = delta64.float()
    args = (q, k, v, do, lse, delta, causal, window)
    dq = fa.flash_dq_cuda(*args)[b, :, hs]
    dk, dv = (x[b, :, hk] for x in fa.flash_dkv_cuda(*args))
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    import torch.nn.functional as F
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, scale=scale,
                                       enable_gqa=True)
    sg = torch.autograd.grad(o, (qt, kt, vt), do.transpose(1, 2))
    sdpa = (sg[0].transpose(1, 2)[b, :, hs], sg[1].transpose(1, 2)[b, :, hk],
            sg[2].transpose(1, 2)[b, :, hk])
    rel = lambda got, w: ((got.double() - w).abs().max().item()
                          / max(1.0, w.abs().max().item()))
    res = {"flash_dq": rel(dq, want[0]),
           "flash_dkv": max(rel(dk, want[1]), rel(dv, want[2])),
           "sdpa": max(rel(x, w) for x, w in zip(sdpa, want))}
    print(f"  vs float64 over (batch {b}, kv head {hk}), {G} query heads: "
          f"flash_dq {res['flash_dq']:.3e}, flash_dkv {res['flash_dkv']:.3e} "
          f"(dk {rel(dk, want[1]):.3e}, dv {rel(dv, want[2]):.3e}); "
          f"SDPA's backward {res['sdpa']:.3e} (the yardstick's own); "
          f"tol {FLASH_F64_TOL:g} x max(1, |ref|)")
    if max(res["flash_dq"], res["flash_dkv"]) > FLASH_F64_TOL:
        raise AssertionError("flash backward: beyond the float64 gate")
    return res


def flash_fwd_f64(fa, q, k, v, causal, window, b=0, hk=0):
    """o and lse of the group's G query heads (batch ``b``, kv head ``hk``)
    from K9 and from SDPA's forward, against the same forward in float64 on
    the card. Fails K9 beyond ``FLASH_F64_TOL`` x max(1, |ref|) (float32's
    accuracy, which single-pass TF32 misses); returns {"flash_fwd",
    "sdpa_fwd": max relative error}."""
    import torch.nn.functional as F
    G = q.shape[2] // k.shape[2]
    hs = slice(hk * G, (hk + 1) * G)
    o64, lse64 = fa.forward_float64(q, k, v, causal, window, b, hk)
    o, lse = fa.flash_fwd_cuda(q, k, v, causal, window)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    so = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                        scale=fa.softmax_scale(q.shape[3]), enable_gqa=True)
    rel = lambda got, w: ((got.double() - w).abs().max().item()
                          / max(1.0, w.abs().max().item()))
    res = {"flash_fwd": max(rel(o[b, :, hs], o64), rel(lse[b, hs], lse64)),
           "sdpa_fwd": rel(so.transpose(1, 2)[b, :, hs], o64)}
    print(f"  vs float64 over (batch {b}, kv head {hk}), {G} query heads: flash_fwd "
          f"{res['flash_fwd']:.3e} (o {rel(o[b, :, hs], o64):.3e}, lse "
          f"{rel(lse[b, hs], lse64):.3e}); SDPA's forward {res['sdpa_fwd']:.3e} (the "
          f"yardstick's own); tol {FLASH_F64_TOL:g} x max(1, |ref|)")
    if res["flash_fwd"] > FLASH_F64_TOL:
        raise AssertionError("flash forward: beyond the float64 gate")
    return res


def flash_f64_bf16(fa, q, k, v, do, causal, window, backward=True):
    """bfloat16 K9 (and, with ``backward``, K10 and K11) against float64
    runs over every (batch, kv head) group, each output gated on its own by
    ``f64_gate`` with the bfloat16 plain version as the yardstick (10 x its
    distance + 1e-6): o and lse, dq, dk and dv. Both backward passes take
    lse and delta from the float64 forward, rounded to float32. Returns
    {"flash_fwd", "flash_dq", "flash_dkv": the kernel's distance}."""
    B_, Hkv = q.shape[0], k.shape[2]
    G = q.shape[2] // Hkv
    groups = [(b, hk, slice(hk * G, (hk + 1) * G)) for b in range(B_) for hk in range(Hkv)]
    o_k, lse_k = fa.flash_fwd_cuda(q, k, v, causal, window)
    o_p, lse_p = fa.attention_plain(q, k, v, causal, window)
    fwd = [fa.forward_float64(q, k, v, causal, window, b, hk) for b, hk, _ in groups]
    pick = lambda x, qh: [x[b, :, hs] if qh else x[b, hs] for b, _, hs in groups]
    n = len(groups)
    res = {"flash_fwd": max(
        f64_gate(f"flash_fwd o (bf16, {n} groups)", pick(o_k, 1), pick(o_p, 1),
                 [o for o, _ in fwd]),
        f64_gate(f"flash_fwd lse (bf16, {n} groups)", pick(lse_k, 0), pick(lse_p, 0),
                 [lse for _, lse in fwd]))}
    del o_k, lse_k, o_p, lse_p, fwd
    if not backward:
        return res
    lse = torch.empty(q.shape[0], q.shape[2], q.shape[1], device=q.device)
    delta = torch.empty_like(lse)
    want = []
    for b, hk, hs in groups:
        lse64, delta64, *w = fa.backward_float64(q, k, v, do, causal, window, b, hk)
        lse[b, hs], delta[b, hs] = lse64.float(), delta64.float()
        want.append(w)
    args = (q, k, v, do, lse, delta, causal, window)
    dq_k, dq_p = fa.flash_dq_cuda(*args), fa.flash_dq_plain(*args)
    res["flash_dq"] = f64_gate(f"flash_dq (bf16, {n} groups)", pick(dq_k, 1),
                               pick(dq_p, 1), [w[0] for w in want])
    del dq_k, dq_p
    (dk_k, dv_k), (dk_p, dv_p) = fa.flash_dkv_cuda(*args), fa.flash_dkv_plain(*args)
    kv = lambda x: [x[b, :, hk] for b, hk, _ in groups]
    res["flash_dkv"] = max(
        f64_gate(f"flash_dkv dk (bf16, {n} groups)", kv(dk_k), kv(dk_p), [w[1] for w in want]),
        f64_gate(f"flash_dkv dv (bf16, {n} groups)", kv(dv_k), kv(dv_p), [w[2] for w in want]))
    return res


def _sass(name):
    """The SASS of ``csrc/<name>.cu``'s library (``cuobjdump -sass``)."""
    from repro_torch.kernels import _build
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(_build.lib_path(name))],
                          capture_output=True, text=True, check=True, timeout=300).stdout


def sass_hgmma(name):
    """{kernel symbol: HGMMA (wgmma) instructions} in the SASS of
    ``csrc/<name>.cu``'s library."""
    hgmma, sym = {}, None
    for line in _sass(name).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            sym = m.group(1)
            hgmma[sym] = 0
        elif sym and "HGMMA" in line:
            hgmma[sym] += 1
    for sym, n in hgmma.items():
        print(f"{name} sass: {sym}: {n} HGMMA")
    return hgmma


def check_wgmma_sass(fa):
    """Fail unless the wgmma route's K9, K10 and K11 hold HGMMA
    instructions at every head dim they take."""
    hgmma = sass_hgmma("flash_attention_sm90")
    for name in FLASH_PASSES:
        for d in fa.WGMMA_HEAD_DIMS:
            n = [v for sym, v in hgmma.items() if f"{name}_sm90ILi{d}E" in sym]
            if not n or not all(n):
                raise AssertionError(f"{name}_sm90 (d={d}): no HGMMA in its SASS")


@contextlib.contextmanager
def tf32_route(mod):
    """Inside the block every launch of kernel module ``mod`` (flash
    attention or K12) takes the ``"tf32"`` route (``csrc/flash_attention.cu``
    or ``csrc/grouped_matmul.cu``, the bfloat16 kernels as they were before
    the wgmma route): the yardstick of the bfloat16 rows' ``tf32_route_ms``,
    timed on the same inputs."""
    saved = mod.route
    mod.route = lambda *args: "tf32"
    try:
        yield
    finally:
        mod.route = saved


def sass_hmma(name):
    """{kernel symbol: [TF32 HMMA, all HMMA]} in the SASS of ``csrc/<name>.cu``'s
    library (``cuobjdump -sass``)."""
    hmma, sym = {}, None
    for line in _sass(name).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            sym = m.group(1)
            hmma[sym] = [0, 0]
        elif sym and "HMMA" in line:
            hmma[sym][0] += "TF32" in line
            hmma[sym][1] += 1
    for sym, (tf, n) in hmma.items():
        if n:
            print(f"{name} sass: {sym}: {tf} TF32 HMMA of {n} HMMA")
    return hmma


def sdpa_calls(q, k, v, do, causal):
    """``scaled_dot_product_attention``'s forward and its backward (dq, dk,
    dv together) on (B, H, S, d) views of the same inputs, grouped-query
    through ``enable_gqa``, as calls to time; used nowhere in the port."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                 enable_gqa=True)
    o = fwd()
    bwd = lambda: torch.autograd.grad(o, (qt, kt, vt), do.transpose(1, 2),
                                      retain_graph=True)
    return fwd, bwd


def check_flash_modes(gen):
    """K9-K11 on small inputs: non-causal, windows, MQA, G = 4, sequences
    that are not multiples of the tile, Sq != Sk, head dims 16 / 64 / 256;
    bfloat16 at head_dim 16 and 32 (the tf32 route: causal, windows, G = 3,
    Sq != Sk), at 256 (the wgmma route: S 100 and 160, Sq < Sk, Sq > Sk,
    windows, G = 3, MQA, non-causal; each also for the same bits and
    against float64 over every group) and at 64 and 128 (the wgmma route:
    non-causal, windows 8 and 256, MQA, G = 3, S = 100, Sq < Sk, Sq > Sk;
    d 64 non-causal at S 100 and 1500 and causal at S 448, whisper-base's).
    Each case asserts the route its three passes launched on."""
    bf = torch.bfloat16
    f32 = (
        ((2, 64, 64, 4, 2, 64), dict(causal=False), "(non-causal)"),
        ((1, 64, 64, 2, 2, 16), dict(window=8), "(window 8)"),
        ((1, 64, 64, 2, 2, 16), dict(window=16), "(window 16)"),
        ((1, 64, 64, 2, 2, 32), dict(causal=False, window=8), "(non-causal window 8)"),
        ((1, 1024, 1024, 4, 2, 128), dict(window=256), "(window 256)"),
        ((2, 128, 128, 4, 1, 64), {}, "(MQA)"),
        ((1, 256, 256, 8, 2, 128), {}, "(G=4)"),
        ((1, 192, 192, 6, 2, 128), {}, "(G=3, mixtral's group)"),
        ((1, 100, 100, 9, 3, 64), dict(window=40), "(G=3 window)"),
        ((1, 48, 48, 4, 2, 64), {}, "(S=48)"),
        ((2, 100, 100, 4, 2, 128), {}, "(S=100)"),
        ((1, 80, 144, 4, 2, 64), {}, "(Sq < Sk)"),
        ((1, 144, 80, 4, 2, 64), {}, "(Sq > Sk)"),
        ((1, 96, 96, 4, 2, 16), {}, "(d=16)"),
        ((1, 160, 160, 4, 2, 256), {}, "(d=256)"))
    # bfloat16 at the head dims the wgmma route does not take
    bf_tf32 = (
        ((2, 96, 96, 4, 2, 16), {}, "(bf16 d=16)"),
        ((1, 64, 64, 2, 2, 16), dict(window=8), "(bf16 d=16 window 8)"),
        ((1, 80, 144, 4, 2, 16), {}, "(bf16 d=16 Sq < Sk)"),
        ((1, 192, 192, 6, 2, 32), {}, "(bf16 d=32 G=3)"),
        ((1, 64, 64, 2, 2, 32), dict(causal=False, window=8), "(bf16 d=32 non-causal window 8)"),
        ((1, 144, 80, 4, 2, 32), {}, "(bf16 d=32 Sq > Sk)"))
    # bfloat16 at d 256 (gemma-2b's head_dim), each case also for the same
    # bits and against float64 over every (batch, kv head) group
    bf_d256 = (
        ((1, 160, 160, 4, 2, 256), {}, "(bf16 d=256 S=160)"),
        ((2, 100, 100, 4, 2, 256), {}, "(bf16 d=256 S=100)"),
        ((1, 80, 144, 4, 2, 256), {}, "(bf16 d=256 Sq < Sk)"),
        ((1, 144, 80, 4, 2, 256), {}, "(bf16 d=256 Sq > Sk)"),
        ((1, 200, 200, 4, 2, 256), dict(window=64), "(bf16 d=256 window 64)"),
        ((2, 100, 100, 6, 2, 256), dict(window=40), "(bf16 d=256 G=3 S=100 window 40)"),
        ((1, 192, 192, 6, 2, 256), {}, "(bf16 d=256 G=3)"),
        ((2, 128, 128, 4, 2, 256), dict(causal=False), "(bf16 d=256 non-causal)"),
        ((1, 144, 80, 4, 1, 256), dict(causal=False), "(bf16 d=256 MQA non-causal Sq > Sk)"))
    # bfloat16 at d 64 and 128 (the wgmma route)
    bf_wgmma = (
        ((2, 128, 128, 4, 2, 128), {}, "(bf16)"),
        ((1, 100, 100, 4, 2, 64), dict(window=32), "(bf16 window)"),
        ((2, 64, 64, 4, 2, 128), dict(causal=False), "(bf16 d=128 non-causal)"),
        ((1, 64, 64, 2, 2, 128), dict(window=8), "(bf16 d=128 window 8)"),
        ((1, 1024, 1024, 4, 2, 128), dict(window=256), "(bf16 d=128 window 256)"),
        ((2, 128, 128, 4, 1, 128), {}, "(bf16 d=128 MQA)"),
        ((1, 192, 192, 6, 2, 128), {}, "(bf16 d=128 G=3)"),
        ((2, 100, 100, 4, 2, 128), {}, "(bf16 d=128 S=100)"),
        ((1, 80, 144, 4, 2, 128), {}, "(bf16 d=128 Sq < Sk)"),
        ((1, 144, 80, 4, 2, 128), {}, "(bf16 d=128 Sq > Sk)"),
        # whisper-base's: the encoder non-causal over sequences that are no
        # multiple of the tile, the decoder causal over its 448 tokens
        ((1, 100, 100, 4, 2, 64), dict(causal=False), "(bf16 d=64 non-causal S=100)"),
        ((1, 1500, 1500, 2, 2, 64), dict(causal=False), "(bf16 d=64 non-causal S=1500)"),
        ((1, 448, 448, 4, 2, 64), {}, "(bf16 d=64 causal S=448)"))
    for cases, dtype, want in ((f32, torch.float32, "tf32"), (bf_tf32, bf, "tf32"),
                               (bf_d256, bf, "wgmma"), (bf_wgmma, bf, "wgmma")):
        for args, kw, tag in cases:
            check_flash(gen, *args, tag=tag, dtype=dtype, want_route=want,
                        gates=cases is bf_d256, **kw)


def nmt_small_batch(cfg, dev):
    from repro_torch.data import synthetic
    d = synthetic.nmt_pairs(4, cfg.src_vocab, cfg.tgt_vocab, max_len=10, seed=1)
    return {k: torch.from_numpy(v).to(dev) for k, v in d.items()}


def ner_small_batches():
    """The bilstm-ner smoke config's small batches on the CPU: "masked"
    (``ner_examples``' all-true mask) and "ragged" (lengths 8, 3, 5, 1, the
    masks derived from them)."""
    from repro_torch import configs
    from repro_torch.data import synthetic
    cfg = configs.get_arch(NER).smoke()
    d = {k: torch.from_numpy(v) for k, v in synthetic.ner_examples(
        4, cfg.vocab, cfg.char_vocab, cfg.num_tags, seq=8, seed=1).items()}
    ragged = {k: v for k, v in d.items() if k != "mask"}
    ragged["lengths"] = torch.tensor([8, 3, 5, 1], dtype=torch.int32)
    return {"masked": d, "ragged": ragged}


def check_engines_small(arch=LM):
    """On a small input, the kernel engines (fused, scheduled under
    :pallas) agree with the plain stepwise oracle (:xla) for loss and every
    gradient, on the card and against the CPU (1e-4 x max(1, |ref|)).
    xlstm's oracle runs in float64, with 1e-3 x max(1, |ref|): at this size
    its mLSTM cell amplifies float32 rounding to ~1e-4 of a gradient's
    largest entry, on the CPU and on the card alike. bilstm-ner runs a
    masked and a ragged batch."""
    from repro_torch import configs
    spec = configs.get_arch(arch)
    plan = {LM: "case3:0.5:bs8", NMT: "case3:0.3:bs8", XLSTM: "case3:0.5:bs4",
            NER: "case3:0.5:bs8"}[arch]
    g = torch.Generator().manual_seed(1)
    if arch == NER:
        batches = ner_small_batches()
    elif arch == NMT:
        batches = {"": nmt_small_batch(spec.smoke(), "cpu")}
    else:
        batches = {"": {"tokens": torch.randint(0, 128, (4, 8), generator=g),
                        "labels": torch.randint(0, 128, (4, 8), generator=g)}}
    for what, batch_cpu in batches.items():
        check_engines_batch(spec, arch, plan, batch_cpu, what)


def check_engines_batch(spec, arch, plan, batch_cpu, what):
    """``check_engines_small`` on one batch (``what`` names it)."""
    from repro_torch.configs import adapters
    from repro_torch.optim import value_and_grad
    from repro_torch.optim import tree_leaves
    f64 = arch == XLSTM
    oracle, tol = (("stepwise/xla/cpu/float64", 1e-3) if f64
                   else ("stepwise/xla/cpu", 1e-4))
    results = {}
    for name, engine, impl, dev in ((oracle, "stepwise", "xla", "cpu"),
                                    ("stepwise/xla/cuda", "stepwise", "xla", "cuda"),
                                    ("scheduled/pallas/cuda", "scheduled", "pallas", "cuda"),
                                    ("fused/pallas/cuda", "fused", "pallas", "cuda")):
        cfg = adapters.apply_engine(spec, adapters.apply_dropout(
            spec, spec.smoke(), f"{plan}:{impl}"), engine)
        if name.endswith("float64"):
            cfg = dataclasses.replace(cfg, param_dtype=torch.float64,
                                      compute_dtype=torch.float64)
        params = adapters.init_params(spec.kind, torch.Generator().manual_seed(0),
                                      cfg, device=dev)
        if arch == XLSTM:
            # the mLSTM causal conv is zero at init, which makes every mLSTM
            # cell output 0: perturb it so that the check covers the cell
            pg = torch.Generator().manual_seed(2)
            for leaf in ("conv_w", "conv_b"):
                shape = params["mlstm"][leaf].shape
                params["mlstm"][leaf] = (torch.randn(shape, generator=pg) * 0.1).to(
                    device=dev, dtype=cfg.param_dtype)
        batch = {k: v.to(dev) for k, v in batch_cpu.items()}
        lfn = value_and_grad(lambda p, b, **kw: adapters.loss_fn(spec.kind)(p, b, cfg, **kw))
        loss, grads = lfn(params, batch, seed=7, step=3)
        results[name] = [loss.cpu()] + [g.cpu() for g in tree_leaves(grads)]
    print(f"engines on a small input ({arch} smoke, {plan}{', ' + what if what else ''})")
    ref = results[oracle]
    for name, got in results.items():
        if name != oracle:
            compare(f"  {name} vs {oracle} (loss + grads)", got, ref, tol)


MAIN_PATHS = (
    # arch, batch, seq, plan, full-width cfg check
    (LM, B, T, "case3:0.5:pallas",
     lambda c: (c.vocab, c.embed, c.hidden, c.num_layers) == (10000, 650, 650, 2)),
    (NMT, NB, NT_, "case3:0.3:pallas",
     lambda c: (c.src_vocab, c.tgt_vocab, c.embed, c.hidden, c.num_layers)
     == (50000, 50000, 512, 512, 2)),
    # Ma & Hovy 2016: word embed 100, 30 char filters of width 3 over 30-dim
    # char embeddings (char vocab 100), BiLSTM 2 x 200, 9 tags; batch 32
    # (benchmarks/table3_ner.py), sentences of 64 words of 12 chars
    (NER, EB, ES, "case3:0.5:pallas",
     lambda c: (c.vocab, c.char_vocab, c.char_embed, c.char_filters,
                c.char_kernel, c.word_embed, c.hidden, c.num_tags)
     == (20000, 100, 30, 30, 3, 100, 200, 9)),
)

_K2 = ("gather_matmul_stepped/fp", "gather_matmul_stepped/bp")
_K1 = ("gather_matmul/fp", "gather_matmul/bp")
_K34 = ("lstm_scan_fwd", "lstm_scan_bwd")
# the kernels each path's run must launch: the tagger has no NR site, so its
# Phase-A product is a dense one (no K2)
NEED = {LM: {"fused": _K2 + _K34, "scheduled": _K1 + _K2},
        NMT: {"fused": _K2 + _K34 + ("decoder_scan_fwd", "decoder_scan_bwd"),
              "scheduled": _K1 + _K2},
        NER: {"fused": _K34, "scheduled": _K1}}
# launches per training step, as the code implies, and no other kernel's
# (asserted): luong-nmt fused launches K7 and K8 once, K3/K4 once per
# encoder layer, K2 FP/BP for both encoder layers and the decoder's hoisted
# layer-0 NR; bilstm-ner fused K3/K4 once per direction, scheduled K1 FP/BP
# once per step and direction
EXPECT = {(NMT, "fused"): {"decoder_scan_fwd": 1, "decoder_scan_bwd": 1,
                           "lstm_scan_fwd": 2, "lstm_scan_bwd": 2,
                           "gather_matmul_stepped/fp": 3,
                           "gather_matmul_stepped/bp": 3},
          (NER, "fused"): {"lstm_scan_fwd": 2, "lstm_scan_bwd": 2},
          (NER, "scheduled"): {"gather_matmul/fp": 2 * ES,
                               "gather_matmul/bp": 2 * ES}}


def _counters():
    """Every kernel wrapper's launch counts (one dict per module)."""
    from repro_torch.kernels import decoder_scan as dsk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gather_matmul as gm
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import lstm_pointwise as k5
    from repro_torch.kernels import lstm_scan as ls
    from repro_torch.kernels import slstm_scan as ss
    return (gm.LAUNCHES, ls.LAUNCHES, dsk.LAUNCHES, ss.LAUNCHES, fa.LAUNCHES,
            fa.LAUNCHES_BY_ROUTE, gmm.LAUNCHES, gmm.LAUNCHES_BY_ROUTE,
            gmm.LAUNCHES_BY_SHAPE, k5.LAUNCHES)


def reset_counts():
    for d in _counters():
        for key in d:
            d[key] = 0


def read_counts():
    return {k_: v for d in _counters() for k_, v in d.items()}


def drive_main_path():
    """Each path's training step at full width with both engines; returns
    {arch: {engine: {counter: launches}}}, {"arch/engine": [ms]},
    {"arch/engine": peak bytes}."""
    from repro_torch.launch import train

    totals, step_ms, peak = {}, {}, {}
    for arch, batch, seq, plan, full_width in MAIN_PATHS:
        for engine in ("fused", "scheduled"):
            print(f"main path: {arch}, batch {batch}, seq {seq}, {plan}, "
                  f"engine {engine}, {STEPS} steps")
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            res = train.run(["--arch", arch, "--batch", str(batch),
                             "--seq", str(seq), "--dropout", plan,
                             "--engine", engine, "--steps", str(STEPS),
                             "--seed", "0"])
            c = read_counts()
            peak[f"{arch}/{engine}"] = torch.cuda.max_memory_allocated()
            assert full_width(res["cfg"]), res["cfg"]
            assert len(res["losses"]) == STEPS
            assert all(math.isfinite(x) for x in res["losses"]), res["losses"]
            assert all(torch.isfinite(p).all() for p in _leaves(res["params"]))
            missing = [key for key in NEED[arch][engine] if c[key] == 0]
            assert not missing, f"{arch}/{engine}: kernels never launched: {missing}"
            print(f"  launches per step ({arch}/{engine}): "
                  + ", ".join(f"{k_}={v / STEPS:g}" for k_, v in c.items() if v))
            want = EXPECT.get((arch, engine))
            if want is not None:
                off = {k_: (v / STEPS, want.get(k_, 0)) for k_, v in c.items()
                       if v != want.get(k_, 0) * STEPS}
                print(f"  {arch} {engine} launches per step "
                      + ("as expected" if not off else f"differ from the expected: {off}"))
                assert not off, off
            totals.setdefault(arch, {})[engine] = c
            step_ms[f"{arch}/{engine}"] = res["ms"]
            print(f"  peak memory {peak[f'{arch}/{engine}']} bytes, steady median "
                  f"{steady_median(res['ms']):.2f} ms/step")
            del res         # its tensors would count in the next run's peak
    return totals, step_ms, peak


def check_viterbi():
    """``viterbi_decode`` of the same emissions on the card and on the CPU
    gives the same paths: random emissions, integer ones whose scores tie
    (the first maximal index wins on both), and the emissions of the
    full-width bilstm-ner model at init on one of its batches."""
    from repro_torch import configs
    from repro_torch.configs import adapters
    from repro_torch.data import synthetic
    from repro_torch.models import tagger
    g = torch.Generator().manual_seed(3)
    cfg = configs.get_arch(NER).full()
    params = adapters.init_params("tagger", torch.Generator().manual_seed(0), cfg,
                                  device="cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic.ner_examples(
        EB, cfg.vocab, cfg.char_vocab, cfg.num_tags, seq=ES, seed=5).items()}
    with torch.no_grad():
        model_emit = tagger.emissions(params, batch, cfg).cpu()
    cases = (("normal", torch.randn(EB, ES, 9, generator=g) * 2,
              torch.randn(9, 9, generator=g)),
             ("integer, tied", torch.randint(-2, 3, (EB, ES, 9), generator=g).float(),
              torch.randint(-1, 2, (9, 9), generator=g).float()),
             ("model at init", model_emit, params["crf"].cpu()))
    print(f"viterbi on the card and the CPU, B={EB} S={ES} 9 tags")
    for what, emit, trans in cases:
        cpu = tagger.viterbi_decode(emit, trans)
        card = tagger.viterbi_decode(emit.cuda(), trans.cuda()).cpu()
        same = torch.equal(cpu, card)
        print(f"  {what}: paths equal {same}")
        if not same:
            raise AssertionError(f"viterbi ({what}) differs between the card "
                                 f"and the CPU")


def time_crf():
    """CUDA-event ms of the CRF's loss terms (``crf_log_norm`` - ``crf_score``,
    mean) and their backward at the bilstm-ner main path's (B, S, tags)."""
    from repro_torch.models import tagger
    g = torch.Generator().manual_seed(4)
    emit = torch.randn(EB, ES, 9, generator=g).cuda().requires_grad_(True)
    trans = torch.randn(9, 9, generator=g).cuda().requires_grad_(True)
    tags = torch.randint(0, 9, (EB, ES), generator=g).cuda()
    mask = torch.ones(EB, ES, dtype=torch.bool, device="cuda")

    def fwd_bwd():
        loss = (tagger.crf_log_norm(emit, trans, mask)
                - tagger.crf_score(emit, tags, trans, mask)).mean()
        torch.autograd.grad(loss, (emit, trans))
    return time_ms(fwd_bwd, reps=10, warmup=2)


def check_resume():
    """bilstm-ner fused at full width: 4 steps straight, against 2 steps
    with a checkpoint at the end and a ``--resume auto`` run of 2 more into
    fresh tensors: the same losses and final parameters, bit for bit."""
    import tempfile
    from repro_torch.launch import train
    args = ["--arch", NER, "--batch", str(EB), "--seq", str(ES), "--dropout",
            "case3:0.5:pallas", "--engine", "fused", "--seed", "0"]
    print("resume: bilstm-ner fused, 4 steps straight against 2 + checkpoint "
          "+ 2 resumed")
    straight = train.run(args + ["--steps", "4"])
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".resume_ckpt_") as d:
        first = train.run(args + ["--steps", "2", "--ckpt-dir", d])
        resumed = train.run(args + ["--steps", "4", "--ckpt-dir", d,
                                    "--resume", "auto"])
    losses = first["losses"] + resumed["losses"]
    same_loss = resumed["start"] == 2 and losses == straight["losses"]
    same_params = all(torch.equal(a, b) for a, b in zip(
        _leaves(resumed["params"]), _leaves(straight["params"])))
    print(f"  losses straight {straight['losses']}, resumed {losses}: equal "
          f"{same_loss}; final parameters bit-equal {same_params}")
    if not (same_loss and same_params):
        raise AssertionError("the resumed run differs from the straight one")


def peak_check(what, peak):
    """Fail unless the measured peak leaves FREE_BYTES of the card free."""
    total = torch.cuda.get_device_properties(0).total_memory
    free = total - peak
    print(f"  {what}: peak {peak} bytes ({peak / 2**30:.2f} GiB) of {total} "
          f"({total / 2**30:.2f} GiB): {free / 1e9:.2f} GB free (limit "
          f"{FREE_BYTES / 1e9:g} GB)")
    assert free >= FREE_BYTES, f"{what}: only {free / 1e9:.2f} GB free"


def traced_step(what, step_fn, params, state, batch_fn):
    """One more training step under ``torch.profiler``: the step's
    device-time split (``launch/profile.py trace_steps``). The profiler
    has been seen to lose every kernel record of a run on the card: such a
    step is traced again, on the next batch, up to three times, and then the
    split is reported as not measured (it is a measurement, not a check).
    The batch is drawn before the trace, so its draw is no part of the
    split."""
    from repro_torch.launch.profile import NoDeviceTime, trace_steps
    for attempt in range(3):
        batch = batch_fn(STEPS + attempt)    # drawn before the trace starts
        try:
            return trace_steps(step_fn, params, state, lambda s, b=batch: b, 1, 0,
                               top=8, label=f"  {what} traced step")
        except NoDeviceTime:
            print(f"  {what} traced step: the profiler recorded no device "
                  f"time (attempt {attempt + 1} of 3)")
    return params, state, {"engine": f"  {what} traced step", "busy_ms": None,
                           "not_measured": "the profiler recorded no device "
                                           "time in 3 traced steps"}


def drive_xlstm():
    """xlstm-1.3b at full width in its config's bfloat16 (float32 states
    and moments), batch XB x XT, its own plan (nr p=0.25 bs 128, rh p=0.25
    bs 64) with impl="pallas", STEPS training steps per engine through
    ``steps.make_train_step`` with the trainer's batches: the fused engine
    (K6 on the RH site: its bfloat16 instantiation) cut to X_LAYERS blocks,
    then one traced step; the scheduled engine (the config's default: the
    sLSTM cell a step at a time in plain PyTorch, no K6) cut to XS_LAYERS
    blocks, one sLSTM block, as its host-bound step loop is ~4 s an sLSTM
    block. Returns {engine: counts}, {engine: [ms]}, {engine: peak bytes},
    each run's losses and {"fused": device-time split}."""
    from repro_torch import configs
    from repro_torch.configs import adapters
    from repro_torch.core.dropout_plan import DropoutPlan
    from repro_torch.launch import steps, train

    spec = configs.get_arch(XLSTM)
    dev = torch.device("cuda")
    k6 = ("slstm_scan_fwd", "slstm_scan_bwd", "slstm_wg")
    totals, step_ms, peak, losses, split = {}, {}, {}, {}, {}
    for engine, layers in (("fused", X_LAYERS), ("scheduled", XS_LAYERS)):
        base = spec.full(num_layers=layers)
        plan = DropoutPlan({n: sp.with_(impl="pallas") for n, sp in base.plan.sites})
        cfg = dataclasses.replace(base, plan=plan, engine=engine)
        assert (cfg.d_model, cfg.n_heads, cfg.dh_s, cfg.inner, cfg.vocab,
                cfg.conv_kernel, cfg.chunk, cfg.slstm_every, cfg.param_dtype,
                cfg.compute_dtype) == (2048, 4, 512, 4096, 50304, 4, 256, 8,
                                       torch.bfloat16, torch.bfloat16), cfg
        print(f"main path: {XLSTM}, {layers} of 48 blocks, bfloat16, batch {XB}, "
              f"seq {XT}, plan {cfg.plan.to_dict()}, engine {engine}, {STEPS} steps")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = adapters.init_params(
            spec.kind, torch.Generator(device="cuda").manual_seed(0), cfg,
            device=dev)
        opt = steps.default_opt(1e-3)
        state = opt.init(params)
        step_fn = steps.make_train_step(spec, cfg, opt)
        batch_fn = train.make_batch_fn(spec.kind, cfg, XB, XT, 0, dev)
        torch.cuda.synchronize()
        reset_counts()
        ms, ls_ = [], []
        for step in range(STEPS):
            t0 = time.perf_counter()
            params, state, loss = step_fn(params, state, batch_fn(step), step, 0)
            ls_.append(float(loss))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            print(f"  step {step}: loss {ls_[-1]:.4f}  {ms[-1]:.1f} ms")
        c = read_counts()
        assert all(math.isfinite(x) for x in ls_), ls_
        assert all(torch.isfinite(p).all() for p in _leaves(params))
        assert all(p.dtype == torch.bfloat16 for p in _leaves(params))
        if engine == "fused":
            # one sLSTM block in every slstm_every: a K6 forward and
            # backward (scan + WG) a block and step
            n_s = layers // cfg.slstm_every
            want = {k_: n_s * STEPS for k_ in k6}
        else:
            want = {k_: 0 for k_ in k6}
        assert {k_: c[k_] for k_ in k6} == want, (engine, c, want)
        peak[engine] = torch.cuda.max_memory_allocated()
        print(f"  launches per step ({XLSTM}/{engine}): "
              + (", ".join(f"{k_}={v / STEPS:g}" for k_, v in c.items() if v)
                 or "none of the port's kernels"))
        peak_check(f"{XLSTM}/{engine}", peak[engine])
        totals[engine], step_ms[engine], losses[engine] = c, ms, ls_
        if engine == "fused":
            params, state, split[engine] = traced_step(f"{XLSTM}/{engine}", step_fn,
                                                       params, state, batch_fn)
        del params, state
    return totals, step_ms, peak, losses, split


def check_qwen_small():
    """On a small input, the qwen3 smoke config with ``attn_impl="flash"``
    (K9-K11) against ``attn_impl="xla"`` (the port's chunked attention) on
    the card, and both against the xla run on the CPU: loss and every
    gradient within 1e-4 x max(1, |ref|)."""
    from repro_torch import configs
    from repro_torch.configs import adapters
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.optim import value_and_grad
    from repro_torch.optim import tree_leaves
    spec = configs.get_arch(QWEN)
    g = torch.Generator().manual_seed(1)
    batch_cpu = {"tokens": torch.randint(0, 128, (2, 24), generator=g),
                 "labels": torch.randint(0, 128, (2, 24), generator=g)}
    results = {}
    for impl, dev in (("xla", "cpu"), ("xla", "cuda"), ("flash", "cuda")):
        cfg = spec.smoke(attn_impl=impl)
        params = adapters.init_params(spec.kind, torch.Generator().manual_seed(0),
                                      cfg, device=dev)
        batch = {k_: v.to(dev) for k_, v in batch_cpu.items()}
        lfn = value_and_grad(lambda p, b, **kw: adapters.loss_fn(spec.kind)(p, b, cfg, **kw))
        before = dict(fa.LAUNCHES)
        loss, grads = lfn(params, batch, seed=7, step=3)
        launched = {k_: fa.LAUNCHES[k_] - before[k_] for k_ in before}
        want = cfg.num_layers if impl == "flash" and dev == "cuda" else 0
        # with remat="full" each layer's forward runs twice (K9 x 2)
        assert launched == {"flash_fwd": 2 * want, "flash_dq": want,
                            "flash_dkv": want}, launched
        results[f"{impl}/{dev}"] = [loss.cpu()] + [x.cpu() for x in tree_leaves(grads)]
    print("qwen3 smoke on a small input (attn_impl flash vs xla)")
    compare("  flash/cuda vs xla/cuda (loss + grads)", results["flash/cuda"],
            results["xla/cuda"], 1e-4)
    for name in ("xla/cuda", "flash/cuda"):
        compare(f"  {name} vs xla/cpu (loss + grads)", results[name],
                results["xla/cpu"], 1e-4)


def check_bf16_small(dev="cuda"):
    """On small inputs, the bfloat16 step of each of the three configs that
    train in bfloat16 (parameters and compute bfloat16, as their full()),
    against a float64 run of the same function on the CPU (the same
    parameters, rounded to bfloat16, then widened; router in float64):
    loss and every gradient within BF16_TOL x max(1, |ref|), and each
    config's two routes within BF16_TOL of each other. xlstm smoke with the
    fused engine and its RH site on K6 (``:pallas``) and with the scheduled
    engine (the sLSTM step in plain PyTorch, no K6), from the reference's
    init: its zero mLSTM conv leaves the mLSTM cells silent and the check
    on the sLSTM blocks (with the conv perturbed as in
    ``check_engines_small`` the smoke mLSTM amplifies rounding ~1000x, and
    bfloat16 gradients, the reference's included, land up to 4x their
    largest entry off float64); qwen3 smoke with ``attn_impl`` "flash"
    (K9-K11) and "xla"; mixtral smoke with flash attention and
    ``moe_impl`` "pallas" (K12) and "xla", its matrices drawn at std
    fan_in ** -0.5 and its embedding at std 1 (``_fan_in_init``): the
    reference's init draws a stacked leaf at (layer count) ** -0.5, std
    0.71 at two layers, and its expert FFNs then take the residual from rms
    0.02 to ~160 in one layer, so the smoke step amplifies rounding ~1700x
    and bfloat16 gradients land 40-110% of their largest entry off float64,
    the reference's own bfloat16 run's too
    (tests/test_torch_bf16_models.py); with the matrices alone rescaled the
    embedding's gradient, 50x through the first norm, still lands ~3e-2
    off. qwen3 and mixtral run at head_dim 64 (their smoke configs' own is
    16), so that every bfloat16 K9-K12 launch takes the wgmma route
    (asserted, none on tf32). ``dev="cpu"``
    runs the bfloat16 steps on the CPU (the kernels' plain versions)."""
    from repro_torch import configs
    from repro_torch.configs import adapters
    from repro_torch.optim import tree_leaves, tree_map, value_and_grad
    bf, f64 = torch.bfloat16, torch.float64
    g = torch.Generator().manual_seed(1)
    tok = lambda shape: {"tokens": torch.randint(0, 128, shape, generator=g),
                         "labels": torch.randint(0, 128, shape, generator=g)}
    k6 = ("slstm_scan_fwd", "slstm_scan_bwd", "slstm_wg")
    cases = {XLSTM: (tok((4, 8)), [("fused/pallas", dict(engine="fused")),
                                   ("scheduled", dict(engine="scheduled"))]),
             QWEN: (tok((2, 24)), [("flash", dict(attn_impl="flash")),
                                   ("xla", dict(attn_impl="xla"))]),
             MIXTRAL: (tok((2, 24)), [("pallas", dict(attn_impl="flash", moe_impl="pallas")),
                                      ("xla", dict(attn_impl="flash", moe_impl="xla"))])}
    # the transformers at head_dim 64, where bfloat16 K9-K11 take the
    # wgmma route (the smoke configs' own is 16); K12's widths 64 and 128
    # take it too, so no bfloat16 K9-K12 launch may take tf32
    wg = ("flash_fwd/wgmma", "flash_dq/wgmma", "flash_dkv/wgmma")
    need = {(XLSTM, "fused/pallas"): k6, (XLSTM, "scheduled"): (),
            (QWEN, "flash"): wg, (QWEN, "xla"): (),
            (MIXTRAL, "pallas"): (*wg, "grouped_matmul/wgmma"),
            (MIXTRAL, "xla"): ("flash_fwd/wgmma",)}
    tf32 = ("flash_fwd/tf32", "flash_dq/tf32", "flash_dkv/tf32", "grouped_matmul/tf32")
    for arch, (batch_cpu, routes) in cases.items():
        spec = configs.get_arch(arch)
        base = spec.smoke(param_dtype=bf, compute_dtype=bf,
                          **({} if arch == XLSTM else {"head_dim": 64}))
        if arch == XLSTM:
            base = adapters.apply_dropout(spec, base, "case3:0.5:bs4:pallas")
        params = adapters.init_params(spec.kind, torch.Generator().manual_seed(0), base)
        if arch == MIXTRAL:
            params = _fan_in_init(params, base.num_layers)
        wide = dict(param_dtype=f64, compute_dtype=f64)
        if base.__class__.__name__ == "TransformerConfig" and base.moe is not None:
            wide["moe"] = dataclasses.replace(base.moe, router_dtype=f64)
        runs = [("oracle", dataclasses.replace(
            base, **wide, **({"engine": "fused"} if arch == XLSTM else
                             {"attn_impl": "xla", "moe_impl": "xla"}
                             if arch == MIXTRAL else {"attn_impl": "xla"})),
                 tree_map(lambda p: p.double(), params), "cpu")]
        runs += [(name, dataclasses.replace(base, **kw), params, dev) for name, kw in routes]
        results = {}
        for name, cfg, p, d in runs:
            if name == "oracle" and arch == XLSTM:
                cfg = adapters.apply_dropout(spec, cfg, "case3:0.5:bs4:xla")
            pd = tree_map(lambda x: x.to(d), p)
            batch = {k_: v.to(d) for k_, v in batch_cpu.items()}
            lfn = value_and_grad(lambda q, b, **kw: adapters.loss_fn(spec.kind)(q, b, cfg, **kw))
            reset_counts()
            loss, grads = lfn(pd, batch, seed=7, step=3)
            c = read_counts()
            if d == "cuda" and name != "oracle":
                assert all(c.get(k_, 0) > 0 for k_ in need[arch, name]), (arch, name, c)
                assert not any(c.get(k_, 0) for k_ in tf32), (arch, name, c)
                if arch == XLSTM and name == "scheduled":
                    assert not any(c.get(k_, 0) for k_ in k6), (arch, name, c)
            assert all(x.dtype == (f64 if name == "oracle" else bf)
                       for x in tree_leaves(grads)), (arch, name)
            results[name] = [loss.cpu()] + [x.cpu() for x in tree_leaves(grads)]
        print(f"{arch} smoke in bfloat16 on a small input ({dev}), against float64")
        for name, _ in routes:
            compare(f"  {name}/{dev} vs float64 (loss + grads)", results[name],
                    results["oracle"], BF16_TOL)
        a, b = routes[0][0], routes[1][0]
        compare(f"  {a} vs {b}/{dev} (loss + grads)", results[a], results[b], BF16_TOL)


def _fan_in_init(params, num_layers,
                 keys=("wq", "wk", "wv", "wo", "router", "we_gate", "we_up"),
                 embed=True):
    """The transformer's block matrices ``keys`` redrawn at std fan_in **
    -0.5 in place of the reference's (layer count) ** -0.5, and (with
    ``embed``) the embedding at std 1 in place of 0.02 (a residual stream of
    rms 1, which the first norm does not amplify 50x): the same normal
    draws, rescaled in float32 and rounded to the leaf's dtype once."""
    blocks = dict(params["blocks"])
    for k_ in keys:
        w = blocks[k_]
        blocks[k_] = (w.float() * (num_layers ** 0.5 * w.shape[-2] ** -0.5)).to(w.dtype)
    out = {**params, "blocks": blocks}
    if embed:
        out["embed"] = (params["embed"].float() / 0.02).to(params["embed"].dtype)
    return out


def drive_transformer():
    """qwen3-8b at full width in its config's bfloat16, cut to Q_LAYERS
    layers, batch QB x QS, its own plan (nr p=0.25 block 128), remat "full":
    STEPS training steps through ``steps.make_train_step`` with the
    trainer's batches, with ``attn_impl="flash"`` (the main path: K9 twice
    a layer, forward and recompute, K10 and K11 once, all bfloat16
    instantiations) and then with ``attn_impl="xla"`` (the step's
    yardstick, no kernel), each followed by one traced step. Returns
    {impl: counts}, {impl: [ms]}, {impl: peak bytes}, {impl: device-time
    split}."""
    from repro_torch import configs
    from repro_torch.configs import adapters
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps, train

    spec = configs.get_arch(QWEN)
    dev = torch.device("cuda")
    totals, step_ms, peak, split = {}, {}, {}, {}
    for impl in ("flash", "xla"):
        cfg = spec.full(num_layers=Q_LAYERS, attn_impl=impl)
        assert (cfg.d_model, cfg.n_heads, cfg.n_kv_eff, cfg.hd, cfg.d_ff,
                cfg.vocab, cfg.remat, cfg.param_dtype, cfg.compute_dtype) == (
                    4096, QHQ, QHKV, QD, 12288, 151936, "full", torch.bfloat16,
                    torch.bfloat16), cfg
        print(f"main path: {QWEN}, {Q_LAYERS} of 36 layers, bfloat16, batch {QB}, "
              f"seq {QS}, plan {cfg.plan.to_dict()}, attn_impl {impl}, {STEPS} steps")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = adapters.init_params(
            spec.kind, torch.Generator(device="cuda").manual_seed(0), cfg,
            device=dev)
        opt = steps.default_opt(1e-3)
        state = opt.init(params)
        step_fn = steps.make_train_step(spec, cfg, opt)
        batch_fn = train.make_batch_fn(spec.kind, cfg, QB, QS, 0, dev)
        torch.cuda.synchronize()
        reset_counts()
        ms, ls_ = [], []
        for step in range(STEPS):
            t0 = time.perf_counter()
            params, state, loss = step_fn(params, state, batch_fn(step), step, 0)
            ls_.append(float(loss))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            print(f"  step {step}: loss {ls_[-1]:.4f}  {ms[-1]:.1f} ms")
        c = read_counts()
        assert all(math.isfinite(x) for x in ls_), ls_
        assert all(torch.isfinite(p).all() for p in _leaves(params))
        flash = {k_: c[k_] for k_ in fa.LAUNCHES}
        by_route = {k_: c[k_] for k_ in fa.LAUNCHES_BY_ROUTE}
        if impl == "flash":
            missing = [k_ for k_, v in flash.items() if v == 0]
            assert not missing, f"flash kernels never launched: {missing}"
            want = {"flash_fwd": 2 * Q_LAYERS * STEPS,
                    "flash_dq": Q_LAYERS * STEPS, "flash_dkv": Q_LAYERS * STEPS}
            print("  flash launches per step "
                  + ("as expected" if flash == want else
                     f"differ from the expected {want}: {flash}"))
            # every bfloat16 K9 and K11 of the step on the wgmma route
            assert by_route == wgmma_routes(flash), by_route
            print(f"  flash launches by route: {by_route}")
        else:
            assert not any(flash.values()), f"flash kernels launched under xla: {c}"
            assert not any(by_route.values()), by_route
        assert all(p.dtype == torch.bfloat16 for p in _leaves(params))
        peak[impl] = torch.cuda.max_memory_allocated()
        print(f"  launches per step ({QWEN}/{impl}): "
              + (", ".join(f"{k_}={v / STEPS:g}" for k_, v in c.items() if v)
                 or "none of the port's kernels"))
        peak_check(f"{QWEN}/{impl}", peak[impl])
        totals[impl], step_ms[impl] = c, ms
        params, state, split[impl] = traced_step(f"{QWEN}/{impl}", step_fn,
                                                 params, state, batch_fn)
        del params, state
    return totals, step_ms, peak, split


def check_grouped(out):
    """K12 against its plain version (one cuBLAS product per row block):
    at mixtral-8x22b's two expert-product shapes, cold L2, timed beside
    ``torch.bmm`` on the (E, C, .) buffer (the library yardstick), within
    1e-3 x max(1, |ref|), and over one row block by 256 columns against a
    float64 product on the card within 1e-5 (``torch.bmm``'s error printed
    beside it); the SASS's TF32 HMMA count per instantiation (none in the
    float32 kernel fails); then on small inputs: the reference test's four
    shapes in float32 and bfloat16 (3e-2), bm not a multiple of the 128-row
    tile, an empty expert, unsorted repeated ids and ragged T, D, F. The
    bound is the route's: three TF32 products a float32 product."""
    from repro_torch.kernels import grouped_matmul as gm
    hmma = sass_hmma("grouped_matmul")
    if not any(tf for k_, (tf, _) in hmma.items() if "grouped_mm_kernelIfLb1E" in k_):
        raise AssertionError("grouped_matmul: no TF32 HMMA in the float32 kernel's SASS")
    g = torch.Generator(device="cuda").manual_seed(12)
    T_ = ME * MC
    blk = torch.arange(ME, dtype=torch.int32, device="cuda")
    src = "src/repro_torch/csrc/grouped_matmul.cu"
    for tag, D_, F_ in (("gate/up", MD, MF), ("down", MF, MD)):
        x = torch.randn(T_, D_, device="cuda", generator=g)
        w = torch.randn(ME, D_, F_, device="cuda", generator=g) * D_ ** -0.5
        print(f"grouped_matmul ({MIXTRAL} {tag}): x ({T_}, {D_}) w ({ME}, {D_}, {F_}) "
              f"bm={MC}")
        fk = lambda: gm.grouped_matmul(x, w, blk, bm=MC)
        fp = lambda: gm.grouped_matmul_plain(x, w, blk, bm=MC)
        xb = x.view(ME, MC, D_)
        fl = lambda: torch.bmm(xb, w)
        got = fk()
        err = compare(f"  grouped_matmul ({tag})", got, fp(), 1e-3)
        # float32's accuracy: one row block (expert 0) by 256 columns
        ref = x[:MC].double() @ w[0, :, :256].double()
        lib_rel = ((fl()[0, :, :256].double() - ref).abs().max().item()
                   / max(1.0, ref.abs().max().item()))
        f64 = compare(f"  grouped_matmul ({tag}) vs float64, {MC} x 256", got[:MC, :256],
                      ref, 1e-5)
        f64_rel = f64 / max(1.0, ref.abs().max().item())
        print(f"  torch.bmm ({tag}) vs float64, {MC} x 256: max_rel_err {lib_rel:.3e} "
              f"(the yardstick's own)")
        del got, ref
        # once per expert product, after other work: timed with a cold L2
        ms = time_ms(fk, reps=10, warmup=2, cold_l2=True)
        pms = time_ms(fp, reps=10, warmup=2, cold_l2=True)
        lms = time_ms(fl, reps=10, warmup=2, cold_l2=True)
        nbytes = 4 * (T_ * D_ + ME * D_ * F_ + T_ * F_) + 4 * ME
        # operations: three TF32 products for each float32 product (3xTF32)
        ops = 3 * 2 * T_ * D_ * F_
        name = "grouped_matmul" if tag == "gate/up" else "grouped_matmul/down"
        # launches: this weight shape's, from the wrapper's per-shape count
        add_row(out, f"grouped_matmul/{D_}x{F_}", MIXTRAL, src,
                "src/repro/kernels/grouped_matmul.py:31", err, ms, pms, lms,
                nbytes, ops, "cold", name=name, rate=TF32_FLOPS,
                f64_rel_err=f64_rel, library_f64_rel_err=lib_rel)
        del x, w, xb
    # the same at the bfloat16 model's dtype: bfloat16 in and out, float32
    # sums; against a float64 product within 10 x the bfloat16 plain
    # version's distance + 1e-6; bound at the bfloat16 rate; on the wgmma
    # route (HGMMA in its SASS), timed in turns with the tf32 route
    hgmma = sass_hgmma("grouped_matmul_sm90")
    if not [n for k_, n in hgmma.items() if "grouped_mm_sm90" in k_ and n]:
        raise AssertionError("grouped_mm_sm90: no HGMMA in its SASS")
    for tag, D_, F_ in (("gate/up", MD, MF), ("down", MF, MD)):
        x = torch.randn(T_, D_, device="cuda", generator=g).bfloat16()
        w = (torch.randn(ME, D_, F_, device="cuda", generator=g) * D_ ** -0.5).bfloat16()
        print(f"grouped_matmul ({MIXTRAL} {tag}, bfloat16): x ({T_}, {D_}) "
              f"w ({ME}, {D_}, {F_}) bm={MC}")
        fk = lambda: gm.grouped_matmul(x, w, blk, bm=MC)
        fp = lambda: gm.grouped_matmul_plain(x, w, blk, bm=MC)
        xb = x.view(ME, MC, D_)
        fl = lambda: torch.bmm(xb, w)
        rt = gm.route(x.dtype, D_, F_)
        assert rt == "wgmma", rt
        got, plain = fk(), fp()
        assert got.dtype == torch.bfloat16, got.dtype
        err = compare(f"  grouped_matmul ({tag}, bf16)", got, plain, BF16_TOL)
        same_bits(f"grouped_matmul ({tag}, bf16) second launch", [got], lambda: [fk()])
        ref = x[:MC].double() @ w[0, :, :256].double()
        f64_rel = f64_gate(f"  grouped_matmul ({tag}, bf16), {MC} x 256",
                           [got[:MC, :256]], [plain[:MC, :256]], [ref])
        del got, plain, ref
        ms, prev = wgmma_vs_tf32(gm, fk, reps=10, warmup=2)
        pms = time_ms(fp, reps=10, warmup=2, cold_l2=True)
        lms = time_ms(fl, reps=10, warmup=2, cold_l2=True)
        nbytes = 2 * (T_ * D_ + ME * D_ * F_ + T_ * F_) + 4 * ME
        name = "grouped_matmul" if tag == "gate/up" else "grouped_matmul/down"
        add_row(out, f"grouped_matmul/{D_}x{F_}", MIXTRAL,
                "src/repro_torch/csrc/grouped_matmul_sm90.cu",
                "src/repro/kernels/grouped_matmul.py:31", err, ms, pms, lms,
                nbytes, 2 * T_ * D_ * F_, "cold", name=name + "/bf16",
                rate=BF16_FLOPS, f64_rel_err=f64_rel, dtype="bfloat16",
                kernel_route=rt, tf32_route_ms=prev)
        del x, w, xb
    torch.cuda.empty_cache()

    def small(T_, D_, F_, E_, bm, dtype=torch.float32, blk_=None, zero_rows=None,
              tag="", zero_out=None):
        gc_ = torch.Generator().manual_seed(T_ + D_)
        x = torch.randn(T_, D_, generator=gc_)
        if zero_rows is not None:
            x[zero_rows] = 0.0
        w = torch.randn(E_, D_, F_, generator=gc_) * D_ ** -0.5
        if blk_ is None:
            blk_ = torch.randint(0, E_, (-(-T_ // bm),), generator=gc_)
        args = (x.to("cuda", dtype), w.to("cuda", dtype),
                blk_.to(torch.int32).cuda())
        rt = gm.route(dtype, D_, F_)
        before = gm.LAUNCHES_BY_ROUTE[f"grouped_matmul/{rt}"]
        got = gm.grouped_matmul(*args, bm=bm)
        assert gm.LAUNCHES_BY_ROUTE[f"grouped_matmul/{rt}"] == before + 1, rt
        compare(f"  grouped_matmul T={T_} D={D_} F={F_} E={E_} bm={bm} {dtype} ({rt}) "
                f"{tag}", got, gm.grouped_matmul_plain(*args, bm=bm),
                1e-3 if dtype == torch.float32 else 3e-2)
        if zero_rows is not None and not (got[zero_rows] == 0).all():
            raise AssertionError("grouped_matmul: rows holding no token are not zero")
        if zero_out is not None and not (got[zero_out] == 0).all():
            raise AssertionError("grouped_matmul: rows of an out-of-range id are not zero")

    print("grouped_matmul small modes")
    for dtype in (torch.float32, torch.bfloat16):
        for T_, D_, F_, E_, bm in ((32, 16, 24, 4, 8), (64, 32, 32, 2, 16),
                                   (128, 64, 128, 8, 16), (24, 8, 8, 3, 8)):
            small(T_, D_, F_, E_, bm, dtype, tag="(test_grouped sweep)")
    small(600, 96, 160, 3, 200, tag="(bm not a multiple of the tile)")
    small(512, 64, 96, 4, 128, blk_=torch.tensor([0, 0, 2, 3]), zero_rows=slice(128, 256),
          tag="(empty expert 1; a block of zero rows)")
    small(384, 64, 64, 3, 32, blk_=torch.tensor([2, 0, 2, 2, 1, 0, 0, 1, 2, 1, 1, 0]),
          tag="(unsorted repeated ids)")
    small(257, 37, 61, 5, 23, tag="(T, D, F tails; scalar loads)")
    small(300, 100, 132, 3, 70, dtype=torch.bfloat16, tag="(bf16 tails)")
    # the wgmma route (bfloat16, D and F multiples of 8)
    bf = torch.bfloat16
    small(600, 96, 160, 3, 200, bf, tag="(bm not a multiple of the tile)")
    small(512, 64, 96, 4, 128, bf, blk_=torch.tensor([0, 0, 2, 3]),
          zero_rows=slice(128, 256), tag="(empty expert 1; a block of zero rows)")
    small(384, 64, 64, 3, 32, bf, blk_=torch.tensor([2, 0, 2, 2, 1, 0, 0, 1, 2, 1, 1, 0]),
          tag="(unsorted repeated ids)")
    small(300, 64, 160, 3, 100, bf, blk_=torch.tensor([0, 3, -1]), zero_out=slice(100, 300),
          tag="(ids 3 and -1 out of range)")
    small(257, 72, 200, 5, 23, bf, tag="(T, D, F tails, bm 23)")
    small(700, 136, 264, 4, 300, bf, tag="(D past two k-steps, F past one tile)")
    # the kernel against a float64 product on the host, independent of cuBLAS
    gc_ = torch.Generator().manual_seed(64)
    x = torch.randn(640, 256, generator=gc_)
    w = torch.randn(4, 256, 384, generator=gc_) * 256 ** -0.5
    ids = torch.tensor([3, 1, 1, 0, 2])
    want = torch.cat([x[i * 128:(i + 1) * 128].double() @ w[e].double()
                      for i, e in enumerate(ids.tolist())])
    compare("  grouped_matmul T=640 D=256 F=384 bm=128 vs float64",
            gm.grouped_matmul(x.cuda(), w.cuda(), ids.to(torch.int32).cuda(), bm=128),
            want, 1e-4)


def check_pointwise(out):
    """K5 against its plain version within 1e-5 x max(1, |ref|): at
    zaremba-medium's cell (B=20, H=650) and zaremba-large's (H=1500), with
    forget_bias 0 and 1, and on odd shapes; timed at (20, 650) with a warm
    L2 (in the scan, the gates were written just before), beside
    ``aten._thnn_fused_lstm_cell`` (the library's fused cell update, held to
    the plain version too), and its device time (``torch.profiler``) beside
    an empty kernel's on the same grid."""
    from repro_torch.kernels import lstm_pointwise as k5
    print("lstm_pointwise")
    g = torch.Generator().manual_seed(5)
    for B_, H_, fb in ((B, H, 0.0), (B, H, 1.0), (B, 1500, 0.0), (B, 1500, 1.0),
                       (7, 33, 1.0), (129, 517, 0.0)):
        gates = (torch.randn(B_, 4 * H_, generator=g) * 2).cuda()
        c = torch.randn(B_, H_, generator=g).cuda()
        fk = lambda: k5.lstm_pointwise(gates, c, forget_bias=fb)
        fp = lambda: k5.lstm_pointwise_plain(gates, c, forget_bias=fb)
        with torch.no_grad():
            err = compare(f"  lstm_pointwise B={B_} H={H_} forget_bias={fb:g}",
                          list(fk()), list(fp()), 1e-5)
            if (B_, H_, fb) == (B, H, 0.0):
                # the library yardstick: nn.LSTMCell's fused CUDA cell update,
                # same [i|f|g|o] order, forget_bias in the f slice of a bias;
                # its hidden gates are zeros (one more (B, 4H) read)
                zeros = torch.zeros_like(gates)
                bias = torch.zeros(4 * H_, device="cuda")
                bias[H_:2 * H_] = fb
                zb = torch.zeros_like(bias)
                cell = torch.ops.aten._thnn_fused_lstm_cell
                fl = lambda: cell(gates, zeros, c, bias, zb)[:2]
                compare(f"  aten._thnn_fused_lstm_cell B={B_} H={H_} (library)",
                        list(fl()), list(fp()), 1e-5)
                ms, pms = time_ms(fk, reps=50), time_ms(fp, reps=50)
                lms = time_ms(fl, reps=50)
                # K5's device time beside an empty kernel's on K5's grid,
                # launched the same way (ctypes, the current stream): the
                # device's launch floor under the CUDA-event time
                empty = empty_kernel(-(-B_ * H_ // 256), 256)
                dms, lost = device_ms(fk, reps=50)
                ems, elost = device_ms(empty, reps=50)
                est = {k_: v for k_, v in (("device_ms_estimated_from", lost),
                                           ("empty_device_ms_estimated_from", elost))
                       if v is not None}
                print(f"  lstm_pointwise device {dms:.4f} ms, empty kernel on its grid "
                      f"{ems:.4f} ms ({dms / ems:.2f}x); empty kernel's CUDA-event time "
                      f"{time_ms(empty, reps=50):.4f} ms")
                add_row(out, "lstm_pointwise", STACK,
                        "src/repro_torch/csrc/lstm_pointwise.cu",
                        "src/repro/kernels/lstm_pointwise.py:23", err, ms, pms,
                        lms, 4 * (B_ * 4 * H_ + B_ * H_ + 2 * B_ * H_),
                        16 * B_ * H_, "warm",   # ~16 float32 operations a unit
                        device_ms=dms, empty_kernel_device_ms=ems, **est)


EMPTY_SRC = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int grid, int block, void* stream) {
  empty_kernel<<<grid, block, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def empty_kernel(grid, block):
    """A callable that launches an empty kernel of ``grid`` x ``block``
    threads through ctypes on the current stream, as the port's wrappers
    launch theirs (built with the port's nvcc flags)."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.launch import scan_bench
    src = _build.build_dir() / "empty_probe.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(EMPTY_SRC)
    lib = scan_bench.compile_lib(src, "empty_probe")
    lib.empty_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int

    def run():
        code = lib.empty_launch(grid, block, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"empty kernel: CUDA error {code}")
    return run


def drive_lstm_stack():
    """The ``lstm_stack`` forward at zaremba-medium width (T=35, B=20,
    H=D=650, 2 layers, ``case3:0.5:pallas`` tables: K1 for the in-scan RH
    product, K2 for the hoisted NR one in the scheduled engine) under
    ``torch.no_grad()``, engines scheduled and stepwise, with
    ``pointwise_impl="pallas"`` (K5, the main path of this phase) and
    ``"xla"``: outputs and final states within 1e-5 x max(1, |ref|), and K5
    launched exactly 2 x 35 times a call. Returns {engine: counts} of the
    pallas calls."""
    from repro_torch.core import lstm as lstm_mod
    from repro_torch.core.dropout_plan import DropoutPlan
    g = torch.Generator().manual_seed(35)
    params = lstm_mod.init_lstm_params(g, D, H, 2, device="cuda")
    x = torch.randn(T, B, D, generator=g).cuda()
    state = lstm_mod.LSTMState(*(torch.randn(2, B, H, generator=g).cuda() * 0.3
                                 for _ in range(2)))
    plan = DropoutPlan.parse(f"case3:{P}:pallas", sites=("nr", "rh"))
    totals = {}
    print(f"lstm_stack forward: T={T} B={B} H=D={H} 2 layers, case3:{P}:pallas")
    for engine in ("scheduled", "stepwise"):
        res = {}
        for impl in ("pallas", "xla"):
            ctx = plan.bind(0, 3, device="cuda")
            torch.cuda.synchronize()
            reset_counts()
            with torch.no_grad():
                ys, fin = lstm_mod.lstm_stack(params, x, state, ctx=ctx, engine=engine,
                                              pointwise_impl=impl)
            torch.cuda.synchronize()
            c = read_counts()
            want = 2 * T if impl == "pallas" else 0
            assert c["lstm_pointwise"] == want, (engine, impl, c)
            if impl == "pallas":
                totals[engine] = c
            res[impl] = [ys, fin.h, fin.c]
        print(f"  {engine}: K5 launches per call {totals[engine]['lstm_pointwise']}")
        compare(f"  lstm_stack {engine} pallas vs xla (ys, h, c)", res["pallas"],
                res["xla"], 1e-5)
    return totals


def check_mixtral_small():
    """On a small input, the mixtral smoke config with ``attn_impl="flash"``
    and ``moe_impl="pallas"`` (K12, K9-K11) against ``moe_impl="xla"`` on
    the card: loss and every gradient within 1e-4 x max(1, |ref|). Both
    are also held to a float64 run of the xla route on the CPU (parameters,
    router and experts in float64; the chunked attention and the vocab head
    compute in float32 either way) within 1e-3 x max(1, |ref|), and a
    float32 CPU run is held to the same oracle and printed beside them: at
    this size the smoke config's experts amplify float32 rounding to ~2e-4
    of a gradient's largest entry, so float32 on the CPU sits as far from
    float64 as the card does, and 1e-4 against a float32 CPU run is not a
    limit that rounding alone keeps."""
    from repro_torch import configs
    from repro_torch.configs import adapters
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.optim import value_and_grad
    from repro_torch.optim import tree_leaves
    spec = configs.get_arch(MIXTRAL)
    g = torch.Generator().manual_seed(1)
    batch_cpu = {"tokens": torch.randint(0, 128, (2, 24), generator=g),
                 "labels": torch.randint(0, 128, (2, 24), generator=g)}
    results = {}
    oracle = "xla/cpu/float64"
    for impl, attn, dev, dt in (("xla", "xla", "cpu", torch.float64),
                                ("xla", "xla", "cpu", torch.float32),
                                ("xla", "flash", "cuda", torch.float32),
                                ("pallas", "flash", "cuda", torch.float32)):
        cfg = spec.smoke(attn_impl=attn, moe_impl=impl)
        if dt == torch.float64:
            cfg = dataclasses.replace(cfg, param_dtype=dt, compute_dtype=dt,
                                      moe=dataclasses.replace(cfg.moe, router_dtype=dt))
        params = adapters.init_params(spec.kind, torch.Generator().manual_seed(0),
                                      cfg, device=dev)
        batch = {k_: v.to(dev) for k_, v in batch_cpu.items()}
        lfn = value_and_grad(lambda p, b, **kw: adapters.loss_fn(spec.kind)(p, b, cfg, **kw))
        before = gmm.LAUNCHES["grouped_matmul"]
        loss, grads = lfn(params, batch, seed=7, step=3)
        launched = gmm.LAUNCHES["grouped_matmul"] - before
        # 3 expert products a layer, forward and recompute (remat "full")
        want = 6 * cfg.num_layers if impl == "pallas" else 0
        assert launched == want, (impl, launched)
        name = f"xla/cpu/{str(dt)[6:]}" if dev == "cpu" else f"{impl}/{dev}"
        results[name] = [loss.cpu()] + [x.cpu() for x in tree_leaves(grads)]
    print("mixtral smoke on a small input (moe_impl pallas vs xla, flash attention)")
    compare("  pallas/cuda vs xla/cuda (loss + grads)", results["pallas/cuda"],
            results["xla/cuda"], 1e-4)
    for name in ("xla/cpu/float32", "xla/cuda", "pallas/cuda"):
        compare(f"  {name} vs {oracle} (loss + grads)", results[name],
                results[oracle], 1e-3)


def drive_moe():
    """mixtral-8x22b at full width in its config's bfloat16, cut to
    M_LAYERS layers, batch MB x MS (train_4k's sequence), its own plan (nr
    p=0.25 block 128), remat "full", flash attention: STEPS training steps
    through ``steps.make_train_step`` with the trainer's batches, with
    ``moe_impl="pallas"`` (the main path: K12 six times a layer, three
    expert products forward and three in the recompute, bfloat16 in and
    out) and then with ``"xla"`` (``torch.matmul`` on the widened operands,
    the reference's float32 sums; the step's yardstick), each followed by
    one traced step. Returns {impl: counts}, {impl: [ms]}, {impl: peak
    bytes}, {impl: losses}, {impl: device-time split}."""
    from repro_torch import configs
    from repro_torch.configs import adapters
    from repro_torch.launch import steps, train
    spec = configs.get_arch(MIXTRAL)
    dev = torch.device("cuda")
    totals, step_ms, peak, losses, split = {}, {}, {}, {}, {}
    for impl in ("pallas", "xla"):
        cfg = spec.full(num_layers=M_LAYERS, attn_impl="flash", moe_impl=impl)
        assert (cfg.d_model, cfg.n_heads, cfg.n_kv_eff, cfg.hd, cfg.d_ff, cfg.vocab,
                cfg.moe.num_experts, cfg.moe.top_k, cfg.window, cfg.remat,
                cfg.param_dtype, cfg.compute_dtype) == (
                    MD, 48, 16, 128, MF, 32768, ME, MK, 4096, "full",
                    torch.bfloat16, torch.bfloat16), cfg
        print(f"main path: {MIXTRAL}, {M_LAYERS} of 56 layers, bfloat16, batch {MB}, "
              f"seq {MS}, plan {cfg.plan.to_dict()}, moe_impl {impl}, flash, "
              f"{STEPS} steps")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = adapters.init_params(
            spec.kind, torch.Generator(device="cuda").manual_seed(0), cfg, device=dev)
        n_params = sum(p.numel() for p in _leaves(params))
        opt = steps.default_opt(1e-3)
        state = opt.init(params)
        step_fn = steps.make_train_step(spec, cfg, opt)
        batch_fn = train.make_batch_fn(spec.kind, cfg, MB, MS, 0, dev)
        torch.cuda.synchronize()
        reset_counts()
        ms, ls_ = [], []
        for step in range(STEPS):
            t0 = time.perf_counter()
            params, state, loss = step_fn(params, state, batch_fn(step), step, 0)
            ls_.append(float(loss))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            print(f"  step {step}: loss {ls_[-1]:.4f}  {ms[-1]:.1f} ms")
        c = read_counts()
        assert all(math.isfinite(x) for x in ls_), ls_
        assert all(torch.isfinite(p).all() for p in _leaves(params))
        k12 = (M_LAYERS if impl == "pallas" else 0) * STEPS
        flash = {"flash_fwd": 2 * M_LAYERS * STEPS, "flash_dq": M_LAYERS * STEPS,
                 "flash_dkv": M_LAYERS * STEPS}
        # every bfloat16 K12 and K9-K11 of the step on the wgmma route
        want = {"grouped_matmul": 6 * k12, f"grouped_matmul/{MD}x{MF}": 4 * k12,
                f"grouped_matmul/{MF}x{MD}": 2 * k12, "grouped_matmul/wgmma": 6 * k12,
                "grouped_matmul/tf32": 0, **flash, **wgmma_routes(flash)}
        got = {k_: c.get(k_, 0) for k_ in want}
        assert got == want, f"{MIXTRAL}/{impl}: launches {got}, expected {want}"
        assert all(p.dtype == torch.bfloat16 for p in _leaves(params))
        peak[impl] = torch.cuda.max_memory_allocated()
        print(f"  {n_params} parameters; launches per step ({MIXTRAL}/{impl}): "
              + ", ".join(f"{k_}={v / STEPS:g}" for k_, v in c.items() if v))
        peak_check(f"{MIXTRAL}/{impl}", peak[impl])
        totals[impl], step_ms[impl], losses[impl] = c, ms, ls_
        params, state, split[impl] = traced_step(f"{MIXTRAL}/{impl}", step_fn,
                                                 params, state, batch_fn)
        del params, state
    # K12 rounds its sums into bfloat16 where the xla route keeps the
    # reference's float32 sums; at the loss ~1e-6 (9.6e-7 on an H100, 700 W)
    rel = abs(losses["pallas"][0] - losses["xla"][0]) / abs(losses["xla"][0])
    print(f"  step-0 loss pallas {losses['pallas'][0]:.6f} vs xla "
          f"{losses['xla'][0]:.6f}: relative difference {rel:.3e} (limit 1e-4)")
    assert rel <= 1e-4, rel
    return totals, step_ms, peak, losses, split


def flash_launches(cfg):
    """K9-K11 launches of STEPS flash training steps under remat "full"
    or "dots": K9 twice a decoder layer (its forward and the backward's
    recompute: the flash output is no saved product), K10 and K11 once; an
    encoder-decoder's encoder adds one K9 a layer and no backward, since,
    as in the reference, the decoder's cross-attention projects its keys
    and values from the decoder's own stream and the loss does not read the
    encoder."""
    L = cfg.num_layers
    enc = cfg.enc_layers if cfg.is_encoder_decoder else 0
    return {"flash_fwd": (2 * L + enc) * STEPS, "flash_dq": L * STEPS,
            "flash_dkv": L * STEPS}


def drive_config(arch, layers, batch, seq, **kw):
    """One of the reference's remaining transformer configs at full width in
    its bfloat16, ``layers`` deep, batch x seq (whisper: seq target tokens
    over its 1500 frames; pixtral: random (B, S, D) embeddings), its own
    plan, ``attn_impl="flash"`` (``kw`` more overrides, e.g. remat): STEPS
    training steps through ``steps.make_train_step`` with the trainer's
    batches, then one traced step. Asserts finite losses and parameters,
    the K9-K11 launches the code implies (``flash_launches``), every one on
    the wgmma route, and 8 GB of the card free. Returns (counts, [ms], peak
    bytes, device split, losses)."""
    from repro_torch import configs
    from repro_torch.configs import adapters
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps, train
    spec = configs.get_arch(arch)
    dev = torch.device("cuda")
    cfg = spec.full(num_layers=layers, attn_impl="flash", **kw)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_eff, cfg.hd, cfg.d_ff, cfg.vocab,
            cfg.param_dtype, cfg.compute_dtype) == (*WIDTHS[arch], torch.bfloat16,
                                                    torch.bfloat16), cfg
    what = f"{arch}" + "".join(f"/{k_}={v}" for k_, v in kw.items())
    print(f"main path: {what}, {layers} of {FULL_LAYERS[arch]} layers"
          + (f" + {cfg.enc_layers} encoder layers over {cfg.enc_seq} frames"
             if cfg.is_encoder_decoder else "")
          + f", bfloat16, batch {batch}, seq {seq}, plan {cfg.plan.to_dict()}, "
          f"remat {cfg.remat}, flash, {STEPS} steps")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = adapters.init_params(
        spec.kind, torch.Generator(device="cuda").manual_seed(0), cfg, device=dev)
    n_params = sum(p.numel() for p in _leaves(params))
    opt = steps.default_opt(1e-3)
    state = opt.init(params)
    step_fn = steps.make_train_step(spec, cfg, opt)
    batch_fn = train.make_batch_fn(spec.kind, cfg, batch, seq, 0, dev)
    torch.cuda.synchronize()
    reset_counts()
    ms, ls_, draw_ms = [], [], []
    for step in range(STEPS):
        # the trainer's batch (whisper: 1500 frames a row, pixtral: the
        # embeddings, drawn by numpy) is timed on its own, outside the step
        t0 = time.perf_counter()
        b = batch_fn(step)
        torch.cuda.synchronize()
        draw_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        params, state, loss = step_fn(params, state, b, step, 0)
        ls_.append(float(loss))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        print(f"  step {step}: loss {ls_[-1]:.4f}  {ms[-1]:.1f} ms (batch drawn "
              f"before it in {draw_ms[-1]:.1f} ms)")
        del b
    c = read_counts()
    assert all(math.isfinite(x) for x in ls_), ls_
    assert all(torch.isfinite(p).all() for p in _leaves(params))
    assert all(p.dtype == torch.bfloat16 for p in _leaves(params))
    flash = flash_launches(cfg)
    assert all(fa.route(k_, torch.bfloat16, cfg.hd) == "wgmma" for k_ in flash), cfg.hd
    want = {**flash, **wgmma_routes(flash)}
    got = {k_: v for k_, v in c.items() if v}
    assert got == {k_: v for k_, v in want.items() if v}, \
        f"{what}: launches {got}, expected {want} and no other kernel"
    peak = torch.cuda.max_memory_allocated()
    print(f"  {n_params} parameters; launches per step as expected, each pass on "
          f"its route: " + ", ".join(f"{k_}={v / STEPS:g}" for k_, v in got.items()))
    print(f"  {what}: steady median {steady_median(ms):.2f} ms a step without the "
          f"batch's draw, {steady_median(draw_ms):.2f} ms the draw, "
          f"{steady_median([a + b_ for a, b_ in zip(ms, draw_ms)]):.2f} ms both")
    peak_check(what, peak)
    params, state, split = traced_step(what, step_fn, params, state, batch_fn)
    del params, state
    return c, ms, peak, split, ls_


def check_dots_backward():
    """gemma-2b whole (18 layers, batch 1 x 4096, bfloat16, flash, its own
    plan): under remat "none", "full" and "dots", one loss and backward to
    warm up, then one more whose backward runs under a dispatch mode that
    counts ``aten.mm`` / ``aten.addmm`` and under ``torch.profiler``.
    Fails unless "dots" calls them as often as "none" (no saved product is
    recomputed) and "full" more often. Prints each backward's
    matrix-product and busy device time, the memory the forward leaves
    saved, the peak above the parameters, and the kernels whose backward
    time differs most between "full" and "dots" (the forward's products
    that "full" recomputes). Returns {remat: numbers}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch import configs
    from repro_torch.configs import adapters
    from repro_torch.launch import train
    from repro_torch.launch.profile import _device_us, kernel_group
    from repro_torch.models import transformer
    from repro_torch.optim import tree_leaves

    class CountDots(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in transformer._SAVED_DOTS
            return func(*args, **(kwargs or {}))

    spec = configs.get_arch(GEMMA)
    res, by_kernel = {}, {}
    print(f"remat against the backward's matrix products: {GEMMA}, 18 layers, "
          "bfloat16, batch 1 x 4096, flash")
    for remat in ("none", "full", "dots"):
        cfg = spec.full(attn_impl="flash", remat=remat)
        gc.collect()
        torch.cuda.empty_cache()
        params = adapters.init_params(
            spec.kind, torch.Generator(device="cuda").manual_seed(0), cfg,
            device=torch.device("cuda"))
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        batch = train.make_batch_fn(spec.kind, cfg, 1, 4096, 0, torch.device("cuda"))(0)
        loss = lambda: transformer.loss_fn(params, batch, cfg, seed=0, step=0)
        torch.autograd.grad(loss(), leaves)          # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        value = loss()
        torch.cuda.synchronize()
        saved = torch.cuda.memory_allocated() - base
        mode = CountDots()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with mode:
                torch.autograd.grad(value, leaves)
            torch.cuda.synchronize()
        dev = {}
        for e in prof.key_averages():
            if getattr(e, "device_type", None) == DeviceType.CUDA:
                dev[e.key] = dev.get(e.key, 0.0) + _device_us(e) / 1e3
        by_kernel[remat] = dev
        r = dict(mm_addmm=mode.n, saved_bytes=saved,
                 peak_bytes=torch.cuda.max_memory_allocated() - base,
                 gemm_ms=sum(ms for k_, ms in dev.items()
                             if kernel_group(k_) == "matrix products"),
                 busy_ms=sum(dev.values()))
        res[remat] = r
        print(f"  {remat}: backward mm + addmm {r['mm_addmm']}, matrix products "
              f"{r['gemm_ms']:.3f} of {r['busy_ms']:.3f} ms device-busy; forward left "
              f"{saved} bytes saved, peak {r['peak_bytes']} bytes above the parameters")
        del params, leaves, value, batch
    full, dots = by_kernel["full"], by_kernel["dots"]
    for k_ in sorted(set(full) | set(dots),
                     key=lambda k_: -abs(full.get(k_, 0.0) - dots.get(k_, 0.0)))[:4]:
        print(f"  backward, full against dots: {full.get(k_, 0.0):.3f} against "
              f"{dots.get(k_, 0.0):.3f} ms [{kernel_group(k_)}] {k_[:90]}")
    ok = res["dots"]["mm_addmm"] == res["none"]["mm_addmm"] < res["full"]["mm_addmm"]
    print(f"  dots recomputes no saved product ({res['dots']['mm_addmm']} calls as "
          f"without remat, {res['full']['mm_addmm']} under full): {ok}")
    assert ok, res
    return res


def drive_configs():
    """gemma-2b whole (18 of 18 layers, batch 1 x 4096) with remat "full"
    and then "dots"; whisper-base whole (6 + 6 layers, batch WB, WS target
    tokens over WT frames); minitron-8b, qwen1.5-32b and pixtral-12b cut to
    ``CUT_LAYERS`` at batch 1 x 4096. Returns ({arch: {variant: counts}},
    {key: [ms]}, {key: peak}, {key: split}, depths)."""
    runs = [(GEMMA, "full", 18, 1, 4096, {}),
            (GEMMA, "dots", 18, 1, 4096, dict(remat="dots")),
            (WHISPER, "flash", 6, WB, WS, {}),
            *((a, "flash", CUT_LAYERS[a], 1, 4096, {}) for a in (MINITRON, QWEN15, PIXTRAL))]
    counts, step_ms, peak, split = {}, {}, {}, {}
    for arch, variant, layers, batch, seq, kw in runs:
        c, ms, pk, sp, _ = drive_config(arch, layers, batch, seq, **kw)
        counts.setdefault(arch, {})[variant] = c
        key = f"{arch}/{variant}"
        step_ms[key], peak[key], split[key] = ms, pk, sp
        print(f"{key}: steady median {steady_median(ms):.2f} ms/step, "
              f"{batch * seq / steady_median(ms) * 1e3:.1f} tokens/s, peak memory "
              f"{pk} bytes ({pk / 2**30:.2f} GiB)")
        gc.collect()
        torch.cuda.empty_cache()
    print(f"{GEMMA} remat dots against full: peak {peak[GEMMA + '/dots']} against "
          f"{peak[GEMMA + '/full']} bytes, steady median "
          f"{steady_median(step_ms[GEMMA + '/dots']):.2f} against "
          f"{steady_median(step_ms[GEMMA + '/full']):.2f} ms/step")
    depths = {GEMMA: 18, WHISPER: 6, **CUT_LAYERS}
    return counts, step_ms, peak, split, depths


# ---------------------------------------------------------------------------
# serving: the decode engine, prefill and the continuous-batching scheduler
# ---------------------------------------------------------------------------

SERVE = "serving"
SQB, SQP, SQG, SQC, SQ_CHECK = 8, 512, 64, 16, 64    # qwen3-8b rectangular
SXB, SXN, SXP, SXG = 8, 32, 64, 64     # xlstm-1.3b trace: slots, requests, max prompt, max budget
# the xlstm-1.3b server's depth, cut from 48 (its trace's eager admission
# replay, ~100 s of the script at 48, scales with it)
SX_LAYERS = 16
SNB, SNS, SNT, SNG = 64, 50, 8, 50     # luong-nmt: batch, source, target prefix, generated
# native (K9) vs replay prefill of qwen3-8b: the first decode logits agree
# within this x max(1, |ref|) (float32 products in other orders over 36
# layers; the measured distance is printed beside it); in bfloat16 within
# BF16_TOL (activations rounded to bfloat16 at other points: K9 keeps a
# prompt's scores in float32 where the replay's decode steps read bfloat16
# caches)
PREFILL_TOL = 1e-3


def _serve_model(arch, check, **kw):
    """Full-width params of ``arch`` on the card from a CUDA generator seeded
    0, after the previous phase's tensors are freed."""
    from repro_torch import configs
    from repro_torch.configs import adapters
    spec = configs.get_arch(arch)
    cfg = spec.full(**kw)
    assert check(cfg), cfg
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = adapters.init_params(
        spec.kind, torch.Generator(device="cuda").manual_seed(0), cfg,
        device=torch.device("cuda"))
    return spec, cfg, params


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _device_split(fn):
    """``fn()`` under ``torch.profiler``: (device-busy ms, {group: share})
    with the groups of ``launch/profile.py`` (each port kernel, the
    library's matrix products, the rest)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile import _device_us, kernel_group
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            g = kernel_group(e.key)
            groups[g] = groups.get(g, 0.0) + _device_us(e) / 1e3
    busy = sum(groups.values())
    return busy, {g: v / busy for g, v in groups.items()} if busy else {}


def _loops(eng, prefill, n_gen, B_, what):
    """Prefill, then the graph loop twice (the first run captures its
    graphs) and the python loop, each after its own prefill; the tokens of
    all three must agree. A fourth graph run under ``torch.profiler`` gives
    the device-busy time a token and its split. Returns the timings."""
    res = {}
    for loop in ("graph (first: capture)", "graph", "python"):
        (tok0, pos0), pre_ms = _timed(prefill)
        gen = eng.generate_python if loop == "python" else eng.generate
        toks, ms = _timed(lambda: gen(tok0, n_gen, start_pos=pos0))
        assert toks.shape == (B_, n_gen) and toks.min() >= 0, toks
        res[loop] = dict(prefill_ms=pre_ms, decode_ms=ms, tokens=toks,
                         ms_per_token=ms / n_gen,
                         tokens_per_s=B_ * n_gen / ms * 1e3)
        print(f"  {what} prefill {pre_ms:.1f} ms; {loop} loop: {n_gen} tokens in "
              f"{ms:.1f} ms, {ms / n_gen:.3f} ms a token, "
              f"{B_ * n_gen / ms * 1e3:.1f} tokens/s")
    for loop in ("graph", "python"):
        same = np.array_equal(res[loop]["tokens"], res["graph (first: capture)"]["tokens"])
        print(f"  {what}: {loop} loop tokens equal the first graph run's: {same}")
        assert same, f"{what}: {loop} loop tokens differ"
    for r in res.values():
        del r["tokens"]
    tok0, pos0 = prefill()
    busy, split = _device_split(lambda: eng.generate(tok0, n_gen, start_pos=pos0))
    res["graph"]["device_ms_per_token"] = busy / n_gen
    res["graph"]["device_split"] = split
    print(f"  {what} graph loop under the profiler: device busy {busy / n_gen:.3f} "
          f"ms a token (unprofiled wall {res['graph']['ms_per_token']:.3f}); "
          + ", ".join(f"{g} {v:.1%}" for g, v in sorted(split.items(),
                                                        key=lambda kv: -kv[1])))
    return res


def serve_qwen(arch=QWEN):
    """qwen3-8b (or gemma-2b), every layer, in its config's bfloat16
    (bfloat16 KV cache, float32 logits), ``attn_impl="flash"``: prefill
    SQB x (SQP - 1) tokens natively (K9 once a layer on the route of the
    config's head_dim, no K10 / K11, no other kernel), then SQG tokens by
    the graph loop and by the python loop; native against replay prefill at
    SQ_CHECK tokens on the first decode logits. Returns (numbers, counts,
    native prefills)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    from repro_torch.serving import DecodeEngine, prompt_prefill
    widths = {QWEN: (36, 4096, QHQ, QHKV, QD, 12288, 151936),
              GEMMA: (FULL_LAYERS[GEMMA], *WIDTHS[GEMMA])}[arch]
    spec, cfg, params = _serve_model(
        arch, lambda c: (c.num_layers, c.d_model, c.n_heads, c.n_kv_eff, c.hd,
                         c.d_ff, c.vocab) == widths, attn_impl="flash")
    L, rt = cfg.num_layers, fa.route("flash_fwd", cfg.compute_dtype, cfg.hd)
    if arch == GEMMA:
        # the reference's init draws gemma's stacked matrices at std 18 **
        # -0.5, so without qk-norm its attention logits reach ~1e3: a
        # near-one-hot softmax whose winners flip under bfloat16 rounding
        # over 18 layers, and native and replay prefill cannot agree. The
        # serving run draws them at std fan_in ** -0.5 (logits of std ~1);
        # its embedding, scaled by sqrt(d_model), already gives rms ~1.
        params = _fan_in_init(params, L, ("wq", "wk", "wv", "wo", "w_gate", "w_up"),
                              embed=False)
    n_params = sum(p.numel() for p in _leaves(params))
    assert cfg.param_dtype == cfg.compute_dtype == torch.bfloat16, cfg
    print(f"serving: {arch}, {L} of {L} layers ({n_params} parameters, "
          f"{str(cfg.param_dtype)[6:]}), flash, batch {SQB}, prompt {SQP}, "
          f"{SQG} generated, chunk {SQC}")
    eng = DecodeEngine(spec=spec, cfg=cfg, params=params, max_seq=SQP + SQG,
                       batch=SQB, chunk=SQC)
    g = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(3, cfg.vocab, (SQB, SQP), generator=g, device="cuda",
                           dtype=torch.int32)

    n_native = [0]

    def prefill(p=prompt, method="native"):
        eng.reset()
        n_native[0] += method == "native"
        _, tok0, pos0 = prompt_prefill(spec, cfg, params, p, state=eng.state,
                                       method=method)
        return tok0, pos0

    assert all(v.dtype == torch.bfloat16 for v in eng.state.values()), \
        "the KV cache is not bfloat16"
    reset_counts()
    res = _loops(eng, prefill, SQG, SQB, arch)
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    logits = {}
    for method in ("native", "replay"):
        (tok0, pos0), ms = _timed(lambda: prefill(prompt[:, :SQ_CHECK], method))
        logits[method] = transformer.decode_step(params, cfg, eng.state, tok0,
                                                 pos0)[0]
        print(f"  {method} prefill of {SQ_CHECK - 1} tokens: {ms:.1f} ms")
    c = read_counts()
    n_native = n_native[0]
    # K9 once a layer, on the head_dim's route, and nothing else
    want = {k_: (L * n_native if k_ in ("flash_fwd", f"flash_fwd/{rt}") else 0)
            for k_ in c}
    off = {k_: v for k_, v in c.items() if v != want[k_]}
    print(f"  launches in {n_native} native prefills: flash_fwd={c['flash_fwd']} "
          f"({c['flash_fwd'] / n_native:g} a prefill, {L} layers; "
          f"{c[f'flash_fwd/{rt}'] / n_native:g} on the {rt} route), "
          + ("no other kernel" if not off else f"UNEXPECTED {off}"))
    assert not off, off
    err = compare(f"  first decode logits after native (K9) vs replay prefill of "
                  f"{SQ_CHECK - 1} tokens", logits["native"], logits["replay"],
                  PREFILL_TOL if cfg.compute_dtype == torch.float32 else BF16_TOL)
    res["native_vs_replay_max_abs_err"] = err
    res["native_vs_replay_rel_err"] = err / max(1.0, logits["replay"].abs().max().item())
    print(f"  peak memory {res['peak_bytes']} bytes ({res['peak_bytes'] / 2**30:.2f} GiB)")
    del eng, params, logits
    return res, c, n_native


def serve_xlstm():
    """xlstm-1.3b, SX_LAYERS of 48 blocks, in its config's bfloat16 (float32
    recurrent state, bfloat16 conv ring): a continuous-batching trace of
    SXN requests over SXB slots (prompts 2..SXP, budgets SXG // 4..SXG, the
    reference's ``_ragged_trace`` with seed 0), chunk 16, run twice in the
    same order for the same tokens; then rectangular at batch SXB (prompt
    SXP, SXG generated), the graph loop against the python loop."""
    from repro_torch.launch.serve import ragged_trace
    from repro_torch.serving import DecodeEngine, prompt_prefill, serve
    spec, cfg, params = _serve_model(
        XLSTM, lambda c: (c.num_layers, c.d_model, c.n_heads, c.inner, c.vocab,
                          c.slstm_every) == (SX_LAYERS, 2048, 4, 4096, 50304, 8),
        num_layers=SX_LAYERS)
    eng = DecodeEngine(spec=spec, cfg=cfg, params=params, max_seq=SXP + SXG,
                       batch=SXB, chunk=16)
    state_bytes = sum(v.numel() * v.element_size() for v in eng.state.values())
    assert cfg.param_dtype == cfg.compute_dtype == torch.bfloat16, cfg
    assert eng.state["m_C"].dtype == torch.float32 and eng.state["m_conv"].dtype == \
        torch.bfloat16, {k_: v.dtype for k_, v in eng.state.items()}
    print(f"serving: {XLSTM}, {SX_LAYERS} of 48 blocks, {str(cfg.param_dtype)[6:]}, {SXB} slots "
          f"({state_bytes / SXB / 2**30:.3f} GiB of decode state a slot)")
    reqs = ragged_trace(SXN, cfg.vocab, SXP, SXG, 0)
    # host time in the engine's two calls (each ends in a device sync)
    spent = {"admit": 0.0, "decode_chunk": 0.0}
    for name in spent:
        def timed(*a, _f=getattr(eng, name), _n=name):
            t0 = time.perf_counter()
            out = _f(*a)
            torch.cuda.synchronize()
            spent[_n] += (time.perf_counter() - t0) * 1e3
            return out
        setattr(eng, name, timed)
    runs, res = [], {}
    for i in range(2):
        spent.update(admit=0.0, decode_chunk=0.0)
        outs, ms = _timed(lambda: serve(eng, reqs, chunk=16))
        total = sum(len(v) for v in outs.values())
        assert len(outs) == SXN, len(outs)
        assert all(len(outs[r.rid]) == r.max_new for r in reqs)
        print(f"  trace run {i}: {SXN} requests over {SXB} slots (admitted == "
              f"evicted == {len(outs)}), {total} tokens in {ms:.1f} ms, "
              f"{total / ms * 1e3:.1f} tokens/s, {eng.chunks_run} chunks; "
              f"admit {spent['admit']:.1f} ms, decode_chunk "
              f"{spent['decode_chunk']:.1f} ms")
        runs.append(outs)
        res[f"trace_run{i}"] = dict(ms=ms, tokens=total,
                                    tokens_per_s=total / ms * 1e3,
                                    chunks_run=eng.chunks_run,
                                    admit_ms=spent["admit"],
                                    decode_chunk_ms=spent["decode_chunk"])
    assert all(np.array_equal(runs[0][r], runs[1][r]) for r in runs[0]), \
        "two runs of the trace in one order differ"
    print("  the two trace runs give the same tokens")
    g = torch.Generator(device="cuda").manual_seed(2)
    prompt = torch.randint(3, cfg.vocab, (SXB, SXP), generator=g, device="cuda",
                           dtype=torch.int32)

    def prefill():
        eng.reset()
        _, tok0, pos0 = prompt_prefill(spec, cfg, params, prompt, state=eng.state)
        return tok0, pos0

    res["rectangular"] = _loops(eng, prefill, SXG, SXB, XLSTM)
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["state_bytes_per_slot"] = state_bytes / SXB
    print(f"  peak memory {res['peak_bytes']} bytes ({res['peak_bytes'] / 2**30:.2f} GiB)")
    del eng, params
    return res


def serve_nmt():
    """luong-nmt at full width: ``DecodeEngine.prefill`` with an encoder
    batch (SNB sentences of SNS source tokens, target prefix SNT), then SNG
    tokens, the graph loop against the python loop."""
    from repro_torch.serving import DecodeEngine
    spec, cfg, params = _serve_model(
        NMT, lambda c: (c.src_vocab, c.tgt_vocab, c.embed, c.hidden,
                        c.num_layers) == (50000, 50000, 512, 512, 2))
    print(f"serving: {NMT}, batch {SNB}, source {SNS}, target prefix {SNT}, "
          f"{SNG} generated")
    eng = DecodeEngine(spec=spec, cfg=cfg, params=params, max_seq=SNS,
                       batch=SNB, chunk=16)
    g = torch.Generator(device="cuda").manual_seed(3)
    src = torch.randint(3, cfg.src_vocab, (SNB, SNS), generator=g, device="cuda")
    prefix = torch.randint(3, cfg.tgt_vocab, (SNB, SNT), generator=g, device="cuda")

    def prefill():
        eng.reset()
        eng.prefill({"src": src, "tgt_in": prefix[:, :-1]})
        return prefix[:, -1:], SNT - 1

    res = _loops(eng, prefill, SNG, SNB, NMT)
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    del eng, params
    return res


SWB, SWP, SWG = 8, 4, 64     # whisper-base serving: batch, prompt, generated


def serve_whisper():
    """whisper-base whole (6 + 6 layers) in its config's bfloat16,
    ``attn_impl="flash"``: ``DecodeEngine.prefill`` of SWB x (SWP - 1)
    prompt tokens over SWB x WT random frames (x 0.02, as the reference's
    CLI), which encodes them (K9 non-causal once an encoder layer) into the
    cross K/V and prefills the decoder (K9 once a layer), then SWG tokens by
    the graph loop and by the python loop, token for token equal."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serving import DecodeEngine
    spec, cfg, params = _serve_model(
        WHISPER, lambda c: (c.num_layers, c.enc_layers, c.enc_seq, c.d_model, c.n_heads,
                            c.n_kv_eff, c.hd, c.d_ff, c.vocab)
        == (6, 6, WT, *WIDTHS[WHISPER]), attn_impl="flash")
    print(f"serving: {WHISPER}, 6 + 6 layers, {str(cfg.param_dtype)[6:]}, flash, "
          f"batch {SWB}, {WT} frames, prompt {SWP}, {SWG} generated, chunk 16")
    eng = DecodeEngine(spec=spec, cfg=cfg, params=params, max_seq=SWP + SWG,
                       batch=SWB, chunk=16)
    g = torch.Generator(device="cuda").manual_seed(4)
    prompt = torch.randint(3, cfg.vocab, (SWB, SWP), generator=g, device="cuda",
                           dtype=torch.int32)
    frames = (torch.randn(SWB, WT, cfg.d_model, generator=g, device="cuda") * 0.02
              ).to(cfg.compute_dtype)
    n = [0]

    def prefill():
        eng.reset()
        n[0] += 1
        eng.prefill({"tokens": prompt[:, :-1], "frames": frames})
        return prompt[:, -1:], SWP - 1

    reset_counts()
    res = _loops(eng, prefill, SWG, SWB, WHISPER)
    c = read_counts()
    rt = fa.route("flash_fwd", cfg.compute_dtype, cfg.hd)
    want = {k_: (12 * n[0] if k_ in ("flash_fwd", f"flash_fwd/{rt}") else 0) for k_ in c}
    off = {k_: v for k_, v in c.items() if v != want[k_]}
    print(f"  launches in {n[0]} prefills: flash_fwd={c['flash_fwd']} (12 a prefill: "
          f"6 encoder, 6 decoder layers, on the {rt} route), "
          + ("no other kernel" if not off else f"UNEXPECTED {off}"))
    assert not off, off
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    del eng, params
    return res, c, n[0]


def serve_smoke_card_vs_cpu():
    """At smoke width (qwen3 and whisper with ``attn_impl="flash"``, head dim
    16, which K9 takes; xlstm; luong-nmt), the same params and prompts (and
    whisper's frames) give the same greedy tokens on the card (graph loop)
    as on the CPU, and a small trace served in two arrival orders gives the
    same per-request outputs on the card, and the CPU's (the transformer's
    trace is rectangular: equal prompt lengths, policy "batch"; whisper has
    no trace: admission replays decode steps, which read no frames)."""
    from repro_torch import configs
    from repro_torch.configs import adapters
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.optim import tree_map
    from repro_torch.serving import DecodeEngine, Request, serve
    from repro_torch.testing import serve_rectangular
    for arch, kw in ((QWEN, dict(attn_impl="flash")), (WHISPER, dict(attn_impl="flash")),
                     (XLSTM, {}), (NMT, {})):
        spec = configs.get_arch(arch)
        cfg = spec.smoke(**kw)
        if spec.kind == "transformer":
            assert cfg.hd in fa.HEAD_DIMS, cfg.hd
        vocab = cfg.tgt_vocab if spec.kind == "nmt" else cfg.vocab
        p_cpu = adapters.init_params(spec.kind, torch.Generator().manual_seed(0), cfg)
        rng = np.random.default_rng(4)
        prompt = torch.from_numpy(rng.integers(3, vocab, (3, 9)).astype(np.int32))
        plens = [5] * 6 if spec.kind == "transformer" else [2, 7, 4, 9, 3, 6]
        reqs = [Request(rid=i, prompt=rng.integers(3, vocab, n), max_new=m)
                for i, (n, m) in enumerate(zip(plens, [6, 3, 8, 4, 7, 5]))]
        policy = "batch" if spec.kind == "transformer" else "continuous"
        enc_dec = spec.kind == "transformer" and cfg.is_encoder_decoder
        frames = (torch.from_numpy(rng.standard_normal((3, cfg.enc_seq, cfg.d_model))
                                   .astype(np.float32) * 0.02) if enc_dec else None)
        got = {}
        for dev in ("cpu", "cuda"):
            params = p_cpu if dev == "cpu" else tree_map(lambda a: a.cuda(), p_cpu)
            got[dev] = serve_rectangular(
                spec, cfg, params, prompt.to(dev), chunk=4,
                frames=None if frames is None else frames.to(dev))
            if enc_dec:
                continue
            eng = DecodeEngine(spec=spec, cfg=cfg, params=params, max_seq=32,
                               batch=3, chunk=4)
            got[f"{dev}/trace"] = serve(eng, reqs, policy=policy)
            got[f"{dev}/trace reversed"] = serve(eng, reqs[::-1], policy=policy)
        same = np.array_equal(got["cpu"], got["cuda"])
        if enc_dec:
            orders, said = True, ("no trace served: admission replays decode "
                                  "steps, which read no frames")
        else:
            orders = all(np.array_equal(got["cuda/trace"][r.rid], got[k_][r.rid])
                         for r in reqs for k_ in ("cuda/trace reversed", "cpu/trace"))
            said = f"trace outputs equal across arrival orders and the CPU's: {orders}"
        print(f"serving smoke ({cfg.name}): card graph loop tokens equal the "
              f"CPU's: {same}; {said}")
        assert same and orders, (got["cpu"], got["cuda"])


def decode_dtypes():
    """The python loop's cost in float32 against bfloat16 within this call:
    qwen3-8b (36 layers) and xlstm-1.3b (48 blocks) whole, batch SQB,
    ``decode_step`` alone, SQC steps timed after 2 warm-ups, in
    the order float32, bfloat16, bfloat16, float32 (mean of the two runs
    of each); and the device kernels one step launches
    (``torch.profiler``'s count of CUDA kernel events, once a run; the
    profiler may drop a record), which the python loop pays one launch
    each and the captured graph replays. Returns {arch: {dtype: {"ms",
    "kernels", "ms_per_step"}}}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.configs import adapters
    out = {}
    for arch in (QWEN, XLSTM):
        spec = configs.get_arch(arch)
        res = {}
        for dt in (torch.float32, torch.bfloat16, torch.bfloat16, torch.float32):
            cfg = spec.full(param_dtype=dt, compute_dtype=dt)
            gc.collect()
            torch.cuda.empty_cache()
            params = adapters.init_params(
                spec.kind, torch.Generator(device="cuda").manual_seed(0), cfg,
                device=torch.device("cuda"))
            state = adapters.init_decode_state(spec, cfg, SQB, SQC + 4, device="cuda")
            tok = torch.ones((SQB, 1), dtype=torch.int32, device="cuda")
            step = adapters.decode_fn(spec)
            for pos in range(2):
                step(params, cfg, state, tok, pos)
            _, ms = _timed(lambda: [step(params, cfg, state, tok, 2 + i)
                                    for i in range(SQC)])
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step(params, cfg, state, tok, 2 + SQC)
                torch.cuda.synchronize()
            n = sum(e.count for e in prof.key_averages()
                    if getattr(e, "device_type", None) == DeviceType.CUDA)
            r = res.setdefault(str(dt)[6:], {"ms": [], "kernels": []})
            r["ms"].append(ms / SQC)
            r["kernels"].append(n)
            del params, state
        for r in res.values():
            r["ms_per_step"] = sum(r["ms"]) / 2
        print(f"  {arch} decode_step, {cfg.num_layers} layers, batch {SQB}: "
              + "; ".join(f"{d} {r['ms_per_step']:.3f} ms a step ({', '.join(f'{x:.3f}' for x in r['ms'])}), "
                          f"{' / '.join(map(str, r['kernels']))} kernels a step"
                          for d, r in res.items()))
        out[arch] = res
    return out


def drive_serving():
    """The serving phase, under ``torch.inference_mode()``: qwen3-8b,
    gemma-2b, whisper-base, xlstm-1.3b and luong-nmt served whole at full
    width, then card against CPU at smoke width. Returns ({arch: numbers},
    {"prefill": counts}, qwen3-8b's native prefills, {arch: (counts,
    prefills)} of gemma-2b and whisper-base)."""
    with torch.inference_mode():
        q, counts, n_native = serve_qwen()
        gm, g_counts, g_native = serve_qwen(GEMMA)
        w, w_counts, w_native = serve_whisper()
        out = {QWEN: q, GEMMA: gm, WHISPER: w, XLSTM: serve_xlstm(), NMT: serve_nmt()}
        serve_smoke_card_vs_cpu()
        out["decode_dtypes"] = decode_dtypes()
    return (out, {"prefill": counts}, n_native,
            {GEMMA: ({"prefill": g_counts}, g_native),
             WHISPER: ({"prefill": w_counts}, w_native)})


def prefill_shapes():
    """K9's serving prefill shapes: {label: (B, S, Hq, Hkv after kv_repeat,
    d, causal, the row's launch counts, K9 launches of this shape a
    prefill)}. qwen3-8b and gemma-2b prefill SQB x (SQP - 1) prompt tokens
    causally; whisper-base encodes SWB x WT frames (non-causal) and
    prefills SWB x (SWP - 1) tokens (causal), 6 layers each."""
    return {"prefill": (SQB, SQP - 1, QHQ, QHKV, QD, True, SERVE, 36),
            f"prefill-{GEMMA}": (SQB, SQP - 1, *WIDTHS[GEMMA][1:4], True,
                                 f"{SERVE}/{GEMMA}", FULL_LAYERS[GEMMA]),
            "prefill-whisper-enc": (SWB, WT, *WIDTHS[WHISPER][1:4], False,
                                    f"{SERVE}/{WHISPER}", 6),
            "prefill-whisper-dec": (SWB, SWP - 1, *WIDTHS[WHISPER][1:4], True,
                                    f"{SERVE}/{WHISPER}", 6)}


def check_flash_prefill(gen, out, dtype=torch.float32, label="prefill", want_route=None):
    """K9 at a serving prefill's shape (``prefill_shapes``; qwen3-8b's:
    B=SQB, Sq=Sk=SQP-1, 32 query heads over 16 kv heads of 128, causal),
    timed beside the plain version and SDPA's forward, cold L2; the row
    takes its launches from that model's serving phase, which runs the
    bfloat16 instantiation. float32: against its plain version (1e-3 x
    max(1, |ref|)) and a float64 forward over one (batch, kv head) group
    (``FLASH_F64_TOL``). bfloat16 (the serving path's dtype): launched on
    the route bfloat16 at its head_dim takes and on no other, against its
    plain version within BF16_TOL, the same bits from a second launch and,
    over every group, against float64 within 10 x the bfloat16 plain
    version's distance + 1e-6 (``flash_f64_bf16``), and the kernel's and
    SDPA's device times beside their CUDA-event times (``device_times``:
    at these short shapes the event times swing with the host's). With
    ``want_route``, K9 must take that route."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B_, S, Hq, Hkv, d_, causal, arch, per_prefill = prefill_shapes()[label]
    bf = dtype == torch.bfloat16
    r = lambda *shape: torch.randn(*shape, generator=gen).to("cuda", dtype)
    q, k, v = r(B_, S, Hq, d_), r(B_, S, Hkv, d_), r(B_, S, Hkv, d_)
    print(f"flash_attention forward at the serving {label}: B={B_} S={S} "
          f"Hq={Hq} Hkv={Hkv} d={d_} {'causal' if causal else 'full'} {dtype}")
    fwd_k = lambda: fa.flash_fwd_cuda(q, k, v, causal)
    fwd_p = lambda: fa.attention_plain(q, k, v, causal)
    tag = f" ({label}, bf16)" if bf else f" ({label})"
    rt = fa.route("flash_fwd", dtype, d_)
    assert want_route in (None, rt), (label, rt)
    before = read_counts()
    err = compare("  flash_fwd" + tag, list(fwd_k()), list(fwd_p()),
                  BF16_TOL if bf else 1e-3)
    if bf:
        moved = {k_: n - before[k_] for k_, n in read_counts().items()
                 if k_.startswith("flash_") and n != before[k_]}
        assert moved == {"flash_fwd": 1, f"flash_fwd/{rt}": 1}, (tag, moved)
    if rt == "wgmma":
        ms, prev = wgmma_vs_tf32(fa, fwd_k)
    else:
        ms = time_ms(fwd_k, cold_l2=True)
    if bf:
        same_bits("flash_fwd second launch" + tag, list(fwd_k()), lambda: list(fwd_k()))
        f64 = flash_f64_bf16(fa, q, k, v, None, causal, None, backward=False)
        extra = dict(dtype="bfloat16", f64_rel_err=f64["flash_fwd"], kernel_route=rt,
                     shape_launches_per_prefill=per_prefill)
        if rt == "wgmma":
            extra["tf32_route_ms"] = prev
    else:
        f64 = flash_fwd_f64(fa, q, k, v, causal, None)
        extra = dict(f64_rel_err=f64["flash_fwd"], library_f64_rel_err=f64["sdpa_fwd"])
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=True)
    lib = time_ms(sdpa, cold_l2=True)
    if bf:
        extra.update(device_times(fwd_k, sdpa, cold_l2=True))
    pairs = S * (S + 1) // 2 if causal else S * S
    prod = 2 * B_ * Hq * pairs * d_
    es = torch.finfo(dtype).bits // 8
    qb, kb = B_ * S * Hq * d_ * es, B_ * S * Hkv * d_ * es
    nbytes = qb + 2 * kb + qb + 4 * B_ * Hq * S
    # bfloat16: the products at the bfloat16 rate; float32: 3xTF32
    passes, rate = (1, BF16_FLOPS) if bf else (3, TF32_FLOPS)
    add_row(out, f"flash_fwd/{rt}" if bf else "flash_fwd", arch, FLASH_SRC[rt],
            "src/repro/kernels/flash_attention.py:45", err, ms,
            time_ms(fwd_p, cold_l2=True), lib, nbytes, passes * 2 * prod, "cold",
            name=f"flash_fwd@{label}" + ("/bf16" if bf else ""), rate=rate, **extra)


def steady_median(ms):
    """Median step time without the first two steps: the first fills the
    allocator's pools and the libraries' caches, and the second is still
    several times slower than the steps after it."""
    steady = sorted(ms[2:])
    n = len(steady)
    return (steady[(n - 1) // 2] + steady[n // 2]) / 2


def _leaves(tree):
    from repro_torch.optim import tree_leaves
    return tree_leaves(tree)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.device import set_full_fp32
    from repro_torch.kernels import _build
    set_full_fp32()
    smi = smi_line()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s); "
          f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    start = time.perf_counter()

    last = [start, None]

    def phase(name):
        """Where the script's own time goes (it runs under a time limit): the
        seconds since the start and those of the phase before."""
        now = time.perf_counter()
        took = "" if last[1] is None else f"; {last[1]} took {now - last[0]:.1f} s"
        print(f"[phase] {name}: {now - start:.1f} s since the start{took}", flush=True)
        last[:] = [now, name]

    phase("kernel build")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k}: {v:.1f} s' for k, v in built.items()) or 'cached'})")
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill",
                                       "smem")):
                print(f"  [{name}] {line.strip()}")
    print("kernels: K1 gather_matmul, K2 gather_matmul_stepped, "
          "K3 lstm_scan_fwd, K4 lstm_scan_bwd, K5 lstm_pointwise, "
          "K6 slstm_scan_fwd/bwd (+ slstm_wg), K7 decoder_scan_fwd, K8 decoder_scan_bwd, "
          "K9 flash_fwd, K10 flash_dq, K11 flash_dkv (bfloat16 at d 64 / 128 / 256: "
          "flash_*_sm90), K12 grouped_matmul (bfloat16: "
          "grouped_mm_sm90)")

    gen = torch.Generator().manual_seed(0)
    rows = {}
    phase("kernel checks")
    check_gather_matmul(gen, rows)
    check_scan(gen, T, B, H, P, "structured", out=rows, tag="(main path)")
    check_scan(gen, 6, 3, 40, 0.5, "dense", tag="(dense)")
    check_scan(gen, 6, 3, 40, 0.5, "structured", fixed=True, tag="(FIXED)")
    check_scan(gen, 6, 3, 40, 0.5, "off", tag="(off)")
    check_scan(gen, 9, 5, 48, 0.5, "structured", ragged=True, tag="(ragged)")
    check_scan(gen, 9, 5, 48, 0.5, "dense", fixed=True, ragged=True, tag="(dense FIXED ragged)")
    check_scan(gen, T, B, 1500, 0.65, "structured", tag="(zaremba-large H=1500)")
    # luong-nmt: K1/K2 at the decoder's and encoder's shapes, K3/K4 at the
    # encoder's, K7/K8 at the decoder's, then K7/K8 in every site mode
    check_gather_matmul(gen, rows, NMT, NT_, NB, NH, NH, NP, extras=False)
    check_scan(gen, NT_, NB, NH, NP, "structured", out=rows, tag="(luong-nmt encoder)",
               arch=NMT)
    # bilstm-ner: K3/K4 at one direction's shape, then with ragged rows,
    check_scan(gen, ES, EB, EH, EP, "structured", out=rows, tag="(bilstm-ner)",
               arch=NER)
    check_scan(gen, ES, EB, EH, EP, "structured", ragged=True, min_len=1,
               deep=True, tag="(bilstm-ner ragged)")
    # and K1 at the scheduled engine's in-scan product (no NR site: no K2)
    check_gather_matmul(gen, rows, NER, ES, EB, EH, EH, EP, extras=False,
                        k2=False)
    check_decoder(gen, NT_, NB, NS, NH, "sp", rate=NP, bs=1, out=rows, tag="(main path)")
    for kind in ("dp", "df", "sf", "off", "mixed"):
        check_decoder(gen, 7, 5, 6, 40, kind, tag=f"({kind})")
    check_decoder(gen, 7, 5, 6, 40, "mixed", ragged=True, tag="(mixed ragged)")
    check_decoder(gen, 9, 6, 5, 48, "sp", ragged=True, tag="(ragged)")
    # xlstm-1.3b: K6 at the cell's shape, then every mode on small inputs
    check_slstm(gen, XT, XB, XNH, XDH, XP, "structured", bs=XBS, fresh=True,
                out=rows, tag="(main path)")
    check_slstm(gen, 6, 3, 3, 16, 0.5, "dense", tag="(dense)")
    check_slstm(gen, 6, 3, 3, 16, 0.5, "dense", fixed=True, mask_heads=3,
                fresh=True, tag="(dense FIXED per-head)")
    check_slstm(gen, 6, 3, 3, 16, 0.5, "structured", bs=4, fixed=True,
                fresh=True, tag="(FIXED)")
    check_slstm(gen, 6, 3, 3, 16, 0.5, "off", fresh=True, tag="(off)")
    check_slstm(gen, 9, 5, 3, 16, 0.5, "structured", bs=2, ragged=True,
                tag="(ragged)")
    check_slstm(gen, 9, 9, 3, 16, 0.5, "dense", ragged=True,
                tag="(dense ragged, two row chunks)")
    check_slstm(gen, 9, 4, 3, 16, 0.5, "structured", bs=1, tag="(handoff)")
    check_slstm(gen, 6, 2, 1, 2048, XP, "structured", bs=XBS, fresh=True,
                tag="(one head of 2048: R columns through L2)")
    # the same at the reference's dtype: bfloat16 xg and R, float32 states,
    # at xlstm-1.3b's shape in each mode, then on small inputs
    bf = dict(dtype=torch.bfloat16)
    check_slstm(gen, XT, XB, XNH, XDH, XP, "structured", bs=XBS, fresh=True,
                out=rows, tag="(main path, bf16)", **bf)
    check_slstm(gen, XT, XB, XNH, XDH, XP, "dense", fresh=True, tag="(dense, bf16)", **bf)
    check_slstm(gen, XT, XB, XNH, XDH, XP, "structured", bs=XBS, fixed=True,
                fresh=True, tag="(FIXED, bf16)", **bf)
    check_slstm(gen, XT, XB, XNH, XDH, XP, "structured", bs=XBS, ragged=True,
                fresh=True, tag="(ragged, bf16)", **bf)
    check_slstm(gen, XT, XB, XNH, XDH, XP, "structured", bs=XBS,
                tag="(handoff, bf16)", **bf)
    check_slstm(gen, 9, 5, 3, 15, 0.5, "structured", bs=1, ragged=True,
                tag="(odd dh, ragged, bf16)", **bf)
    check_slstm(gen, 6, 2, 1, 2048, XP, "structured", bs=XBS, fresh=True,
                tag="(one head of 2048, bf16)", **bf)
    # qwen3-8b: K9-K11 at the attention's shape, then every mode on small
    # inputs
    phase("flash checks")
    check_flash(gen, QB, QS, QS, QHQ, QHKV, QD, out=rows, tag="(main path)")
    check_flash(gen, QB, QS, QS, QHQ, QHKV, QD, out=rows, tag="(main path, bf16)",
                dtype=torch.bfloat16)
    check_flash_prefill(gen, rows)
    check_flash_prefill(gen, rows, torch.bfloat16)
    # gemma-2b's and whisper-base's serving prefills, all on wgmma: gemma's
    # K9 at d 256, whisper's encoder (non-causal) and decoder at d 64
    for label in (f"prefill-{GEMMA}", "prefill-whisper-enc", "prefill-whisper-dec"):
        check_flash_prefill(gen, rows, torch.bfloat16, label, want_route="wgmma")
    check_flash_modes(gen)
    # gemma-2b (8 query heads over its one kv head repeated 8 times, head_dim
    # 256) and whisper-base (8 heads of 64, the encoder non-causal over its
    # 1500 frames, the decoder causal over 448 tokens), bfloat16 on the
    # wgmma route, at their training shapes
    bf16 = dict(dtype=torch.bfloat16, out=rows)
    check_flash(gen, 1, 4096, 4096, 8, 8, 256, arch=GEMMA, label=GEMMA,
                want_route="wgmma", tag="(gemma-2b, bf16)", **bf16)
    check_flash(gen, WB, WT, WT, 8, 8, 64, causal=False, arch=WHISPER,
                label="whisper-enc", want_route="wgmma",
                tag="(whisper-base encoder, bf16)", **bf16)
    check_flash(gen, WB, WS, WS, 8, 8, 64, arch=WHISPER, label="whisper-dec",
                want_route="wgmma", tag="(whisper-base decoder, bf16)", **bf16)
    # mixtral-8x22b: K12 at the expert products' shapes, then small modes;
    # K5 at zaremba-medium's cell
    phase("K12, K5 and small-input checks")
    check_grouped(rows)
    check_pointwise(rows)
    check_engines_small()
    check_engines_small(NMT)
    check_engines_small(XLSTM)
    check_engines_small(NER)
    check_viterbi()
    check_qwen_small()
    check_mixtral_small()
    check_bf16_small()

    phase("training: the paper's models")
    counts, step_ms, path_peak = drive_main_path()
    crf_ms = time_crf()
    for engine in ("fused", "scheduled"):
        med = steady_median(step_ms[f"{NER}/{engine}"])
        print(f"{NER}/{engine}: steady median {med:.2f} ms/step, "
              f"{EB * ES / med * 1e3:.1f} tokens/s, peak memory "
              f"{path_peak[f'{NER}/{engine}']} bytes; CRF loss + backward "
              f"{crf_ms:.3f} ms ({crf_ms / med:.1%} of the step)")
    check_resume()
    counts[STACK] = drive_lstm_stack()
    gc.collect()
    torch.cuda.empty_cache()
    phase("training: xlstm-1.3b")
    x_counts, x_ms, x_peak, _, x_split = drive_xlstm()
    counts[XLSTM] = x_counts
    for engine, ms in x_ms.items():
        step_ms[f"{XLSTM}/{engine}"] = ms
        med = steady_median(ms)
        print(f"{XLSTM}/{engine}: steady median {med:.2f} ms/step, "
              f"{XB * XT / med * 1e3:.1f} tokens/s, peak memory "
              f"{x_peak[engine]} bytes ({x_peak[engine] / 2**30:.2f} GiB)")
    gc.collect()
    torch.cuda.empty_cache()
    phase("training: qwen3-8b")
    q_counts, q_ms, q_peak, q_split = drive_transformer()
    counts[QWEN] = q_counts
    for impl, ms in q_ms.items():
        step_ms[f"{QWEN}/{impl}"] = ms
        med = steady_median(ms)
        print(f"{QWEN}/{impl}: steady median {med:.2f} ms/step, "
              f"{QB * QS / med * 1e3:.1f} tokens/s, peak memory "
              f"{q_peak[impl]} bytes ({q_peak[impl] / 2**30:.2f} GiB)")
    gc.collect()
    torch.cuda.empty_cache()
    phase("training: mixtral-8x22b")
    m_counts, m_ms, m_peak, _, m_split = drive_moe()
    counts[MIXTRAL] = m_counts
    for impl, ms in m_ms.items():
        step_ms[f"{MIXTRAL}/{impl}"] = ms
        med = steady_median(ms)
        print(f"{MIXTRAL}/{impl}: steady median {med:.2f} ms/step, "
              f"{MB * MS / med * 1e3:.1f} tokens/s, peak memory "
              f"{m_peak[impl]} bytes ({m_peak[impl] / 2**30:.2f} GiB)")
    gc.collect()
    torch.cuda.empty_cache()
    phase("training: the remaining transformer configs")
    c_counts, c_ms, c_peak, c_split, c_depths = drive_configs()
    counts.update(c_counts)
    step_ms.update(c_ms)
    gc.collect()
    torch.cuda.empty_cache()
    dots = check_dots_backward()
    gc.collect()
    torch.cuda.empty_cache()
    phase("serving")
    serving, counts[SERVE], n_native, more = drive_serving()
    prefills = {SERVE: n_native}
    for a, (c, n) in more.items():
        counts[f"{SERVE}/{a}"], prefills[f"{SERVE}/{a}"] = c, n
    for key, ms in step_ms.items():
        print(f"step ms ({key}): " + ", ".join(f"{x:.2f}" for x in ms))
    phase("report")
    kernels = []
    for name, r in rows.items():
        arch = r.pop("arch")
        per = counts[arch]
        counter = r.pop("counter")
        r["launches"] = sum(c.get(counter, 0) for c in per.values())
        if arch == STACK:       # one lstm_stack forward per engine
            r["launches_per_call"] = {e: c.get(counter, 0) for e, c in per.items()}
        elif arch in prefills:  # native prefills of that model's serving
            r["launches_per_prefill"] = r["launches"] / prefills[arch]
        else:
            r["launches_per_step"] = {e: c.get(counter, 0) / STEPS
                                      for e, c in per.items()}
        if r["launches"] == 0:
            raise AssertionError(f"{name} never launched on the main path")
        kernels.append(r)
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels,
                      "step_ms": {k: steady_median(v)
                                  for k, v in step_ms.items()},
                      "main_path_peak_bytes": path_peak,
                      "crf_ms": crf_ms,
                      "xlstm_peak_bytes": x_peak,
                      "qwen3_peak_bytes": q_peak,
                      "mixtral_peak_bytes": m_peak,
                      "configs_peak_bytes": c_peak,
                      "remat_backward": dots,
                      "depths": {XLSTM: {"fused": X_LAYERS, "scheduled": XS_LAYERS},
                                 QWEN: Q_LAYERS, MIXTRAL: M_LAYERS, **c_depths},
                      "device_split": {XLSTM: x_split, QWEN: q_split,
                                       MIXTRAL: m_split, **c_split},
                      "serving": serving}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
