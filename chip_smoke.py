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
    small inputs);
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
    memory);
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
    inputs);
  * mixtral-8x22b (the expert products over the (8 experts x 1280 slots)
    capacity buffer: x (10240, 6144) by w (8, 6144, 16384), and x (10240,
    16384) by w (8, 16384, 6144)): K12 grouped matmul, split-precision
    TF32 ("3xTF32") on the tensor cores, with ``torch.bmm`` on the (E, C,
    .) buffer timed as the library yardstick; both are held to a float64
    product over one row block by 256 columns, K12 within 1e-5 x max(1,
    |ref|) (float32's accuracy, which single-pass TF32 misses), and the
    float32 instantiation's SASS must hold TF32 HMMA instructions (also
    the reference test's four shapes in float32 and bfloat16, bm not a
    multiple of the tile, an empty expert, unsorted repeated ids and
    ragged T, D, F);
  * zaremba-medium's cell update (B=20, H=650, and H=1500): K5 fused LSTM
    pointwise, with forget_bias 0 and 1 and odd shapes.

Then it checks on small inputs that the kernel engines agree with the plain
stepwise oracle (the three recurrent models), that the qwen3 smoke config
with ``attn_impl="flash"`` agrees with ``attn_impl="xla"`` and the mixtral
smoke config with ``moe_impl="pallas"`` with ``"xla"``; runs the
``lstm_stack`` forward at zaremba-medium width (T=35, B=20, H=D=650, 2
layers, ``case3:0.5:pallas``) under ``torch.no_grad()`` with the scheduled
and stepwise engines, ``pointwise_impl="pallas"`` (K5) against ``"xla"``;
and drives each main path — the
training step of ``repro_torch.launch.train`` at full width, zaremba-medium
under ``case3:0.5:pallas`` and luong-nmt (batch 64, max_len 50) under
``case3:0.3:pallas``, and ``launch.steps.make_train_step`` on xlstm-1.3b
cut to 16 blocks (batch 2 x 2048, its own plan with ``impl="pallas"``)
with the fused and the scheduled engine, and qwen3-8b cut to 4 layers
(batch 1 x 4096, its own plan) with ``attn_impl="flash"`` and then
``"xla"``, and mixtral-8x22b cut to 1 of 56 layers (float32, batch 1 x
4096, its own plan, flash attention) with ``moe_impl="pallas"`` and then
``"xla"`` — asserting that every kernel's launch counter grew in that
path's run (and that K6, WG included, did not launch under the scheduled engine, nor
K9-K11 under xla, nor K12 under the mixtral xla route).

K1/K2 rows carry the kernel's and the library call's device time from
``torch.profiler`` (``device_ms``, ``library_device_ms``) beside their
CUDA-event times, and the wrapper's launch plan; the cluster-split K1 BP
is launched twice at the zaremba-medium shape and must give the same bits.

Prints the card's name and power limit, one JSON line of per-kernel
numbers, and as its last line ``{"ok": true, "device": {...}}``. Exits non-zero
(and prints no result) without a CUDA device, outside the repository, or on
any failed phase. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

# Peaks of one H100 SXM (NVIDIA data sheet, 700 W), used only for the
# bound_ms column: float32 outside the tensor cores, HBM3 bandwidth, and
# dense TF32 on the tensor cores (K12's route).
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12
TF32_FLOPS = 495e12

T, B, H, D, P = 35, 20, 650, 650, 0.5          # zaremba-medium
NT_, NB, NH, NS, NP = 50, 64, 512, 50, 0.3      # luong-nmt: T=S, B, H=E, p
XT, XB, XNH, XDH, XBS, XP = 2048, 2, 4, 512, 64, 0.25   # xlstm-1.3b sLSTM
X_LAYERS = 16                                           # depth cut from 48
QB, QS, QHQ, QHKV, QD = 1, 4096, 32, 16, 128   # qwen3-8b attention (kv_repeat 2)
Q_LAYERS = 4                                    # depth cut from 36
MB, MS, MD, MF, ME, MK = 1, 4096, 6144, 16384, 8, 2   # mixtral-8x22b
MC = math.ceil(MB * MS * MK / ME * 1.25)              # capacity: 1280 slots
M_LAYERS = 1                                          # depth cut from 56
STEPS = 5
LM, NMT, XLSTM, QWEN = "zaremba-medium", "luong-nmt", "xlstm-1.3b", "qwen3-8b"
MIXTRAL, STACK = "mixtral-8x22b", "lstm_stack"


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


def device_ms(fn, reps: int = 20, warmup: int = 3, cold_l2: bool = False) -> float:
    """Mean device time of the kernels one call of ``fn`` launches, from
    ``torch.profiler`` over ``reps`` calls (with ``cold_l2`` each after the
    same flush as ``time_ms``, whose own kernels are left out)."""
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
    # the profiler has been seen to drop kernel records on the card: a run
    # whose kernel counts are not a multiple of reps is taken again
    for _ in range(3):
        with profile(activities=acts) as prof:
            for _ in range(reps):
                if cold_l2:
                    _flush_buf.fill_(1.0)
                fn()
            torch.cuda.synchronize()
        rows = [v for k_, v in kernels(prof).items() if k_ not in flush]
        if rows and all(n % reps == 0 for _, n in rows):
            return sum(us for us, _ in rows) / reps / 1e3
    raise RuntimeError("the profiler lost kernel records in 3 runs")


def bound_ms(nbytes: float, flops: float, rate: float = F32_FLOPS):
    tb, tf = nbytes / HBM_BYTES * 1e3, flops / rate * 1e3
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
                        extras=True):
    from repro_torch.kernels import gather_matmul as gm
    k = H - math.ceil(P * H)
    U = torch.randn(H, 4 * H, generator=gen).cuda() * 0.05
    W = torch.randn(D, 4 * H, generator=gen).cuda() * 0.05
    kb1 = keep_table(gen, 1, H, P)[0]
    kbT = keep_table(gen, T, D, P)
    scale = H / k
    uniq = int(torch.unique(kbT).numel())
    print(f"K1/K2 gather_matmul ({arch}): M={B} k={k} N={4 * H} T={T} "
          f"(rows of W kept at some step: {uniq})")

    def row(name, route_src, replaces, got, want, tol, fn, plain, lib,
            nbytes, flops, cold_l2, plan):
        err = compare(row_name(name, arch), got, want, tol)
        ms = time_ms(fn, cold_l2=cold_l2)
        pms = time_ms(plain, cold_l2=cold_l2)
        lms = time_ms(lib, cold_l2=cold_l2)
        # device time beside the event time: the difference is the host's
        dms = device_ms(fn, cold_l2=cold_l2)
        ldms = device_ms(lib, cold_l2=cold_l2)
        add_row(out, name, arch, route_src, replaces, err, ms, pms, lms,
                nbytes, flops, "cold" if cold_l2 else "warm", device_ms=dms,
                library_device_ms=ldms,
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


def scan_inputs(gen, T_, B_, H_, rate, mode, fixed=False, ragged=False):
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
        lengths = torch.randint(0, T_ + 1, (B_,), generator=gen,
                                dtype=torch.int32).cuda()
    dy = torch.randn(T_, B_, H_, generator=gen).cuda()
    dcT = torch.randn(B_, H_, generator=gen).cuda()
    return gx, U, h0, c0, ids, mask, lengths, scale, dy, dcT


def check_scan(gen, T_, B_, H_, rate, mode, *, fixed=False, ragged=False,
               out=None, tag="", arch=LM):
    from repro_torch.kernels import cell_scan as cs_mod
    from repro_torch.kernels import lstm_scan as ls
    cell = ls.lstm_cell_spec(0.0)
    gx, U, h0, c0, ids, mask, lengths, scale, dy, dcT = scan_inputs(
        gen, T_, B_, H_, rate, mode, fixed, ragged)
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
    if out is None:
        return
    k = ids.shape[1] if ids is not None else H_
    uniq = int(torch.unique(ids).numel()) if ids is not None else H_
    G = 4 * H_
    src = "src/repro_torch/csrc/lstm_scan.cu"
    for name, fk, fp, err, nbytes, flops, rep in (
            ("lstm_scan_fwd", fwd_k, fwd_p, e_f,
             4 * (T_ * B_ * G + uniq * G + 2 * B_ * H_ + T_ * k
                  + 2 * T_ * B_ * H_ + T_ * B_ * G),
             2 * T_ * B_ * k * G, "src/repro/kernels/cell_scan.py:172"),
            ("lstm_scan_bwd", bwd_k, bwd_p, e_b,
             4 * (T_ * B_ * H_ + B_ * H_ + T_ * B_ * G + 2 * T_ * B_ * H_
                  + 2 * B_ * H_ + uniq * G + T_ * k
                  + T_ * B_ * G + H_ * G + 2 * B_ * H_),
             4 * T_ * B_ * k * G, "src/repro/kernels/cell_scan.py:215")):
        # once per layer and step, after other work: timed with a cold L2
        ms = time_ms(fk, cold_l2=True)
        pms = time_ms(fp, reps=5, warmup=1, cold_l2=True)
        add_row(out, name, arch, src, rep, err, ms, pms, None, nbytes, flops,
                "cold")


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
    e_f = compare("  decoder_scan_fwd " + tag, fwd_k(), res, 1e-3)
    bargs = (descs, tables, res, dout, o["us"], o["ws"], o["w_feed"], o["w_comb"],
             o["enc_proj"], o["enc_out"], o["h0"], o["c0"], o["feed0"], lengths)
    flat = lambda g: [x for v in g for x in (v if isinstance(v, list) else [v])]
    bwd_k = lambda: ds.kernel_bwd(*bargs)
    bwd_p = lambda: ds.plain_bwd(*bargs)
    e_b = compare("  decoder_scan_bwd " + tag, flat(bwd_k()), flat(bwd_p()), 1e-3)
    if out is None:
        return
    # the work this call's data needs: kept rows per site, kept units per step
    nl, G, H2 = 2, 4 * H_, 2 * H_
    kept = [H_ if t_ is None or d.mode == "dense" else t_.shape[1]
            for d, t_ in zip(descs, tables)]
    uniq = [H_ if t_ is None or d.mode == "dense" else int(torch.unique(t_).numel())
            for d, t_ in zip(descs, tables)]
    ids = sum(0 if t_ is None else t_.numel() for t_ in tables)
    att = 2 * B_ * S_ * H_
    f_flops = T_ * (sum(2 * B_ * k * G for k in kept) + 2 * att + 2 * B_ * H2 * H_)
    b_flops = T_ * (sum(4 * B_ * k * G for k in kept) + 5 * att
                    + 2 * (2 * B_ * H2 * H_))
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
    src = "src/repro_torch/csrc/decoder_scan.cu"
    for name, fk, fp, err, nbytes, flops, rep in (
            ("decoder_scan_fwd", fwd_k, fwd_p, e_f, f_bytes, f_flops,
             "src/repro/kernels/decoder_scan.py:413"),
            ("decoder_scan_bwd", bwd_k, bwd_p, e_b, b_bytes, b_flops,
             "src/repro/kernels/decoder_scan.py:598")):
        # once per training step, after other work: timed with a cold L2
        ms = time_ms(fk, cold_l2=True)
        pms = time_ms(fp, reps=3, warmup=1, cold_l2=True)
        add_row(out, name, NMT, src, rep, err, ms, pms, None, nbytes, flops,
                "cold")


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
                ragged=False, fresh=False, mask_heads=1, out=None, tag=""):
    """K6 forward (hs, gates, c, n, m) and backward (dxg, dR, dh0, dc0, dn0,
    dm0; the scan, then dR from the WG kernel) against the plain cell_scan
    with SLSTM_CELL on the same inputs, and a second launch of each for the
    same bits. At the main path (``out``) also against a float64 run of the
    plain versions, beside the float32 plain version's distance to it, and
    the WG kernel alone against its plain version."""
    from repro_torch.kernels import cell_scan as cs_mod
    from repro_torch.kernels import slstm_scan as ss
    gx, R, h0, st0, ids, mask, lengths, scale, dy, dstT = slstm_inputs(
        gen, T_, B_, NH_, dh_, rate, mode, bs, fixed, ragged, fresh, mask_heads)
    rh = (ids, mask, lengths, scale)
    fwd_k = lambda: ss.slstm_scan_fwd_cuda(gx, R, h0, st0, *rh)
    fwd_p = lambda: cs_mod.plain_fwd(ss.SLSTM_CELL, gx, R, h0, st0, *rh)
    hs, gates, sts = fwd_k()
    hs_p, gates_p, sts_p = fwd_p()
    print(f"slstm_scan T={T_} B={B_} heads={NH_} dh={dh_} {mode}"
          f"{' FIXED' if fixed else ''}{' ragged' if ragged else ''}"
          f"{' fresh' if fresh else ' handoff'}")
    e_f = compare("  slstm_scan_fwd " + tag, [hs, gates, *sts],
                  [hs_p, gates_p, *sts_p], 1e-3)
    saved = (gates_p, sts_p, st0, hs_p, h0, R)
    bwd_k = lambda: ss.slstm_scan_bwd_cuda(dy, dstT, *saved, *rh)
    bwd_p = lambda: cs_mod.plain_bwd(ss.SLSTM_CELL, dy, dstT, *saved, *rh)
    dgx, dR, dh0, dst0 = bwd_k()
    dgx_p, dR_p, dh0_p, dst0_p = bwd_p()
    e_b = compare("  slstm_scan_bwd " + tag, [dgx, dR, dh0, *dst0],
                  [dgx_p, dR_p, dh0_p, *dst0_p], 1e-3)
    same_bits("  slstm_scan_fwd/bwd second launch " + tag,
              [hs, gates, *sts, dgx, dR, dh0, *dst0],
              lambda: (*(lambda o: (o[0], o[1], *o[2]))(fwd_k()),
                       *(lambda o: (o[0], o[1], o[2], *o[3]))(bwd_k())))
    if out is None:
        return
    # float64 runs of the plain versions: the backward's on the float32
    # forward's residuals, so that each measures its own rounding
    d = lambda t: t.double()
    ref_f = cs_mod.plain_fwd(ss.SLSTM_CELL, d(gx), d(R), d(h0), tuple(map(d, st0)), *rh)
    ref_b = cs_mod.plain_bwd(ss.SLSTM_CELL, d(dy), tuple(map(d, dstT)), d(gates_p),
                             tuple(map(d, sts_p)), tuple(map(d, st0)), d(hs_p), d(h0),
                             d(R), *rh)
    f64_gate("  slstm_scan_fwd " + tag, [hs, gates, *sts], [hs_p, gates_p, *sts_p],
             [ref_f[0], ref_f[1], *ref_f[2]])
    f64_gate("  slstm_scan_bwd " + tag, [dgx, dR, dh0, *dst0],
             [dgx_p, dR_p, dh0_p, *dst0_p], [ref_b[0], ref_b[1], ref_b[2], *ref_b[3]])
    del ref_f, ref_b
    # WG alone on the plain scan's dgx, with the wrapper's own tables
    tables = ss.wg_tables(ids, T_, dh_, gx.device)
    wg_k = lambda: ss.slstm_wg(dgx_p, hs_p, h0, tables, mask, scale)
    wg_p = lambda: ss.plain_wg(dgx_p, hs_p, h0, tables, mask, scale)
    dR_w = wg_k()
    e_w = compare("  slstm_wg " + tag, dR_w, wg_p(), 1e-3)
    # the library yardstick: one torch.bmm over the heads on masked operands
    hp = torch.cat([h0[None], hs_p[:-1]])
    hp = hp * tables[2][:, None, None, :] if ids is not None else hp
    hp_t = hp.permute(2, 3, 0, 1).reshape(NH_, dh_, T_ * B_).contiguous()
    dg_t = dgx_p.permute(2, 0, 1, 3).reshape(NH_, T_ * B_, 4 * dh_).contiguous()
    wg_lib = lambda: torch.bmm(hp_t, dg_t)
    # float32's accuracy (3xTF32): head 0 x 256 columns against a float64
    # product of the same masked operands, torch.bmm's distance beside it
    sc = scale if ids is not None else 1.0
    ref = (hp_t[0].double() @ dg_t[0, :, :256].double()) * sc
    w_f64 = compare("  slstm_wg " + tag + " vs float64, head 0 x 256", dR_w[0, :, :256],
                    ref, 1e-5) / max(1.0, ref.abs().max().item())
    w_lib_f64 = ((wg_lib()[0, :, :256].double() * sc - ref).abs().max().item()
                 / max(1.0, ref.abs().max().item()))
    print(f"  torch.bmm vs float64, head 0 x 256: max_rel_err {w_lib_f64:.3e} "
          f"(the yardstick's own)")
    del ref, dR_w
    hmma = sass_hmma("slstm_scan")
    wg_syms = [tf for sym, (tf, _) in hmma.items() if "slstm_wg_kernel" in sym]
    if not wg_syms or not all(wg_syms):
        raise AssertionError("slstm_wg_kernel: no TF32 HMMA in its SASS")
    # the work this call's data needs: k kept units a step, R rows kept at
    # some step
    k = ids.shape[1] if ids is not None else dh_
    uniq = int(torch.unique(ids).numel()) if ids is not None else dh_
    G, st = 4 * dh_, B_ * NH_ * dh_
    idsz = 0 if ids is None else ids.numel()
    f_bytes = 4 * (T_ * B_ * NH_ * G + NH_ * uniq * G + 4 * st + idsz
                   + 4 * T_ * st + T_ * B_ * NH_ * G)
    b_bytes = 4 * (T_ * st + 3 * st + T_ * B_ * NH_ * G + 3 * T_ * st + 3 * st
                   + T_ * st + st + NH_ * uniq * G + idsz
                   + T_ * B_ * NH_ * G + NH_ * dh_ * G + 4 * st)
    kept_steps = int(tables[1].sum()) * ss.WG_UNITS if ids is not None else T_ * dh_
    w_bytes = 4 * (T_ * st + st + T_ * B_ * NH_ * G + NH_ * dh_ * G
                   + tables[0].numel() + tables[1].numel()
                   + sum(0 if x is None else x.numel() for x in tables[2:]))
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
                "cold", rate=rate, **extra)


def same_bits(name, first, again):
    """Fail unless a second launch (``again()``) gives the same bits."""
    ok = all(torch.equal(a, b) for a, b in zip(first, again()))
    print(f"  {name}: {'same bits' if ok else 'FAIL: bits differ'}")
    if not ok:
        raise AssertionError(f"{name}: a second launch gave other bits")


def f64_gate(name, got, plain, ref):
    """Distances to a float64 run, max |err| / max(1, |ref|) over a group:
    fail where the kernel's exceeds 10 x the float32 plain version's (the
    rounding yardstick) + 1e-6."""
    def dist(xs):
        return max((x.double() - r).abs().max().item() / max(1.0, r.abs().max().item())
                   for x, r in zip(xs, ref))
    dk, dp = dist(got), dist(plain)
    ok = dk <= 10 * dp + 1e-6
    print(f"  {name} vs float64: kernel {dk:.3e}, float32 plain {dp:.3e} "
          f"(gate 10 x plain + 1e-6)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: float64 distance {dk:.3e} beyond its gate")
    return dk


def check_flash(gen, B_, Sq_, Sk_, Hq_, Hkv_, d_, *, causal=True, window=None,
                dtype=torch.float32, out=None, tag=""):
    """K9 (o, lse), K10 (dq) and K11 (dk, dv) against their plain versions
    on the same inputs; both backward passes take the plain forward's lse
    and delta. float32 within 1e-3 x max(1, |ref|), bfloat16 within 3e-2
    (the reference's bf16 tolerance). With ``out`` (the main path's shape):
    K9 also against a float64 forward and K10 and K11 against a float64
    backward over one (batch, kv head) group within ``FLASH_F64_TOL``
    (SDPA's distances printed beside theirs), all three launched twice for
    the same bits, timed beside SDPA, and their SASS must hold TF32 HMMA at
    every head dim."""
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
    e9 = compare("  flash_fwd " + tag, list(fwd_k()), [o_p, lse_p], tol)
    e10 = compare("  flash_dq " + tag, dq_k(), dq_p(), tol)
    e11 = compare("  flash_dkv " + tag, list(dkv_k()), list(dkv_p()), tol)
    if out is None:
        return
    del o_p
    f64 = flash_f64(fa, q, k, v, do, causal, window)
    f64.update(flash_fwd_f64(fa, q, k, v, causal, window))
    same_bits("flash_fwd, flash_dq, flash_dkv second launch", [*fwd_k(), dq_k(), *dkv_k()],
              lambda: [*fwd_k(), dq_k(), *dkv_k()])
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
    lib_f, lib_b = sdpa_yardstick(q, k, v, do, causal)
    src = "src/repro_torch/csrc/flash_attention.cu"
    rep = "src/repro/kernels/flash_attention.py:"
    # on the TF32 tensor cores, three TF32 products for each float32
    # product (3xTF32)
    for name, fk, fp, err, nbytes, flops, lms, line in (
            ("flash_fwd", fwd_k, fwd_p, e9, qb + 2 * kb + qb + rows, 3 * 2 * prod,
             lib_f, "45"),
            ("flash_dq", dq_k, dq_p, e10, 3 * qb + 2 * kb + 2 * rows, 3 * 3 * prod,
             lib_b, "127"),
            ("flash_dkv", dkv_k, dkv_p, e11, 2 * qb + 4 * kb + 2 * rows,
             3 * 4 * prod, lib_b, "158")):
        # once per layer and pass, after other work: cold L2
        ms = time_ms(fk, cold_l2=True)
        pms = time_ms(fp, cold_l2=True)
        if name == "flash_fwd":
            extra = dict(f64_rel_err=f64[name], library_f64_rel_err=f64["sdpa_fwd"])
        else:
            extra = dict(f64_rel_err=f64[name], library_f64_rel_err=f64["sdpa"],
                         library_covers="flash_dq + flash_dkv (one backward)")
        add_row(out, name, QWEN, src, rep + line, err, ms, pms, lms, nbytes,
                flops, "cold", rate=TF32_FLOPS, **extra)


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


def sass_hmma(name):
    """{kernel symbol: [TF32 HMMA, all HMMA]} in the SASS of ``csrc/<name>.cu``'s
    library (``cuobjdump -sass``)."""
    from repro_torch.kernels import _build
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.lib_path(name))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    hmma, sym = {}, None
    for line in sass.splitlines():
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


def sdpa_yardstick(q, k, v, do, causal):
    """Cold-L2 times of ``scaled_dot_product_attention``'s forward and of
    its backward (dq, dk, dv together) on (B, H, S, d) views of the same
    inputs, grouped-query through ``enable_gqa``; used nowhere in the
    port."""
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                 enable_gqa=True)
    o = fwd()
    bwd = lambda: torch.autograd.grad(o, (qt, kt, vt), do.transpose(1, 2),
                                      retain_graph=True)
    return time_ms(fwd, cold_l2=True), time_ms(bwd, cold_l2=True)


def check_flash_modes(gen):
    """K9-K11 on small inputs: non-causal, windows, MQA, G = 4, sequences
    that are not multiples of the tile, Sq != Sk, head dims 16 / 64 / 256,
    bfloat16."""
    bf = torch.bfloat16
    for args, kw, tag in (
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
            ((1, 160, 160, 4, 2, 256), {}, "(d=256)"),
            ((2, 128, 128, 4, 2, 128), dict(dtype=bf), "(bf16)"),
            ((1, 100, 100, 4, 2, 64), dict(dtype=bf, window=32), "(bf16 window)")):
        check_flash(gen, *args, tag=tag, **kw)


def nmt_small_batch(cfg, dev):
    from repro_torch.data import synthetic
    d = synthetic.nmt_pairs(4, cfg.src_vocab, cfg.tgt_vocab, max_len=10, seed=1)
    return {k: torch.from_numpy(v).to(dev) for k, v in d.items()}


def check_engines_small(arch=LM):
    """On a small input, the kernel engines (fused, scheduled under
    :pallas) agree with the plain stepwise oracle (:xla) for loss and every
    gradient, on the card and against the CPU (1e-4 x max(1, |ref|)).
    xlstm's oracle runs in float64, with 1e-3 x max(1, |ref|): at this size
    its mLSTM cell amplifies float32 rounding to ~1e-4 of a gradient's
    largest entry, on the CPU and on the card alike."""
    from repro_torch import configs
    from repro_torch.configs import adapters
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.optim import tree_leaves
    spec = configs.get_arch(arch)
    plan = {LM: "case3:0.5:bs8", NMT: "case3:0.3:bs8", XLSTM: "case3:0.5:bs4"}[arch]
    g = torch.Generator().manual_seed(1)
    if arch != NMT:
        batch_cpu = {"tokens": torch.randint(0, 128, (4, 8), generator=g),
                     "labels": torch.randint(0, 128, (4, 8), generator=g)}
    else:
        batch_cpu = nmt_small_batch(spec.smoke(), "cpu")
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
    print(f"engines on a small input ({arch} smoke, {plan})")
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
)

NEED = {"fused": ("gather_matmul_stepped/fp", "gather_matmul_stepped/bp",
                  "lstm_scan_fwd", "lstm_scan_bwd"),
        "scheduled": ("gather_matmul/fp", "gather_matmul/bp",
                      "gather_matmul_stepped/fp", "gather_matmul_stepped/bp")}
NEED_NMT_FUSED = ("decoder_scan_fwd", "decoder_scan_bwd")
# per training step, as the code implies: luong-nmt fused launches K7 and K8
# once, K3/K4 once per encoder layer, K2 FP/BP for both encoder layers and
# the decoder's hoisted layer-0 NR
EXPECT_NMT_FUSED = {"decoder_scan_fwd": 1, "decoder_scan_bwd": 1,
                    "lstm_scan_fwd": 2, "lstm_scan_bwd": 2,
                    "gather_matmul_stepped/fp": 3, "gather_matmul_stepped/bp": 3}


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
            gmm.LAUNCHES, gmm.LAUNCHES_BY_SHAPE, k5.LAUNCHES)


def reset_counts():
    for d in _counters():
        for key in d:
            d[key] = 0


def read_counts():
    return {k_: v for d in _counters() for k_, v in d.items()}


def drive_main_path():
    """Each path's training step at full width with both engines; returns
    {arch: {engine: {counter: launches}}}, {"arch/engine": [ms]}."""
    from repro_torch.launch import train

    totals, step_ms = {}, {}
    for arch, batch, seq, plan, full_width in MAIN_PATHS:
        for engine in ("fused", "scheduled"):
            print(f"main path: {arch}, batch {batch}, seq {seq}, {plan}, "
                  f"engine {engine}, {STEPS} steps")
            reset_counts()
            res = train.run(["--arch", arch, "--batch", str(batch),
                             "--seq", str(seq), "--dropout", plan,
                             "--engine", engine, "--steps", str(STEPS),
                             "--seed", "0"])
            c = read_counts()
            assert full_width(res["cfg"]), res["cfg"]
            assert len(res["losses"]) == STEPS
            assert all(math.isfinite(x) for x in res["losses"]), res["losses"]
            assert all(torch.isfinite(p).all() for p in _leaves(res["params"]))
            need = NEED[engine] + (NEED_NMT_FUSED if (arch, engine) == (NMT, "fused") else ())
            missing = [key for key in need if c[key] == 0]
            assert not missing, f"{arch}/{engine}: kernels never launched: {missing}"
            print(f"  launches per step ({arch}/{engine}): "
                  + ", ".join(f"{k_}={v / STEPS:g}" for k_, v in c.items() if v))
            if (arch, engine) == (NMT, "fused"):
                off = {k_: (c[k_] / STEPS, n) for k_, n in EXPECT_NMT_FUSED.items()
                       if c[k_] != n * STEPS}
                print("  luong-nmt fused launches per step "
                      + ("as expected" if not off else f"differ from the expected: {off}"))
            totals.setdefault(arch, {})[engine] = c
            step_ms[f"{arch}/{engine}"] = res["ms"]
    return totals, step_ms


def drive_xlstm():
    """xlstm-1.3b at full width, cut to X_LAYERS blocks, batch XB x XT, its
    own plan (nr p=0.25 bs 128, rh p=0.25 bs 64) with impl="pallas", STEPS
    training steps per engine through ``steps.make_train_step`` with the
    trainer's batches. Returns {engine: counts}, {engine: [ms]},
    {engine: peak bytes}, and each run's losses."""
    from repro_torch import configs
    from repro_torch.configs import adapters
    from repro_torch.core.dropout_plan import DropoutPlan
    from repro_torch.launch import steps, train

    spec = configs.get_arch(XLSTM)
    base = spec.full(num_layers=X_LAYERS)
    plan = DropoutPlan({n: sp.with_(impl="pallas") for n, sp in base.plan.sites})
    dev = torch.device("cuda")
    totals, step_ms, peak, losses = {}, {}, {}, {}
    for engine in ("fused", "scheduled"):
        cfg = dataclasses.replace(base, plan=plan, engine=engine)
        assert (cfg.d_model, cfg.n_heads, cfg.dh_s, cfg.inner, cfg.vocab,
                cfg.conv_kernel, cfg.chunk, cfg.slstm_every) == (
                    2048, 4, 512, 4096, 50304, 4, 256, 8), cfg
        print(f"main path: {XLSTM}, {X_LAYERS} blocks, batch {XB}, seq {XT}, "
              f"plan {cfg.plan.to_dict()}, engine {engine}, {STEPS} steps")
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
        k6 = c["slstm_scan_fwd"] + c["slstm_scan_bwd"] + c["slstm_wg"]
        if engine == "fused":
            assert c["slstm_scan_fwd"] > 0 and c["slstm_scan_bwd"] > 0, c
            assert c["slstm_wg"] > 0, c
        else:
            assert k6 == 0, f"K6 launched under the scheduled engine: {c}"
        peak[engine] = torch.cuda.max_memory_allocated()
        print(f"  launches per step ({XLSTM}/{engine}): "
              + (", ".join(f"{k_}={v / STEPS:g}" for k_, v in c.items() if v)
                 or "none of the port's kernels")
              + f"; peak memory {peak[engine] / 2**30:.2f} GiB")
        totals[engine], step_ms[engine], losses[engine] = c, ms, ls_
        del params, state
    return totals, step_ms, peak, losses


def check_qwen_small():
    """On a small input, the qwen3 smoke config with ``attn_impl="flash"``
    (K9-K11) against ``attn_impl="xla"`` (the port's chunked attention) on
    the card, and both against the xla run on the CPU: loss and every
    gradient within 1e-4 x max(1, |ref|)."""
    from repro_torch import configs
    from repro_torch.configs import adapters
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import value_and_grad
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


def drive_transformer():
    """qwen3-8b at full width, cut to Q_LAYERS layers, float32, batch QB x
    QS, its own plan (nr p=0.25 block 128), remat "full": STEPS training
    steps through ``steps.make_train_step`` with the trainer's batches, with
    ``attn_impl="flash"`` (the main path: K9 twice a layer, forward and
    recompute, K10 and K11 once) and then with ``attn_impl="xla"`` (the
    step's yardstick, no kernel). Returns {impl: counts}, {impl: [ms]},
    {impl: peak bytes}."""
    from repro_torch import configs
    from repro_torch.configs import adapters
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps, train

    spec = configs.get_arch(QWEN)
    dev = torch.device("cuda")
    totals, step_ms, peak = {}, {}, {}
    for impl in ("flash", "xla"):
        cfg = spec.full(num_layers=Q_LAYERS, attn_impl=impl)
        assert (cfg.d_model, cfg.n_heads, cfg.n_kv_eff, cfg.hd, cfg.d_ff,
                cfg.vocab, cfg.remat) == (4096, QHQ, QHKV, QD, 12288, 151936,
                                          "full"), cfg
        print(f"main path: {QWEN}, {Q_LAYERS} layers, batch {QB}, seq {QS}, "
              f"plan {cfg.plan.to_dict()}, attn_impl {impl}, {STEPS} steps")
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
        if impl == "flash":
            missing = [k_ for k_, v in flash.items() if v == 0]
            assert not missing, f"flash kernels never launched: {missing}"
            want = {"flash_fwd": 2 * Q_LAYERS * STEPS,
                    "flash_dq": Q_LAYERS * STEPS, "flash_dkv": Q_LAYERS * STEPS}
            print("  flash launches per step "
                  + ("as expected" if flash == want else
                     f"differ from the expected {want}: {flash}"))
        else:
            assert not any(flash.values()), f"flash kernels launched under xla: {c}"
        peak[impl] = torch.cuda.max_memory_allocated()
        print(f"  launches per step ({QWEN}/{impl}): "
              + (", ".join(f"{k_}={v / STEPS:g}" for k_, v in c.items() if v)
                 or "none of the port's kernels")
              + f"; peak memory {peak[impl] / 2**30:.2f} GiB")
        totals[impl], step_ms[impl] = c, ms
        del params, state
    return totals, step_ms, peak


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
    torch.cuda.empty_cache()

    def small(T_, D_, F_, E_, bm, dtype=torch.float32, blk_=None, zero_rows=None,
              tag=""):
        gc_ = torch.Generator().manual_seed(T_ + D_)
        x = torch.randn(T_, D_, generator=gc_)
        if zero_rows is not None:
            x[zero_rows] = 0.0
        w = torch.randn(E_, D_, F_, generator=gc_) * D_ ** -0.5
        if blk_ is None:
            blk_ = torch.randint(0, E_, (-(-T_ // bm),), generator=gc_)
        args = (x.to("cuda", dtype), w.to("cuda", dtype),
                blk_.to(torch.int32).cuda())
        got = gm.grouped_matmul(*args, bm=bm)
        compare(f"  grouped_matmul T={T_} D={D_} F={F_} E={E_} bm={bm} {dtype} {tag}",
                got, gm.grouped_matmul_plain(*args, bm=bm),
                1e-3 if dtype == torch.float32 else 3e-2)
        if zero_rows is not None and not (got[zero_rows] == 0).all():
            raise AssertionError("grouped_matmul: rows holding no token are not zero")

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
    the plain version too)."""
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
                add_row(out, "lstm_pointwise", STACK,
                        "src/repro_torch/csrc/lstm_pointwise.cu",
                        "src/repro/kernels/lstm_pointwise.py:23", err, ms, pms,
                        lms, 4 * (B_ * 4 * H_ + B_ * H_ + 2 * B_ * H_),
                        16 * B_ * H_, "warm")   # ~16 float32 operations a unit


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
    from repro_torch.launch.steps import value_and_grad
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
    """mixtral-8x22b at full width, cut to M_LAYERS layer, float32, batch MB
    x MS (train_4k's sequence), its own plan (nr p=0.25 block 128), remat
    "full", flash attention: STEPS training steps through
    ``steps.make_train_step`` with the trainer's batches, with
    ``moe_impl="pallas"`` (the main path: K12 six times a layer, three
    expert products forward and three in the recompute) and then with
    ``"xla"`` (``torch.matmul``, the step's yardstick). Returns {impl:
    counts}, {impl: [ms]}, {impl: peak bytes}, {impl: losses}."""
    from repro_torch import configs
    from repro_torch.configs import adapters
    from repro_torch.launch import steps, train
    spec = configs.get_arch(MIXTRAL)
    dev = torch.device("cuda")
    totals, step_ms, peak, losses = {}, {}, {}, {}
    for impl in ("pallas", "xla"):
        cfg = spec.full(num_layers=M_LAYERS, attn_impl="flash", moe_impl=impl)
        assert (cfg.d_model, cfg.n_heads, cfg.n_kv_eff, cfg.hd, cfg.d_ff, cfg.vocab,
                cfg.moe.num_experts, cfg.moe.top_k, cfg.window, cfg.remat) == (
                    MD, 48, 16, 128, MF, 32768, ME, MK, 4096, "full"), cfg
        print(f"main path: {MIXTRAL}, {M_LAYERS} layer, batch {MB}, seq {MS}, "
              f"plan {cfg.plan.to_dict()}, moe_impl {impl}, flash, {STEPS} steps")
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
        want = {"grouped_matmul": 6 * k12, f"grouped_matmul/{MD}x{MF}": 4 * k12,
                f"grouped_matmul/{MF}x{MD}": 2 * k12,
                "flash_fwd": 2 * M_LAYERS * STEPS, "flash_dq": M_LAYERS * STEPS,
                "flash_dkv": M_LAYERS * STEPS}
        got = {k_: c.get(k_, 0) for k_ in want}
        assert got == want, f"{MIXTRAL}/{impl}: launches {got}, expected {want}"
        peak[impl] = torch.cuda.max_memory_allocated()
        print(f"  {n_params} parameters; launches per step ({MIXTRAL}/{impl}): "
              + ", ".join(f"{k_}={v / STEPS:g}" for k_, v in c.items() if v)
              + f"; peak memory {peak[impl] / 2**30:.2f} GiB")
        totals[impl], step_ms[impl], losses[impl] = c, ms, ls_
        del params, state
    rel = abs(losses["pallas"][0] - losses["xla"][0]) / abs(losses["xla"][0])
    print(f"  step-0 loss pallas {losses['pallas'][0]:.6f} vs xla "
          f"{losses['xla'][0]:.6f}: relative difference {rel:.3e} (limit 1e-4)")
    assert rel <= 1e-4, rel
    return totals, step_ms, peak, losses


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
          "K9 flash_fwd, K10 flash_dq, K11 flash_dkv, K12 grouped_matmul")

    gen = torch.Generator().manual_seed(0)
    rows = {}
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
    # qwen3-8b: K9-K11 at the attention's shape, then every mode on small
    # inputs
    check_flash(gen, QB, QS, QS, QHQ, QHKV, QD, out=rows, tag="(main path)")
    check_flash_modes(gen)
    # mixtral-8x22b: K12 at the expert products' shapes, then small modes;
    # K5 at zaremba-medium's cell
    check_grouped(rows)
    check_pointwise(rows)
    check_engines_small()
    check_engines_small(NMT)
    check_engines_small(XLSTM)
    check_qwen_small()
    check_mixtral_small()

    counts, step_ms = drive_main_path()
    counts[STACK] = drive_lstm_stack()
    gc.collect()
    torch.cuda.empty_cache()
    x_counts, x_ms, x_peak, _ = drive_xlstm()
    counts[XLSTM] = x_counts
    for engine, ms in x_ms.items():
        step_ms[f"{XLSTM}/{engine}"] = ms
        med = steady_median(ms)
        print(f"{XLSTM}/{engine}: steady median {med:.2f} ms/step, "
              f"{XB * XT / med * 1e3:.1f} tokens/s, peak memory "
              f"{x_peak[engine]} bytes ({x_peak[engine] / 2**30:.2f} GiB)")
    gc.collect()
    torch.cuda.empty_cache()
    q_counts, q_ms, q_peak = drive_transformer()
    counts[QWEN] = q_counts
    for impl, ms in q_ms.items():
        step_ms[f"{QWEN}/{impl}"] = ms
        med = steady_median(ms)
        print(f"{QWEN}/{impl}: steady median {med:.2f} ms/step, "
              f"{QB * QS / med * 1e3:.1f} tokens/s, peak memory "
              f"{q_peak[impl]} bytes ({q_peak[impl] / 2**30:.2f} GiB)")
    gc.collect()
    torch.cuda.empty_cache()
    m_counts, m_ms, m_peak, _ = drive_moe()
    counts[MIXTRAL] = m_counts
    for impl, ms in m_ms.items():
        step_ms[f"{MIXTRAL}/{impl}"] = ms
        med = steady_median(ms)
        print(f"{MIXTRAL}/{impl}: steady median {med:.2f} ms/step, "
              f"{MB * MS / med * 1e3:.1f} tokens/s, peak memory "
              f"{m_peak[impl]} bytes ({m_peak[impl] / 2**30:.2f} GiB)")
    for key, ms in step_ms.items():
        print(f"step ms ({key}): " + ", ".join(f"{x:.2f}" for x in ms))
    kernels = []
    for name, r in rows.items():
        arch = r.pop("arch")
        per = counts[arch]
        counter = r.pop("counter")
        r["launches"] = sum(c.get(counter, 0) for c in per.values())
        if arch == STACK:       # one lstm_stack forward per engine
            r["launches_per_call"] = {e: c.get(counter, 0) for e, c in per.items()}
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
                      "xlstm_peak_bytes": x_peak,
                      "qwen3_peak_bytes": q_peak,
                      "mixtral_peak_bytes": m_peak}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
