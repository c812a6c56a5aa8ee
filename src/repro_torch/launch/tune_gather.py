"""Device time of the K1/K2 gather matmul under every tile and split choice.

    PYTHONPATH=src python -m repro_torch.launch.tune_gather [--reps 50] [--out FILE]

For each K1/K2 call shape of the main paths (zaremba-medium: M=20, k=325,
4H=2600, T=1 and 35; luong-nmt: M=64, k=358, 4H=2048, T=1 and 50; FP and
BP), launches ``csrc/gather_matmul.cu`` directly with each column tile and
cluster split (1, 2, 4, 8) the kernel takes and prints the mean device time
of one launch from ``torch.profiler`` (operands warm in L2, random data
and ids from seed 0), marking the plan ``_plan`` picks and the fastest.
First it prints ptxas's registers and spills per instantiation and the
device time of a one-CTA launch. CUDA only.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import gather_matmul as gm

SHAPES = [(arch, mode, T, M, *((k, n) if mode == "fp" else (n, k)))
          for arch, M, k, n, Ts in (("zaremba-medium", 20, 325, 2600, 35),
                                     ("luong-nmt", 64, 358, 2048, 50))
          for T in (1, Ts) for mode in ("fp", "bp")]


def device_ms(fn, reps: int, tries: int = 3) -> float:
    """Mean device time of the kernels one call of ``fn`` launches. The
    profiler has been seen to drop kernel records on the card; a run whose
    kernel counts are not a multiple of ``reps`` is taken again."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [(getattr(e, "self_device_time_total", 0.0), e.count)
                for e in prof.key_averages()
                if getattr(e, "device_type", None) == DeviceType.CUDA]
        if rows and all(n % reps == 0 for _, n in rows):
            return sum(us for us, _ in rows) / reps / 1e3
    raise RuntimeError(f"the profiler lost kernel records in {tries} runs")


def ptxas_report(log: str):
    """[(mode, bm, bn, tn, va, vb, ag, registers, spill bytes)] from ptxas's -v
    output for each instantiation of the kernel."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"gather_mm_kernelILi(\d)ELi(\d+)ELi(\d+)ELi(\d)ELb(\d)ELb(\d)ELb(\d)E", line)
        if "Compiling entry function" in line:
            cur = tuple(int(x) for x in m.groups()) if m else None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out.append((*cur, int(m.group(1)), spill))
            cur = None
    return out


def candidates(mode, T, M, C, O):
    """(bm, bn, split, csplit) for every tile the kernel has for ``mode``
    (the csrc's dispatch_tile) and every cluster split of 1, 2, 4, 8."""
    bm = 20 if M <= 20 else 64
    widths = {"fp": (32, 64, 128) if bm == 64 else (32, 64), "bp": (16, 32)}[mode]
    for bn in widths:
        for want in (1, 2, 4, 8):
            csplit = C if want == 1 else 4 * math.ceil(math.ceil(C / want) / 4)
            split = math.ceil(C / csplit)
            if split == want:
                yield bm, bn, split, csplit


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default="")
    ap.add_argument("--only", default="", help="e.g. 'T=35,T=50': shapes whose "
                    "label contains one of these")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("tune_gather runs on a CUDA device only")
    from repro_torch.device import set_full_fp32
    set_full_fp32()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    gen = torch.Generator().manual_seed(0)
    lib = gm._lib()
    sms = gm._sms(0)
    from repro_torch.kernels import _build
    regs = ptxas_report(_build.BUILD_LOG.get("gather_matmul", ""))
    for mode, bm, bn, tn, va, vb, ag, r, spill in regs:
        print(f"ptxas: mode {mode} bm {bm} bn {bn} tn {tn} copies a {16 if va else 4} "
              f"b {16 if vb else 4} bytes{' a gathered' if ag else ''}: {r} registers, "
              f"{spill} bytes spilled")
    results = []
    # the floor: one CTA of one chunk (M = 1, C = O = 4)
    tiny = [torch.zeros(1, 1, 4, device="cuda"), torch.zeros(4, 4, device="cuda"),
            torch.arange(4, dtype=torch.int32, device="cuda"),
            torch.empty(1, 1, 4, device="cuda")]
    tp = (ctypes.c_int * 15)(0, 1, 1, 4, 4, 4, 4, 0, 0, 20, 32, 1, 4, 0, 0)

    def tiny_call():
        code = lib.gather_matmul_f32(tp, *(x.data_ptr() for x in tiny), 1.0,
                                     torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"the one-CTA plan was refused: {code}")

    floor = device_ms(tiny_call, args.reps)
    print(f"floor (one CTA of one chunk, M = 1, C = O = 4): {floor:.4f} ms")
    for arch, mode, T, M, C, O in SHAPES:
        label = f"{arch} {mode} T={T} M={M} C={C} O={O}"
        if args.only and not any(w in label for w in args.only.split(",")):
            continue
        k, N = (C, O) if mode == "fp" else (O, C)
        Hh = N // 4
        W = torch.randn(Hh, N, generator=gen).cuda()
        ids = torch.stack([torch.sort(torch.randperm(Hh, generator=gen)[:k]).values
                           for _ in range(T)]).to(torch.int32).cuda()
        a = torch.randn(T, M, k if mode == "fp" else N, generator=gen).cuda()
        y = torch.empty(T, M, O, device="cuda")
        va = mode == "bp" or k % 4 == 0
        chosen = gm._plan(mode, T, M, C, O, va, True, sms)
        stream = torch.cuda.current_stream().cuda_stream
        rows = []
        for bm, bn, split, csplit in candidates(mode, T, M, C, O):
            pv = va if mode == "bp" else False
            params = (ctypes.c_int * 15)(gm._MODES[mode], T, M, C, O, a.shape[2], N,
                                         0 if T == 1 else k, 0, bm, bn, split,
                                         csplit, int(pv), 1)

            def fn(params=params):
                code = lib.gather_matmul_f32(params, a.data_ptr(), W.data_ptr(),
                                             ids.data_ptr(), y.data_ptr(), 1.0, stream)
                if code:
                    raise RuntimeError(f"plan {bm, bn, split} refused: {code}")

            ms = device_ms(fn, args.reps)
            ctas = math.ceil(O / bn) * split * math.ceil(M / bm) * T
            pick = (bn, split) == (chosen.bn, chosen.split)
            rows.append(dict(bm=bm, bn=bn, split=split, ctas=ctas,
                             device_ms=ms, chosen=pick))
        best = min(rows, key=lambda r: r["device_ms"])
        for r in rows:
            print(f"{label}: bm {r['bm']} bn {r['bn']:3d} "
                  f"split {r['split']} ctas {r['ctas']:5d}: {r['device_ms']:.4f} ms"
                  f"{'  <- _plan' if r['chosen'] else ''}{'  (fastest)' if r is best else ''}")
        results.append(dict(arch=arch, mode=mode, T=T, M=M, C=C, O=O, rows=rows))
    out = dict(card=card, ptxas=regs, floor_ms=floor, results=results)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
