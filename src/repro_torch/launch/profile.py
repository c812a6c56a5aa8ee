"""Where the time of a training step goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile --arch zaremba-medium \
        --batch 20 --seq 35 --dropout case3:0.5:pallas --engine fused
    PYTHONPATH=src python -m repro_torch.launch.profile --arch luong-nmt \
        --batch 64 --seq 50 --dropout case3:0.3:pallas --engine fused
    PYTHONPATH=src python -m repro_torch.launch.profile --arch bilstm-ner \
        --batch 32 --seq 64 --dropout case3:0.5:pallas --engine fused
    PYTHONPATH=src python -m repro_torch.launch.profile --arch xlstm-1.3b \
        --layers 16 --batch 2 --seq 2048 --dropout case3:0.25:bs64:pallas \
        --engine fused --steps 2
    PYTHONPATH=src python -m repro_torch.launch.profile --arch qwen3-8b \
        --layers 4 --batch 1 --seq 4096 --variant qwen3_flash --steps 2
    PYTHONPATH=src python -m repro_torch.launch.profile --arch mixtral-8x22b \
        --layers 1 --batch 1 --seq 4096 --variant mixtral_pallas --steps 2

``--variant`` applies one of ``VARIANTS`` to the config, as the reference's
``launch/perf.py`` experiments do (``qwen3_flash``: ``attn_impl="flash"``;
``mixtral_pallas``: flash attention and the expert products on K12;
``mixtral_xla``: flash attention, the expert products as ``torch.matmul``).
Runs a few warm-up steps, then traces ``--steps`` training steps with
``torch.profiler`` (CPU and CUDA activities) and prints: the host wall time
per step (ending in a device synchronisation), the device-busy time per
step (the sum of kernel, copy and memset durations on the card; one stream,
so they do not overlap), the idle share, the kernels that take the most
device time, the device time per group (each of the port's own kernels,
the library's matrix products, the rest), and the host time to sample one
step's dropout masks. The
last line is the same as one JSON object. CUDA only. ``trace_steps`` is the
tracing part, for a caller that has its own step (chip_smoke.py).
"""
from __future__ import annotations

import dataclasses
import functools
import glob
import json
import os
import re
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.launch import steps as steps_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import lstm_lm, seq2seq, tagger, transformer, xlstm

VARIANTS = {
    "qwen3_flash": lambda c: dataclasses.replace(c, attn_impl="flash"),
    "mixtral_pallas": lambda c: dataclasses.replace(c, attn_impl="flash",
                                                    moe_impl="pallas"),
    "mixtral_xla": lambda c: dataclasses.replace(c, attn_impl="flash",
                                                 moe_impl="xla"),
}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


@functools.lru_cache(maxsize=None)
def port_kernels() -> frozenset:
    """The ``__global__`` function names of the port's csrc/*.cu sources."""
    csrc = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\("
                     r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")
    names = set()
    for path in glob.glob(os.path.join(csrc, "*.cu")):
        with open(path) as f:
            names.update(pat.findall(f.read()))
    return frozenset(names)


def kernel_group(name: str) -> str:
    """The port's kernels (each in the top-level anonymous namespace of its
    csrc/*.cu) by their function name; cuBLAS/CUTLASS products as "matrix
    products"; everything else (PyTorch's own kernels, some of which sit in
    an anonymous namespace too) as "other". cuBLAS's own Hopper kernels
    are named ``nvjet_*``, with no "gemm" in the name."""
    tag = "(anonymous namespace)::"
    name = name.removeprefix("void ")     # a template kernel's name has it
    if name.startswith(tag):
        fn = name[len(tag):].split("<", 1)[0].split("(", 1)[0]
        if fn in port_kernels():
            return fn
    gemm = "gemm" in name.lower() or name.startswith("nvjet")
    return "matrix products" if gemm else "other"


def sampling_host_ms(kind: str, cfg, batch: int, seq: int, seed: int,
                     reps: int = 5) -> float:
    """Host ms to draw every mask a training step consumes (the model's
    ``dropout_sites``: the non-recurrent applications, per layer index where
    the model draws them so, and each recurrence's schedules), median of
    ``reps``; the copies to the card are asynchronous
    and not waited for."""
    sites = {"nmt": lambda: seq2seq.dropout_sites(cfg, batch, seq, seq),
             "xlstm": lambda: xlstm.dropout_sites(cfg, batch, seq),
             "transformer": lambda: transformer.dropout_sites(cfg, batch, seq),
             "lstm_lm": lambda: lstm_lm.dropout_sites(cfg, batch, seq),
             "tagger": lambda: tagger.dropout_sites(cfg, batch, seq)}[kind]()
    times = []
    for step in range(reps):
        t0 = time.perf_counter()
        ctx = cfg.plan.bind(seed, step, device="cuda")
        for name, how, steps, b, dim in sites:
            if how == "schedule":
                ctx.schedule(name, steps, b, dim)
            else:
                ctx.state(name, b, dim, t=steps if how == "state_t" else None)
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return sorted(times)[len(times) // 2]


class NoDeviceTime(RuntimeError):
    """The profiler recorded no device time for a traced run: its CUDA
    activity records were lost (seen on the card), not a fault of the step."""


def trace_steps(step_fn, params, state, batch_fn, n_steps: int, seed: int,
                top: int = 12, label: str = ""):
    """Trace ``n_steps`` calls of ``step_fn`` (``launch.steps`` signature)
    with ``torch.profiler`` and print the step's device-time split: host
    wall and device-busy ms a step, the idle share, the ``top`` kernels and
    the groups (``kernel_group``). Returns (params, state, report dict)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for step in range(n_steps):
            params, state, loss = step_fn(params, state, batch_fn(step), step, seed)
            float(loss)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_steps * 1e3
    # device-side events only (kernels, copies, memsets): CPU ops also carry
    # their kernels' time and would count it twice
    rows = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    rows = [r for r in rows if r[1] > 0]
    if not rows:
        raise NoDeviceTime("the profiler recorded no device time")
    busy = sum(r[1] for r in rows) / n_steps / 1e3
    rows.sort(key=lambda r: -r[1])
    print(f"{label}: wall {wall:.3f} ms/step, device busy "
          f"{busy:.3f} ms/step, idle share {max(0.0, 1 - busy / wall):.3f}")
    tops = []
    for name, us, count in rows[:top]:
        ms = us / n_steps / 1e3
        print(f"  {ms:9.4f} ms/step  {count / n_steps:7.1f} calls/step  {name[:90]}")
        tops.append({"name": name[:120], "ms_per_step": ms,
                     "calls_per_step": count / n_steps})
    groups = {}
    for name, us, _ in rows:
        g = kernel_group(name)
        groups[g] = groups.get(g, 0.0) + us / n_steps / 1e3
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  group {g}: {ms:.3f} ms/step ({ms / busy:.3f} of busy)")
    report = {"engine": label, "wall_ms": wall, "busy_ms": busy,
              "idle_share": max(0.0, 1 - busy / wall), "top": tops,
              "groups_ms": groups}
    return params, state, report


def main(argv=None) -> dict:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--variant", default="", choices=["", *VARIANTS])
    own, rest = ap.parse_known_args(argv)
    args = train_mod.parse_args(rest)
    if not torch.cuda.is_available() or (args.device or "cuda") != "cuda":
        raise RuntimeError("profile runs on a CUDA device only")
    res = train_mod.run(rest + ["--steps", str(own.warmup), "--log-every", "1000"],
                        cfg_fn=VARIANTS.get(own.variant))
    # continue from the warmed-up parameters for the traced steps
    cfg, params = res["cfg"], res["params"]
    spec = train_mod.configs.get_arch(args.arch)
    opt = steps_mod.default_opt(args.lr)
    state = opt.init(params)
    step_fn = steps_mod.make_train_step(spec, cfg, opt,
                                        use_dropout=not args.no_dropout)
    batch_fn = train_mod.make_batch_fn(spec.kind, cfg, args.batch, args.seq,
                                       args.seed,
                                       torch.device("cuda"))
    # the recurrent engine, or the attention of a transformer
    label = getattr(cfg, "engine", None) or f"attn_impl={cfg.attn_impl}"
    if getattr(cfg, "moe", None) is not None:
        label += f" moe_impl={cfg.moe_impl}"
    _, _, out = trace_steps(step_fn, params, state, batch_fn, args.steps,
                            args.seed, top=own.top, label=label)
    sampling = sampling_host_ms(spec.kind, cfg, args.batch, args.seq, args.seed)
    print(f"  host time to sample one step's dropout masks: {sampling:.3f} ms")
    out.update(sampling_host_ms=sampling, device=torch.cuda.get_device_name(0))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
