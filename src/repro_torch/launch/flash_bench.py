"""K9, K10 and K11, the flash forward and backward, at qwen3-8b's attention
shape on the card.

    PYTHONPATH=src python -m repro_torch.launch.flash_bench [--src NAME=FILE.cu ...]

At B=1, S=4096, 32 query over 16 kv heads, d=128, causal, float32: each
build's float64 distances over one (batch, kv head) group (forward:
``chip_smoke.flash_fwd_f64``, backward: ``chip_smoke.flash_f64``, each of
which fails beyond its gate) and its K9, K10 and K11 times (CUDA events,
cold L2, median of 20), the builds taken in turns (a, b, ..., b, a) twice.
The builds are ``csrc/flash_attention.cu`` ("repo") and each ``--src``,
e.g. another commit's copy of that file, compiled with the same nvcc
flags, so that two versions are compared inside one call. Beside them
``scaled_dot_product_attention``'s forward and backward, timed and held to
the same float64 results: with ``enable_gqa`` (the yardstick of
``chip_smoke.py``; PyTorch serves float32 GQA with its math backend) and,
for reference, the memory-efficient backward on kv heads repeated to 32
(not one call on the same inputs). Run from the repo root (it imports
``chip_smoke``). Prints one JSON line last. CUDA only.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa

B, S, HQ, HKV, D = 1, 4096, 32, 16, 128


def build_lib(src: Path) -> ctypes.CDLL:
    """``src`` compiled as ``_build`` compiles ``csrc/flash_attention.cu``."""
    out = _build.build_dir() / f"libflash_variant_{_build.source_hash(src, _build.FLAGS)}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.nvcc(), *_build.FLAGS, "-o", str(out), str(src)],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib._typed = False
    return lib


@contextlib.contextmanager
def using(lib):
    """The flash wrappers launch ``lib``'s kernels inside the block."""
    saved = _build._LIBS.get("flash_attention")
    _build._LIBS["flash_attention"] = lib
    try:
        yield
    finally:
        _build._LIBS["flash_attention"] = saved


def rel(got, want):
    return (got.double() - want).abs().max().item() / max(1.0, want.abs().max().item())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[], metavar="NAME=FILE.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_bench: no CUDA device")
    from repro_torch.device import set_full_fp32
    set_full_fp32()
    libs = {"repo": fa._lib()}
    for spec in args.src:
        name, path = spec.split("=", 1)
        libs[name] = build_lib(Path(path))
    import chip_smoke as cs   # the repo root's timing helpers

    gen = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=gen).to("cuda")
    q, k, v, do = r(B, S, HQ, D), r(B, S, HKV, D), r(B, S, HKV, D), r(B, S, HQ, D)
    out = {"card": cs.smi_line(), "f64_rel_err": {},
           "ms": {n: {"flash_fwd": [], "flash_dq": [], "flash_dkv": []} for n in libs}}
    for name, lib in libs.items():
        with using(lib):       # also SDPA's (enable_gqa) distances, as "sdpa", "sdpa_fwd"
            out["f64_rel_err"][name] = cs.flash_f64(fa, q, k, v, do, True, None)
            out["f64_rel_err"][name].update(cs.flash_fwd_f64(fa, q, k, v, True, None))
    o, lse = fa.attention_plain(q, k, v, True, None)
    bargs = (q, k, v, do, lse, fa.flash_delta(o, do), True, None)
    del o
    turns = list(libs) + list(reversed(libs))
    for _ in range(2):
        for name in turns:
            with using(libs[name]):
                out["ms"][name]["flash_fwd"].append(
                    cs.time_ms(lambda: fa.flash_fwd_cuda(q, k, v, True, None), cold_l2=True))
                for which, fn in (("flash_dq", fa.flash_dq_cuda), ("flash_dkv", fa.flash_dkv_cuda)):
                    out["ms"][name][which].append(cs.time_ms(lambda: fn(*bargs), cold_l2=True))

    G, scale = HQ // HKV, fa.softmax_scale(D)
    want = fa.backward_float64(q, k, v, do, True, None)[2:]

    def sdpa_bwd(kt, vt, **kw):
        """Cold-L2 time of SDPA's backward, and its float64 distance."""
        qt = q.transpose(1, 2).detach().requires_grad_(True)
        kt, vt = (x.detach().requires_grad_(True) for x in (kt, vt))
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale, **kw)
        bwd = lambda: torch.autograd.grad(o, (qt, kt, vt), do.transpose(1, 2), retain_graph=True)
        gq, gk, gv = bwd()
        if gk.shape[1] != HKV:         # repeated kv heads: sum each group back
            gk, gv = (x.unflatten(1, (HKV, G)).sum(2) for x in (gk, gv))
        got = (gq.transpose(1, 2)[0, :, :G], gk.transpose(1, 2)[0, :, 0],
               gv.transpose(1, 2)[0, :, 0])
        return cs.time_ms(bwd, cold_l2=True), max(rel(x, w) for x, w in zip(got, want))

    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    qt = q.transpose(1, 2)
    out["sdpa_gqa_fwd_ms"] = cs.time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True), cold_l2=True)
    out["sdpa_gqa_ms"], _ = sdpa_bwd(kt, vt, enable_gqa=True)
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        out["sdpa_efficient_repeated_kv_ms"], out["f64_rel_err"]["sdpa_efficient"] = sdpa_bwd(
            kt.repeat_interleave(G, 1), vt.repeat_interleave(G, 1))
    for name, t in out["ms"].items():
        print(f"{name}: K9 {min(t['flash_fwd']):.4f} ms, K10 {min(t['flash_dq']):.4f} ms, "
              f"K11 {min(t['flash_dkv']):.4f} ms (best of {len(t['flash_dq'])}); float64 "
              f"{out['f64_rel_err'][name]}")
    print(f"SDPA forward: enable_gqa {out['sdpa_gqa_fwd_ms']:.4f} ms")
    print(f"SDPA backward: enable_gqa {out['sdpa_gqa_ms']:.4f} ms, efficient on repeated kv "
          f"{out['sdpa_efficient_repeated_kv_ms']:.4f} ms (float64 "
          f"{out['f64_rel_err']['sdpa_efficient']:.3e})")
    print(f"card: {out['card']}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
