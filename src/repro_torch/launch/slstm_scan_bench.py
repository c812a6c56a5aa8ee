"""K6, the sLSTM scan, at xlstm-1.3b's shape on the card: its latency floor
and its time against other builds of its source.

    PYTHONPATH=src python -m repro_torch.launch.slstm_scan_bench [--src NAME=FILE.cu ...]

At T=2048, B=2, 4 heads of dh=512, RH blocks of 64 kept at p=0.25 (k=384),
fresh start (``chip_smoke.slstm_inputs``):

* the floor: probe kernels (``PROBE_SRC``) on K6's own grid (one CTA of 256
  threads per (head, slice of J units), K6's own rule) time T steps of
  (a) ``grid.sync()`` alone; (b) a barrier per head (the head's CTAs count
  on an L2 counter with release / acquire); (c) the exchange K6 uses: each
  CTA publishes its words with the step tagged into the same 64-bit word
  (value, tag) into a two-slot ring, and polls its head's words until the
  tags match, at the forward's size (B x J words out, all B x dh of its
  head in) and the backward's (B x dh out, B x J from each CTA of the head
  in). The cheapest, x T, is the floor of a scan that exchanges one step's
  state between SMs every step;
* each build's K6 forward and backward (for a build with the separate WG
  kernel, the scan and WG together, as the wrapper calls them; also WG
  alone), CUDA events, cold L2, median of 20, the builds taken in turns
  (a, b, ..., b, a) twice; the builds are ``csrc/slstm_scan.cu`` ("repo")
  and each ``--src``, e.g. another commit's copy of that file, compiled
  with the same nvcc flags;
* with ``--phases``, the repo build's step split into its phases (the
  source built with ``-DSLSTM_PHASES``: thread 0 of each CTA counts the
  cycles between the step's barriers), as shares of the step;
* each build's distance to a float64 run of the plain versions
  (``plain_fwd``; ``plain_bwd`` on the float32 forward's residuals) as
  max |err| / max(1, |ref|) over each output group, beside the float32
  plain version's distance.

Run from the repo root (it imports ``chip_smoke``). Prints one JSON line
last. CUDA only.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import cell_scan as cs_mod
from repro_torch.kernels import slstm_scan as ss

T, B, NH, DH, BS, P = 2048, 2, 4, 512, 64, 0.25
NT = 256

PROBE_SRC = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
typedef unsigned long long u64;

__device__ __forceinline__ void st_word(u64* p, u64 w) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(w) : "memory");
}
__device__ __forceinline__ u64 ld_word(const u64* p) {
  u64 w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n" : "=l"(w) : "l"(p) : "memory");
  return w;
}

__global__ void probe_grid(int T) {
  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < T; ++t) grid.sync();
}

__global__ void probe_head(unsigned* cnt, int T, int cph) {
  unsigned* c = cnt + blockIdx.x / cph;
  for (int t = 0; t < T; ++t) {
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(c) : "memory");
      unsigned v = 0;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(c) : "memory");
      } while (v < (unsigned)(cph * (t + 1)));
    }
    __syncthreads();
  }
}

// Each CTA writes `pub` tagged words a step and reads `rd` words from each
// CTA of its head (at offset (own index x rd) mod pub in that CTA's words).
__global__ void probe_tagged(u64* ring, float* sink, int T, int NH, int cph, int pub, int rd) {
  const int hd = blockIdx.x / cph, me = blockIdx.x % cph;
  const size_t slot = (size_t)NH * cph * pub;
  const int n = cph * rd, off = (me * rd) % pub;
  float acc = 0.f;
  for (int t = 0; t < T; ++t) {
    if (t > 0) {
      const u64* s = ring + (size_t)((t - 1) & 1) * slot + (size_t)hd * cph * pub;
      for (int e0 = threadIdx.x; e0 < n; e0 += 4 * blockDim.x) {
        const u64* a[4];
        u64 w[4];
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * blockDim.x;
          a[u] = e < n ? s + (size_t)(e / rd) * pub + off + e % rd : nullptr;
          w[u] = a[u] ? ld_word(a[u]) : (u64)t << 32;
        }
        for (int u = 0; u < 4; ++u)
          while ((unsigned)(w[u] >> 32) != (unsigned)t) w[u] = ld_word(a[u]);
        for (int u = 0; u < 4; ++u) acc += __uint_as_float((unsigned)w[u]);
      }
    }
    __syncthreads();
    u64* o = ring + (size_t)(t & 1) * slot + ((size_t)hd * cph + me) * pub;
    for (int e = threadIdx.x; e < pub; e += blockDim.x)
      st_word(o + e, ((u64)(t + 1) << 32) | __float_as_uint(1.f));
  }
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

extern "C" int probe_launch(int which, int T, int NH, int cph, int pub, int rd, void* buf,
                            float* sink, void* stream) {
  void* args[7];
  const void* kernel;
  int na;
  if (which == 0) {
    kernel = (const void*)probe_grid; args[0] = &T; na = 1;
  } else if (which == 1) {
    kernel = (const void*)probe_head; args[0] = &buf; args[1] = &T; args[2] = &cph; na = 3;
  } else {
    kernel = (const void*)probe_tagged; args[0] = &buf; args[1] = &sink; args[2] = &T;
    args[3] = &NH; args[4] = &cph; args[5] = &pub; args[6] = &rd; na = 7;
  }
  (void)na;
  cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(NH * cph), dim3(256), args, 0,
                                                (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
"""


def compile_lib(src: Path, stem: str, extra=()) -> ctypes.CDLL:
    """``src`` compiled as ``_build`` compiles ``csrc/slstm_scan.cu`` (plus
    ``extra`` flags)."""
    flags = [*_build.FLAGS, *extra]
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out = _build.build_dir() / f"lib{stem}_{h}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        res = subprocess.run([_build.nvcc(), *flags, "-o", str(out), str(src)],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(out))


def units_per_cta():
    """K6's grid at this shape, by its own rule (``slstm_scan_units``):
    (J units a CTA, CTAs a head)."""
    J, cph = ctypes.c_int(), ctypes.c_int()
    ss._lib().slstm_scan_units(NH, DH, ctypes.byref(J), ctypes.byref(cph))
    return J.value, cph.value


def floor_probes(cs):
    """{probe: microseconds a step} on K6's grid, median of 5 runs of T steps."""
    src = _build.build_dir() / "slstm_probe.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(PROBE_SRC)
    lib = compile_lib(src, "slstm_probe")
    lib.probe_launch.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
    lib.probe_launch.restype = ctypes.c_int
    J, cph = units_per_cta()
    stream = torch.cuda.current_stream().cuda_stream
    sink = torch.empty(NH * cph * NT, device="cuda")
    out = {"J": J, "ctas_per_head": cph, "ctas": NH * cph}
    cases = {"a_grid_sync": (0, 0, 0), "b_head_barrier": (1, 0, 0),
             "c_tagged_fwd": (2, B * J, B * J), "c_tagged_bwd": (2, B * DH, B * J)}
    for name, (which, pub, rd) in cases.items():
        words = 2 * NH * cph * max(pub, 1)

        def run():
            buf = torch.zeros(words, dtype=torch.int64, device="cuda")
            code = lib.probe_launch(which, T, NH, cph, pub, rd, buf.data_ptr(),
                                    sink.data_ptr(), stream)
            if code:
                raise RuntimeError(f"probe {name}: CUDA error {code}")
        out[name] = cs.time_ms(run, reps=5, warmup=1) * 1e3 / T
    return out


def old_interface(lib):
    """A build without the WG kernel (the fused-WG scan with a grid-wide
    barrier): its C interface, typed."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.slstm_scan_fwd_f32.argtypes = [p] * 14 + [i] * 10 + [f, p]
    lib.slstm_scan_bwd_f32.argtypes = [p] * 23 + [i] * 10 + [f, p]
    lib.slstm_scan_fwd_f32.restype = lib.slstm_scan_bwd_f32.restype = i
    return lib


@contextlib.contextmanager
def using(lib):
    """The K6 wrappers launch ``lib``'s kernels inside the block."""
    saved = _build._LIBS.get("slstm_scan")
    _build._LIBS["slstm_scan"] = lib
    try:
        yield
    finally:
        _build._LIBS["slstm_scan"] = saved


def calls(lib, x):
    """(forward, backward, WG or None) callables of build ``lib`` on inputs
    ``x``; each returns its outputs as a flat tuple."""
    gx, R, h0, st0, ids, mask, lengths, scale = x["fwd"]
    dy, dstT, gates, sts, hs = x["dy"], x["dstT"], x["gates"], x["sts"], x["hs"]
    rh = (ids, mask, lengths, scale)
    if hasattr(lib, "slstm_wg_f32"):
        if not hasattr(lib, "_typed"):
            lib._typed = False

        def fwd():
            with using(lib):
                o = ss.slstm_scan_fwd_cuda(gx, R, h0, st0, *rh)
            return (o[0], o[1], *o[2])

        def bwd():
            with using(lib):
                o = ss.slstm_scan_bwd_cuda(dy, dstT, gates, sts, st0, hs, h0, R, *rh)
            return (o[0], o[1], o[2], *o[3])
        tables = ss.wg_tables(ids, T, DH, gx.device)
        dgx = x["dgx"]

        def wg():
            with using(lib):
                return (ss.slstm_wg(dgx, hs, h0, tables, mask, scale),)
        return fwd, bwd, wg
    old_interface(lib)
    stream = torch.cuda.current_stream().cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    ints = (T, B, NH, DH, 1, ids.shape[1], ids.shape[0], 1, 1, 0)

    def fwd():
        o = [torch.empty_like(hs) for _ in range(4)]
        g = torch.empty_like(gates)
        code = lib.slstm_scan_fwd_f32(gx.data_ptr(), R.data_ptr(), h0.data_ptr(),
                                      *(s.data_ptr() for s in st0), ptr(ids), None, None,
                                      o[0].data_ptr(), g.data_ptr(), o[1].data_ptr(),
                                      o[2].data_ptr(), o[3].data_ptr(), *ints, float(scale),
                                      stream)
        assert code == 0, code
        return (o[0], g, o[1], o[2], o[3])

    def bwd():
        dgx = torch.empty_like(gates)
        dR = torch.empty_like(R)
        d0 = [torch.empty_like(h0) for _ in range(4)]
        code = lib.slstm_scan_bwd_f32(dy.data_ptr(), *(d.data_ptr() for d in dstT),
                                      gates.data_ptr(), *(s.data_ptr() for s in sts),
                                      *(s.data_ptr() for s in st0), hs.data_ptr(),
                                      h0.data_ptr(), R.data_ptr(), ptr(ids), None, None,
                                      dgx.data_ptr(), dR.data_ptr(),
                                      *(d.data_ptr() for d in d0), *ints, float(scale),
                                      stream)
        assert code == 0, code
        return (dgx, dR, *d0)
    return fwd, bwd, None


PHASES = {"fwd": ("wait + barrier", "prefetch issue + poll h_{t-1}", "product",
                   "sum of the K-split", "pointwise", "publish + stores", "rest"),
          "bwd": ("wait + barrier", "prefetch issue + flags + poll partials",
                  "sum of the partials", "pointwise reverse", "stores + barrier",
                  "partial-BP product", "publish", "rest")}


def phases(fns_of, ms):
    """Each scan direction's step split into its phases: the source built
    with -DSLSTM_PHASES, one launch each; thread 0's cycles per phase,
    averaged over the CTAs, as shares of the step and as us a step at the
    uninstrumented build's time ``ms[direction]``."""
    src = _build.CSRC / "slstm_scan.cu"
    lib = compile_lib(src, "slstm_phases", ["-DSLSTM_PHASES"])
    lib.slstm_scan_phases.argtypes = [ctypes.c_void_p]
    lib.slstm_scan_phases.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * (2 * 1024 * 8))()
    fwd, bwd, _ = fns_of(lib)
    assert lib.slstm_scan_phases(buf) == 0      # zero
    fwd()
    bwd()
    torch.cuda.synchronize()
    assert lib.slstm_scan_phases(buf) == 0
    ctas = NH * units_per_cta()[1]
    out = {}
    for d, name in enumerate(("fwd", "bwd")):
        n = len(PHASES[name])
        cyc = [[buf[(d * 1024 + c) * 8 + i] for i in range(n)] for c in range(ctas)]
        mean = [sum(c[i] for c in cyc) / ctas for i in range(n)]
        tot = sum(mean)
        out[name] = {ph: {"share": m / tot, "us_per_step": m / tot * ms[name] * 1e3 / T}
                     for ph, m in zip(PHASES[name], mean)}
    return out


def f64_dist(got, want):
    """max |got - want| / max(1, max |want|) over the tensors of a group."""
    return max((g.double() - w).abs().max().item() / max(1.0, w.abs().max().item())
               for g, w in zip(got, want))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[], metavar="NAME=FILE.cu")
    ap.add_argument("--phases", action="store_true",
                    help="also split the repo build's step into phases")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("slstm_scan_bench: no CUDA device")
    from repro_torch.device import set_full_fp32
    set_full_fp32()
    import chip_smoke as cs   # the repo root's inputs and timing helpers

    libs = {"repo": ss._lib()}
    for spec in args.src:
        name, path = spec.split("=", 1)
        libs[name] = compile_lib(Path(path), f"slstm_variant_{name}")
    out = {"card": cs.smi_line(), "shape": dict(T=T, B=B, NH=NH, dh=DH, bs=BS, p=P)}
    out["floor_us_per_step"] = floor_probes(cs)
    best = min(v for k, v in out["floor_us_per_step"].items() if k.startswith(("a_", "b_", "c_")))
    out["floor_ms"] = best * T / 1e3

    gen = torch.Generator().manual_seed(0)
    gx, R, h0, st0, ids, mask, lengths, scale, dy, dstT = cs.slstm_inputs(
        gen, T, B, NH, DH, P, "structured", BS, False, False, True, 1)
    rh = (ids, mask, lengths, scale)
    hs, gates, sts = cs_mod.plain_fwd(ss.SLSTM_CELL, gx, R, h0, st0, *rh)
    plain_b = cs_mod.plain_bwd(ss.SLSTM_CELL, dy, dstT, gates, sts, st0, hs, h0, R, *rh)
    d = lambda t: t.double()
    ref_f = cs_mod.plain_fwd(ss.SLSTM_CELL, d(gx), d(R), d(h0), tuple(map(d, st0)), *rh)
    ref_f = (ref_f[0], ref_f[1], *ref_f[2])
    ref_b = cs_mod.plain_bwd(ss.SLSTM_CELL, d(dy), tuple(map(d, dstT)), d(gates),
                             tuple(map(d, sts)), tuple(map(d, st0)), d(hs), d(h0), d(R), *rh)
    ref_b = (ref_b[0], ref_b[1], ref_b[2], *ref_b[3])
    out["f64_dist"] = {"plain_f32": {"fwd": f64_dist((hs, gates, *sts), ref_f),
                                     "bwd": f64_dist((plain_b[0], plain_b[1], plain_b[2],
                                                      *plain_b[3]), ref_b)}}
    x = dict(fwd=(gx, R, h0, st0, *rh), dy=dy, dstT=dstT, gates=gates, sts=sts, hs=hs,
             dgx=plain_b[0])
    fns = {name: calls(lib, x) for name, lib in libs.items()}
    for name, (fwd, bwd, wg) in fns.items():
        out["f64_dist"][name] = {"fwd": f64_dist(fwd(), ref_f), "bwd": f64_dist(bwd(), ref_b)}
    out["ms"] = {n: {"fwd": [], "bwd": [], "wg": []} for n in libs}
    turns = list(libs) + list(reversed(libs))
    for _ in range(2):
        for name in turns:
            fwd, bwd, wg = fns[name]
            t = out["ms"][name]
            t["fwd"].append(cs.time_ms(fwd, cold_l2=True))
            t["bwd"].append(cs.time_ms(bwd, cold_l2=True))
            if wg is not None:
                t["wg"].append(cs.time_ms(wg, cold_l2=True))
    if args.phases:
        scan_ms = {"fwd": min(out["ms"]["repo"]["fwd"]),
                   "bwd": min(out["ms"]["repo"]["bwd"]) - min(out["ms"]["repo"]["wg"])}
        out["phases"] = phases(lambda lib: calls(lib, x), scan_ms)
        for d, ph in out["phases"].items():
            print(f"{d} phases: " + ", ".join(f"{k} {v['share']:.3f} ({v['us_per_step']:.3f} us)"
                                              for k, v in ph.items()))
    fl = out["floor_us_per_step"]
    print(f"K6 grid: {fl['ctas']} CTAs, J={fl['J']}, {fl['ctas_per_head']} a head; "
          + ", ".join(f"{k} {v:.3f} us/step" for k, v in fl.items() if k[:2] in ("a_", "b_", "c_"))
          + f"; floor x T = {out['floor_ms']:.4f} ms")
    for name, t in out["ms"].items():
        wg = f", WG {min(t['wg']):.4f} ms" if t["wg"] else ""
        print(f"{name}: fwd {min(t['fwd']):.4f} ms, bwd {min(t['bwd']):.4f} ms{wg} "
              f"(best of {len(t['fwd'])}); float64 {out['f64_dist'][name]}")
    print(f"plain float32 to float64: {out['f64_dist']['plain_f32']}")
    print(f"card: {out['card']}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
