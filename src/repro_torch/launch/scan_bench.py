"""The LSTM scan (K3 forward, K4 backward) and the decoder scan (K7 forward,
K8 backward) on the card: their latency floors, their phases and their times
against other builds of their sources.

    PYTHONPATH=src python -m repro_torch.launch.scan_bench [--kernels k3,k4,k7,k8]
        [--phases] [--phase-probes] [--no-probes] [--wg-rate P ...]
        [--src NAME=DIR ...] [--turns N]

Shapes (inputs from ``chip_smoke.scan_inputs`` / ``chip_smoke.decoder_inputs``):
K3 and K4 at zaremba-medium (T=35, B=20, H=650, structured p=0.5) and at the
luong-nmt encoder (T=50, B=64, H=512, p=0.3); K7 and K8 at luong-nmt (T=50,
B=64, S=50, H=512, nl=2, structured per-step sites at p=0.3).

* the floor: probe kernels (``PROBE_SRC``) on each kernel's own grid (one
  CTA of 256 threads a slice of J units, J = ceil(H / SMs) as the first
  designs take it) time T steps of (a) ``grid.sync()`` alone; (b) a barrier
  of all CTAs on an L2 counter (release / acquire); for the backwards (c) an
  exchange of 64-bit words that carry value and step together (tagged),
  polled until the tags match: every CTA publishes its B x 4J dgates and
  reads all B x 4H ("all_dgates"), or publishes B x k partial dh and reads
  B x J from every CTA ("column_owned"); (d) the same exchange inside
  thread-block clusters of 8 CTAs (``kernels/lstm_scan.cluster_plan``): a
  ``cluster.sync()`` and a distributed-shared-memory gather of B x 4J floats
  from each of the Q CTAs, then B x k / Q tagged words out and B x J x P in
  (P clusters); for the forwards (``fwd_probe_cases``: k the inputs of an
  exchange, two sites' for K7) every CTA reading all B x k inputs by
  ``__ldcg`` before a ``grid.sync()`` (the first design), a tagged
  broadcast, and clusters of 8 and 4 in a gather and a partial-sum form.
  The cheapest, x T, is the kernel's latency floor (K7's step chains four
  exchanges: T x 4 x the cheapest; K8's at least three, printed beside);
* each build's kernels, CUDA events, cold L2, median of 20, the builds
  taken in turns (a, b, ..., b, a) ``--turns`` times (2); the builds are
  the repo's ``csrc/lstm_scan.cu`` and ``csrc/decoder_scan.cu`` ("repo")
  and, for each ``--src NAME=DIR``, the same files in DIR (e.g. a parent
  commit's ``src/repro_torch/csrc``; its headers must sit beside them),
  compiled with the same nvcc flags; a build without the redesigns' C
  interfaces is driven through the first designs' (K7's first design,
  ``dec_fwd_kernel``, through ``decoder_scan_fwd_f32``); each row's median
  over the turns is printed beside its best;
* each build's distance to a float64 run of the plain version (the
  backwards on the float32 forward's residuals), max |err| / max(1, |ref|)
  over the outputs, beside the float32 plain version's own;
* with ``--phases``, the repo build's step split into its phases: the
  sources built with ``-DLSTM_PHASES`` / ``-DDEC_PHASES`` (thread 0 of
  each CTA counts the cycles between the step's barriers), as shares of the
  step and as us a step at the uninstrumented build's time (a phase after
  the scan, as us a step over T; K7's: each product phase's waits for its
  boxes, products, pointwise and barrier);
* with ``--phase-probes``, pieces of K4's step alone at its two shapes on
  its grid (``PHASE_PROBE_SRC``): a site's BP partials with and without
  their stores, the cluster gather, a ``cluster.sync()``;
* with ``--wg-rate P`` (repeatable), K4 also at zaremba-medium's shape with
  RH rate P, timed and split like the others: BP shrinks with the kept
  units, WG (dense over the units) does not.

Run from the repo root (it imports ``chip_smoke``). Prints one JSON line
last. CUDA only.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import cell_scan as cs_mod
from repro_torch.kernels import decoder_scan as ds
from repro_torch.kernels import lstm_scan as ls
from repro_torch.launch import slstm_scan_bench

NT = 256
# (T, B, H, p) of K4's two rows, (T, B, S, H, p) of K8's
K4_SHAPES = {"zaremba": (35, 20, 650, 0.5), "nmt": (50, 64, 512, 0.3)}
K8_SHAPE = (50, 64, 50, 512, 0.3)
CLUSTER = 8            # the probes' cluster size

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

__global__ void probe_bar(unsigned* cnt, int T) {
  for (int t = 0; t < T; ++t) {
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(cnt) : "memory");
      unsigned v = 0;
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(cnt) : "memory");
      } while (v < gridDim.x * (unsigned)(t + 1));
    }
    __syncthreads();
  }
}

// Polls rd words of each of the n source CTAs src(i) (i < n) of step t - 1,
// 8 loads in flight a thread.
template <class Src>
__device__ __forceinline__ float poll_words(const u64* slot, int pub, int n, int rd, int off,
                                            unsigned want, Src src) {
  float acc = 0.f;
  const int tot = n * rd;
  for (int e0 = threadIdx.x; e0 < tot; e0 += 8 * blockDim.x) {
    const u64* a[8];
    u64 w[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * blockDim.x;
      a[u] = e < tot ? slot + (size_t)src(e / rd) * pub + (off + e % rd) % pub : nullptr;
      w[u] = a[u] ? ld_word(a[u]) : (u64)want << 32;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      while ((unsigned)(w[u] >> 32) != want) w[u] = ld_word(a[u]);
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += __uint_as_float((unsigned)w[u]);
  }
  return acc;
}

// Each CTA publishes `pub` tagged words a step and reads `rd` words from
// each CTA of its group, the CTAs j with j % gmod == blockIdx.x % gmod.
__global__ void probe_tagged(u64* ring, float* sink, int T, int gmod, int pub, int rd) {
  const int N = gridDim.x, me = blockIdx.x, n = (N - me % gmod + gmod - 1) / gmod;
  const size_t slot = (size_t)N * pub;
  float acc = 0.f;
  for (int t = 0; t < T; ++t) {
    if (t > 0)
      acc += poll_words(ring + (size_t)((t - 1) & 1) * slot, pub, n, rd, me * rd, (unsigned)t,
                        [&](int i) { return i * gmod + me % gmod; });
    __syncthreads();
    u64* o = ring + (size_t)(t & 1) * slot + (size_t)me * pub;
    for (int e = threadIdx.x; e < pub; e += blockDim.x)
      st_word(o + e, ((u64)(t + 1) << 32) | __float_as_uint(1.f));
  }
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

// Clusters of Q CTAs: a step writes dsm floats into the CTA's shared
// memory, cluster.sync(), gathers dsm floats from each CTA of the cluster
// (distributed shared memory; keep: into its own shared memory, else summed
// in registers), then publishes pub tagged words and polls rd words of each
// CTA of its column (j % Q == blockIdx.x % Q).
__global__ void probe_cluster(u64* ring, float* sink, int T, int pub, int rd, int dsm, int keep) {
  extern __shared__ float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int Q = (int)cl.num_blocks(), N = gridDim.x, me = blockIdx.x;
  const int n = N / Q;
  const size_t slot = (size_t)N * pub;
  float acc = 0.f;
  float* gath = sm + 2 * dsm;
  for (int t = 0; t < T; ++t) {
    if (t > 0)
      acc += poll_words(ring + (size_t)((t - 1) & 1) * slot, pub, n, rd, me * rd, (unsigned)t,
                        [&](int i) { return i * Q + me % Q; });
    float* own = sm + (t & 1) * dsm;
    for (int e = threadIdx.x; e < dsm; e += blockDim.x) own[e] = acc + e;
    cl.sync();
    float g = 0.f;
    for (int e = threadIdx.x; e < Q * dsm; e += blockDim.x) {
      const float* peer = cl.map_shared_rank(own, e / dsm);
      if (keep) gath[e] = peer[e % dsm];
      else g += peer[e % dsm];
    }
    __syncthreads();
    acc += keep ? gath[threadIdx.x % (Q * dsm)] : g;
    u64* o = ring + (size_t)(t & 1) * slot + (size_t)me * pub;
    for (int e = threadIdx.x; e < pub; e += blockDim.x)
      st_word(o + e, ((u64)(t + 1) << 32) | __float_as_uint(1.f));
  }
  cl.sync();
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

// The first K3 / K7 design's staging: a step reads n floats written in the
// launch through L2 (__ldcg, 16 loads in flight a thread), then grid.sync().
__global__ void probe_ldcg(const float* x, float* sink, int T, int n) {
  cg::grid_group grid = cg::this_grid();
  float acc = 0.f;
  for (int t = 0; t < T; ++t) {
    for (int e0 = threadIdx.x; e0 < n; e0 += 16 * blockDim.x) {
      float v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) v[u] = __ldcg(x + min(e0 + u * (int)blockDim.x, n - 1));
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (e0 + u * (int)blockDim.x < n) acc += v[u];
    }
    grid.sync();
  }
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

static cudaError_t launch_ex(const void* kernel, int N, int Q, bool coop, size_t smem,
                             void** args, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[2];
  int na = 0;
  if (Q > 1) {
    at[na].id = cudaLaunchAttributeClusterDimension;
    at[na].val.clusterDim.x = Q;
    at[na].val.clusterDim.y = 1;
    at[na].val.clusterDim.z = 1;
    ++na;
  }
  if (coop) {
    at[na].id = cudaLaunchAttributeCooperative;
    at[na].val.cooperative = 1;
    ++na;
  }
  cfg.attrs = at;
  cfg.numAttrs = na;
  return cudaLaunchKernelExC(&cfg, kernel, args);
}

// Clusters of Q CTAs with `smem` bytes each that can be resident at once.
extern "C" int probe_max_clusters(int Q, int smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute((const void*)probe_cluster,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Q);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute at;
  at.id = cudaLaunchAttributeClusterDimension;
  at.val.clusterDim.x = Q;
  at.val.clusterDim.y = 1;
  at.val.clusterDim.z = 1;
  cfg.attrs = &at;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, (const void*)probe_cluster, &cfg);
}

// which: 0 grid.sync, 1 L2 barrier, 2 tagged, 3 cluster (coop: also a
// cooperative launch; gathered into shared memory), 4 __ldcg of rd floats
// and grid.sync, 5 cluster, the gathered floats summed in registers.
// Returns the launch's CUDA error.
extern "C" int probe_launch(int which, int T, int N, int gmod, int pub, int rd, int dsm,
                            int coop, void* buf, float* sink, void* stream) {
  cudaGetLastError();
  cudaError_t err;
  if (which == 0) {
    void* args[] = {&T};
    err = cudaLaunchCooperativeKernel((const void*)probe_grid, dim3(N), dim3(256), args, 0,
                                      (cudaStream_t)stream);
  } else if (which == 1) {
    void* args[] = {&buf, &T};
    err = cudaLaunchCooperativeKernel((const void*)probe_bar, dim3(N), dim3(256), args, 0,
                                      (cudaStream_t)stream);
  } else if (which == 2) {
    void* args[] = {&buf, &sink, &T, &gmod, &pub, &rd};
    err = cudaLaunchCooperativeKernel((const void*)probe_tagged, dim3(N), dim3(256), args, 0,
                                      (cudaStream_t)stream);
  } else if (which == 4) {
    void* args[] = {&buf, &sink, &T, &rd};
    err = cudaLaunchCooperativeKernel((const void*)probe_ldcg, dim3(N), dim3(256), args, 0,
                                      (cudaStream_t)stream);
  } else {
    int keep = which == 3;
    const size_t smem = (size_t)(2 + (keep ? gmod : 0)) * dsm * sizeof(float);
    err = cudaFuncSetAttribute((const void*)probe_cluster,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&buf, &sink, &T, &pub, &rd, &dsm, &keep};
    err = launch_ex((const void*)probe_cluster, N, gmod, coop != 0, smem, args, stream);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
"""


PHASE_PROBE_SRC = r"""
#include "scan_exchange.cuh"

// bp_partials' sink that stores nothing: a store no value takes, so that
// the compiler keeps the sums.
struct NoStore {
  unsigned long long* sink;
  __device__ __forceinline__ void operator()(int, int, float v) const {
    if (v == 12345.f) sink[0] = 0;
  }
};

// T calls of one phase of K4 / K8's step on CTA-resident synthetic data, in
// clusters of Q (cooperative): 0 bp_partials (RES, publishing), 1 the same
// without its stores, 2 gather_cluster, 3 cluster.sync alone.
__global__ void probe_phase(int which, int T, int B, int H, int Q, int J, int P, int nk,
                            unsigned long long* ring) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const Clu L(Q, J, P, H);
  const int ldc = clu_cols8(Q, J) + 4, PJ = P * J, B16 = (B + 15) & ~15, Bp = (B + 3) & ~3;
  float* Ws = sm;
  float* dgc = Ws + (size_t)PJ * ldc;
  float* own = dgc + (size_t)B16 * ldc;
  int* kl = reinterpret_cast<int*>(own + 4 * J * Bp);
  int* ku = kl + PJ;
  for (int e = threadIdx.x; e < PJ * ldc; e += blockDim.x) Ws[e] = 1e-3f * (e % 97);
  for (int e = threadIdx.x; e < B16 * ldc; e += blockDim.x) dgc[e] = 1e-3f * (e % 89);
  for (int e = threadIdx.x; e < 4 * J * Bp; e += blockDim.x) own[e] = 1e-3f * (e % 83);
  for (int s = threadIdx.x; s < PJ; s += blockDim.x) {
    kl[s] = s;
    ku[s] = L.unit(s) % H;
  }
  cg::this_cluster().sync();
  for (int t = 0; t < T; ++t) {
    if (which == 0)
      bp_partials<true>(dgc, ldc, Ws, ldc, nullptr, kl, nk, B, L,
                        Publish{ring + ((size_t)(t & 1) * P + L.c) * B * H, ku, B, 0,
                                (unsigned)(t + 1)});
    else if (which == 1)
      bp_partials<true>(dgc, ldc, Ws, ldc, nullptr, kl, nk, B, L, NoStore{ring});
    else if (which == 2)
      gather_cluster(dgc, ldc, own, Bp, L, 0, B);
    __syncthreads();
    if (which >= 2) cg::this_cluster().sync();
  }
  cg::this_cluster().sync();
}

extern "C" int probe_phase_launch(int which, int T, int B, int H, int Q, int J, int P, int nk,
                                  void* ring, void* stream) {
  const int PJ = P * J, ldc = clu_cols8(Q, J) + 4;
  const size_t smem = 4 * ((size_t)PJ * ldc + (size_t)((B + 15) & ~15) * ldc +
                           4 * (size_t)J * ((B + 3) & ~3) + 2 * (size_t)PJ);
  void* args[] = {&which, &T, &B, &H, &Q, &J, &P, &nk, &ring};
  cudaError_t err = launch_clusters((const void*)probe_phase, P, Q, 256, smem, args, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
"""


def phase_probes(cs, B, H, k, plan, calls=1000):
    """us a call of pieces of K4 / K8's step alone (``PHASE_PROBE_SRC``) at
    a shape (B rows, H units, k kept a step) on the grid ``plan`` (Q, J, P):
    the BP partials of a site with and without their stores, the cluster
    gather, a cluster.sync; CUDA events over ``calls`` calls a launch."""
    src = _build.build_dir() / "scan_phase_probe.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(PHASE_PROBE_SRC)
    # the header's hash in the name: the probe is rebuilt when it changes
    hdr = _build.source_hash(_build.CSRC / "scan_exchange.cuh", [])
    lib = compile_lib(src, f"scan_phase_probe_{hdr}", ["-I", str(_build.CSRC)])
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.probe_phase_launch.argtypes = [i] * 8 + [p] * 2
    lib.probe_phase_launch.restype = i
    Q, J, P = plan
    nk = -(-P * J * k // H)
    ring = torch.zeros(2 * P * B * H, dtype=torch.int64, device="cuda")
    out = {"plan": dict(Q=Q, J=J, P=P, kept_of_column=nk)}
    for which, name in enumerate(("bp_partials", "bp_partials_no_stores", "gather",
                                  "cluster_sync")):
        def run():
            code = lib.probe_phase_launch(which, calls, B, H, Q, J, P, nk, ring.data_ptr(),
                                          torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"phase probe {name}: CUDA error {code}")
        out[name] = cs.time_ms(run, reps=3, warmup=1) * 1e3 / calls
    return out


def compile_lib(src: Path, stem: str, extra=()) -> ctypes.CDLL:
    """``src`` compiled as ``_build`` compiles the port's sources (plus
    ``extra`` flags), its CUDA error strings typed where it has them."""
    lib = slstm_scan_bench.compile_lib(src, stem, extra)
    if hasattr(lib, "repro_cuda_error_string"):
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def first_grid(H: int, sms: int):
    """The first K4 / K8 design's grid: J = ceil(H / SMs) units a CTA,
    ceil(H / J) CTAs."""
    J = -(-H // sms)
    return J, -(-H // J)


def probe_cases(B: int, H: int, k: int, sms: int, max_clusters: int, Q: int = CLUSTER):
    """{name: (which, N, gmod, pub, rd, dsm)} of the floor probes at one
    kernel's shape (B rows, H units, k kept a step): the first design's
    grid for (a)-(c), clusters of Q for (d)."""
    J, N = first_grid(H, sms)
    _, Jc, P = ls.cluster_plan(
        H, sms, lambda q, j: q == Q and ls.n_clusters(H, j, q) <= max_clusters)
    return {
        "a_grid_sync": (0, N, 1, 0, 0, 0),
        "b_l2_barrier": (1, N, 1, 0, 0, 0),
        "c_tagged_all_dgates": (2, N, 1, B * 4 * J, B * 4 * J, 0),
        "c_tagged_column_owned": (2, N, 1, B * k, B * J, 0),
        "d_cluster_dsmem": (3, P * Q, Q, -(-B * k // Q), B * Jc, B * 4 * Jc),
    }


def fwd_probe_cases(B: int, H: int, k: int, sms: int, max_clusters: dict) -> dict:
    """{name: (which, N, gmod, pub, rd, dsm)} of the forward floor probes at
    one kernel's shape (B rows, H units, k kept inputs a step): on the first
    design's grid (J = ceil(H / SMs) units a CTA) (a) ``grid.sync()``, (b)
    the L2-counter barrier, (c) the first design's staging, every CTA reading
    B x k floats through ``__ldcg`` before its ``grid.sync()``, (d) a tagged
    broadcast, every CTA publishing its B x J values and reading B x k; and
    for each cluster size Q of ``max_clusters`` ({Q: clusters resident}) on
    ``lstm_scan.cluster_plan``'s grid of P clusters, every CTA publishing its
    B x J values and polling its 1/Q share, B x k / Q words from the P CTAs
    of its column, then a ``cluster.sync()`` and (e) the gather form: the
    cluster's shares, B x k / Q floats from each of its Q CTAs, over
    distributed shared memory; (f) the partial-sum form: B x 4J partial gates
    from each of its Q CTAs (both summed in registers as they arrive)."""
    J, N = first_grid(H, sms)
    out = {
        "a_grid_sync": (0, N, 1, 0, 0, 0),
        "b_l2_barrier": (1, N, 1, 0, 0, 0),
        "c_ldcg_all_inputs": (4, N, 1, 0, B * k, 0),
        "d_tagged_broadcast": (2, N, 1, B * J, -(-B * k // N), 0),
    }
    for q, mc in max_clusters.items():
        _, Jc, P = ls.cluster_plan(
            H, sms, lambda q_, j: q_ == q and ls.n_clusters(H, j, q_) <= mc)
        rd = -(-B * k // (P * q))
        out[f"e_cluster{q}_gather"] = (5, P * q, q, B * Jc, rd, -(-B * k // q))
        out[f"f_cluster{q}_partials"] = (5, P * q, q, B * Jc, rd, B * 4 * Jc)
    return out


def k3_fwd_ops(T: int, B: int, H: int, k: int) -> dict:
    """K3's FLOPs, all on FFMA: drop(h_{t-1}) @ U at the k kept units, 2 B
    k 4H a step (the pointwise update is not counted)."""
    return {"tf32": 0, "f32": 2 * T * B * k * 4 * H}


def k7_fwd_ops(T: int, B: int, S: int, H: int, kept) -> dict:
    """K7's FLOPs by the units that run them, ``kept`` the kept units a step
    of each of the four sites: each site's gate product (2 B k 4H) a step on
    the TF32 tensor cores in split precision (three products for each
    float32 one); the readout (2 B 2H H) and the attention's scores and
    context (2 B S H each) on FFMA."""
    gates = T * sum(2 * B * k * 4 * H for k in kept)
    return {"tf32": 3 * gates, "f32": T * (2 * B * 2 * H * H + 2 * 2 * B * S * H)}


def k4_bwd_ops(T: int, B: int, H: int, k: int) -> dict:
    """K4's FLOPs by the units that run them, at what the data needs (k
    kept units a step): BP and WG on the TF32 tensor cores, three products
    for each float32 one (3xTF32), and nothing of note on FFMA (the
    pointwise reverse is not counted)."""
    return {"tf32": 3 * 2 * (2 * T * B * k * 4 * H), "f32": 0}


def k8_bwd_ops(T: int, B: int, S: int, H: int, kept) -> dict:
    """K8's FLOPs by the units that run them, ``kept`` the kept units a
    step of each of the four sites: on the TF32 tensor cores (3xTF32) each
    site's BP and WG, dW_comb, d enc_out and d enc_proj; on FFMA the
    readout's dpre @ w_comb^T and the attention's dalpha, context and
    ds @ enc_proj."""
    G, att, ro = 4 * H, 2 * B * S * H, 2 * B * 2 * H * H
    return {"tf32": 3 * T * (sum(4 * B * k * G for k in kept) + 2 * att + ro),
            "f32": T * (3 * att + ro)}


def floor_ms(per_step_us: dict, T: int, exchanges: int = 1) -> float:
    """T x ``exchanges`` x the cheapest probe's us a step, in ms."""
    return min(per_step_us.values()) * T * exchanges / 1e3


def floor_probes(cs, T, B, H, k, forward=False):
    """{probe: us a step} on one kernel's grid, median of 5 runs of T
    steps (``forward``: ``fwd_probe_cases`` at clusters of 8 and 4, else
    ``probe_cases``); also the grids and whether a cooperative launch of
    clusters was taken."""
    src = _build.build_dir() / "scan_probe.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(PROBE_SRC)
    lib = compile_lib(src, "scan_probe")
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.probe_launch.argtypes = [i] * 8 + [p] * 3
    lib.probe_launch.restype = i
    lib.probe_max_clusters.argtypes = [i, i, ctypes.POINTER(i)]
    lib.probe_max_clusters.restype = i
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mcs = {}
    for q in (CLUSTER, 4) if forward else (CLUSTER,):
        mc = ctypes.c_int()
        # one CTA an SM, as the scans run
        assert lib.probe_max_clusters(q, 120 << 10, ctypes.byref(mc)) == 0
        mcs[q] = mc.value
    cases = (fwd_probe_cases(B, H, k, sms, mcs) if forward
             else probe_cases(B, H, k, sms, mcs[CLUSTER]))
    stream = torch.cuda.current_stream().cuda_stream
    sink = torch.empty(2 * sms * NT, device="cuda")
    out = {"sms": sms, "max_clusters": mcs[CLUSTER], "max_clusters_of": mcs, "grids": {},
           "us_per_step": {}}
    for name, (which, N, gmod, pub, rd, dsm) in cases.items():
        out["grids"][name] = dict(ctas=N, group_mod=gmod, pub=pub, rd=rd, dsm=dsm)
        words = max(2 * N * max(pub, 1), rd, 16)
        coop = [1, 0] if which in (3, 5) else [0]
        for c in coop:
            def run():
                buf = torch.zeros(words, dtype=torch.int64, device="cuda")
                code = lib.probe_launch(which, T, N, gmod, pub, rd, dsm, c,
                                        buf.data_ptr(), sink.data_ptr(), stream)
                if code:
                    raise RuntimeError(f"probe {name}: CUDA error {code}")
            try:
                out["us_per_step"][name] = cs.time_ms(run, reps=5, warmup=1) * 1e3 / T
                if which in (3, 5):
                    out["cluster_cooperative_launch"] = bool(c)
                break
            except RuntimeError as e:
                out.setdefault("probe_errors", {})[f"{name}/coop={c}"] = str(e)
                torch.cuda.synchronize()
    return out


# --- the builds: the repo's wrappers on a swapped library, or the first
# design's C interface -------------------------------------------------------


@contextlib.contextmanager
def using(name, lib):
    """The wrappers launch ``lib``'s kernels for ``csrc/<name>.cu`` inside
    the block."""
    saved = _build._LIBS.get(name)
    _build._LIBS[name] = lib
    try:
        yield
    finally:
        if saved is None:
            _build._LIBS.pop(name, None)
        else:
            _build._LIBS[name] = saved


def _redesigned(lib, name) -> bool:
    return hasattr(lib, f"{name}_bwd_clusters")


def _type_decoder(lib):
    """Types ``lib``'s ``csrc/decoder_scan.cu`` interface for the wrappers:
    ``decoder_scan._lib`` types the repo's; a build of K7's first design (no
    ``decoder_scan_fwd_tma_f32``; ``k7_call`` drives its K7 directly) gets
    its K8 interface typed here."""
    if hasattr(lib, "decoder_scan_fwd_tma_f32"):
        lib._typed = False
        return
    lib.decoder_scan_bwd_f32.argtypes = [ctypes.POINTER(ds._BwdArgs), ds._P]
    lib.decoder_scan_bwd_f32.restype = ds._I
    lib.decoder_scan_bwd_clusters.argtypes = [ds._I] * 5 + [ctypes.POINTER(ds._I)] * 3
    lib.decoder_scan_bwd_clusters.restype = ds._I
    lib._typed = True


def _type_lstm(lib):
    """Types ``lib``'s ``csrc/lstm_scan.cu`` interface for the wrappers:
    ``lstm_scan._lib`` types the repo's; a build of the first K3 design
    (no ``lstm_scan_fwd_clusters``) gets that design's forward typed here,
    for ``k3_call`` to drive directly, and its K4 interface typed as the
    wrapper expects when it has the redesigned one."""
    if hasattr(lib, "lstm_scan_fwd_clusters"):
        lib._typed = False
        return
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lstm_scan_fwd_f32.argtypes = [p] * 10 + [i] * 8 + [f, f, p]
    lib.lstm_scan_fwd_f32.restype = i
    if _redesigned(lib, "lstm_scan"):
        lib.lstm_scan_bwd_f32.argtypes = [p] * 16 + [i] * 10 + [f, f, p]
        lib.lstm_scan_bwd_f32.restype = i
        lib.lstm_scan_bwd_clusters.argtypes = [i] * 6 + [ctypes.POINTER(i)] * 3
        lib.lstm_scan_bwd_clusters.restype = i
    lib._typed = True


def k4_call(lib, x):
    """K4 of build ``lib`` on inputs ``x``: a callable returning (dgx, dU,
    dh0, dc0)."""
    dy, dcT, saved, rh = x["dy"], x["dcT"], x["saved"], x["rh"]
    if _redesigned(lib, "lstm_scan"):
        _type_lstm(lib)

        def run():
            with using("lstm_scan", lib):
                dgx, du, dh0, (dc0,) = ls.lstm_scan_bwd_cuda(dy, (dcT,), *saved, *rh,
                                                             forget_bias=0.0)
            return dgx, du, dh0, dc0
        return run
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lstm_scan_bwd_f32.argtypes = [p] * 15 + [i] * 8 + [f, f, p]
    lib.lstm_scan_bwd_f32.restype = i
    gates, (cs,), (c0,), hs, h0, U = saved
    ids, mask, lengths, scale = rh
    T, B, G = gates.shape
    H = U.shape[0]
    ptr = lambda t: None if t is None else t.data_ptr()
    mode, k, ids_rows, mask_rows = ls._mode_args(ids, mask, T, B, H)

    def run():
        dgx = torch.empty((T, B, G), device="cuda")
        du = torch.empty((H, G), device="cuda")
        dh0, dc0 = torch.empty((B, H), device="cuda"), torch.empty((B, H), device="cuda")
        code = lib.lstm_scan_bwd_f32(
            dy.data_ptr(), dcT.data_ptr(), gates.data_ptr(), cs.data_ptr(), c0.data_ptr(),
            hs.data_ptr(), h0.data_ptr(), U.data_ptr(), ptr(ids), ptr(mask), ptr(lengths),
            dgx.data_ptr(), du.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), T, B, H, mode, k,
            ids_rows, mask_rows, int(lengths is not None), float(scale), 0.0,
            torch.cuda.current_stream().cuda_stream)
        assert code == 0, code
        return dgx, du, dh0, dc0
    return run


class _FirstBwdArgs(ctypes.Structure):
    """The first K8 design's argument struct."""
    _fields_ = ([(n, ds._I) for n in ("T", "B", "H", "S", "nl", "ragged")]
                + [(n, ds._P) for n in ("dy", "dhT", "dcT", "dfT", "gates", "hs", "cs",
                                        "htil", "alpha", "h0", "c0", "f0", "us", "ws", "wf",
                                        "wc", "ep", "eo", "lens")]
                + [("sites", ds._SiteArg * (2 * ds.KERNEL_LAYERS))]
                + [(n, ds._P) for n in ("dgx0", "dus", "dws", "dbs", "dwf", "dwc", "dep",
                                        "deo", "dh0", "dc0", "df0", "dgs", "dpre", "dctx",
                                        "dcur")])


def k8_call(lib, bargs):
    """K8 of build ``lib`` on ``kernel_bwd``'s arguments: a callable
    returning its outputs as a flat list."""
    flat = lambda g: [x for v in g for x in (v if isinstance(v, list) else [v])]
    if _redesigned(lib, "decoder_scan"):
        _type_decoder(lib)

        def run():
            with using("decoder_scan", lib):
                return flat(ds.kernel_bwd(*bargs))
        return run
    lib.decoder_scan_bwd_f32.argtypes = [ctypes.POINTER(_FirstBwdArgs), ds._P]
    lib.decoder_scan_bwd_f32.restype = ds._I
    (descs, tables, res, dout, us, ws, w_feed, w_comb, enc_proj, enc_out, h0, c0,
     feed0, lengths) = bargs
    htil, gates, hs, cs, alpha = res
    nl = len(us)
    _, T, B, G = gates.shape
    H, S = w_feed.shape[0], enc_out.shape[1]
    u_st, w_st = torch.stack(list(us)), torch.stack(list(ws))

    def run():
        e = lambda *shape: torch.empty(shape, device="cuda")
        outs = dict(dgx0=e(T, B, G), dus=e(nl, H, G), dws=e(nl - 1, H, G), dbs=e(nl - 1, G),
                    dwf=e(H, G), dwc=e(2 * H, H), dep=e(B, S, H), deo=e(B, S, H),
                    dh0=e(nl, B, H), dc0=e(nl, B, H), df0=e(B, H), dgs=e(nl - 1, B, G),
                    dpre=e(B, H), dctx=e(B, H), dcur=e(B, H))
        a = _FirstBwdArgs(T, B, H, S, nl, int(lengths is not None),
                          *(ds._ptr(t) for t in (*dout, gates, hs, cs, htil, alpha, h0, c0,
                                                 feed0, u_st, w_st, w_feed, w_comb, enc_proj,
                                                 enc_out, lengths)),
                          ds._site_args(descs, tables, T, B, H, htil),
                          *(ds._ptr(t) for t in outs.values()))
        code = lib.decoder_scan_bwd_f32(ctypes.byref(a), torch.cuda.current_stream().cuda_stream)
        assert code == 0, code
        o = outs
        return [o["dgx0"], o["dwf"], *o["dus"].unbind(0), *o["dws"].unbind(0),
                *o["dbs"].unbind(0), o["dwc"], o["dep"], o["deo"], o["dh0"], o["dc0"], o["df0"]]
    return run


def k3_call(lib, x):
    """K3 of build ``lib`` on inputs ``x``: a callable returning (hs, gates,
    cs)."""
    gx, U, h0, c0 = x["ins"]
    _type_lstm(lib)
    if hasattr(lib, "lstm_scan_fwd_clusters"):

        def run():
            with using("lstm_scan", lib):
                hs, gates, (cs,) = ls.lstm_scan_fwd_cuda(gx, U, h0, (c0,), *x["rh"],
                                                         forget_bias=0.0)
            return hs, gates, cs
        return run
    ids, mask, lengths, scale = x["rh"]
    T, B, G = gx.shape
    H = U.shape[0]
    mode, k, ids_rows, mask_rows = ls._mode_args(ids, mask, T, B, H)
    ptr = lambda t: None if t is None else t.data_ptr()

    def run():
        hs, cs = torch.empty((T, B, H), device="cuda"), torch.empty((T, B, H), device="cuda")
        gates = torch.empty((T, B, G), device="cuda")
        code = lib.lstm_scan_fwd_f32(gx.data_ptr(), U.data_ptr(), h0.data_ptr(), c0.data_ptr(), ptr(ids), ptr(mask),
                  ptr(lengths), hs.data_ptr(), gates.data_ptr(), cs.data_ptr(), T, B, H, mode, k,
                  ids_rows, mask_rows, int(lengths is not None), float(scale), 0.0,
                  torch.cuda.current_stream().cuda_stream)
        assert code == 0, code
        return hs, gates, cs
    return run


class _FirstFwdArgs(ctypes.Structure):
    """The first K7 design's argument struct."""
    _fields_ = ([(n, ds._I) for n in ("T", "B", "H", "S", "nl", "ragged")]
                + [(n, ds._P) for n in ("gx0", "us", "ws", "bs", "wf", "wc", "ep", "eo", "sb",
                                        "h0", "c0", "f0", "lens")]
                + [("sites", ds._SiteArg * (2 * ds.KERNEL_LAYERS))]
                + [(n, ds._P) for n in ("htil", "alpha", "gates", "hs", "cs", "hcur", "ctx")])


def k7_call(lib, fargs):
    """K7 of build ``lib`` on ``kernel_fwd``'s arguments: a callable
    returning (htil, gates, hs, cs, alpha)."""
    if hasattr(lib, "decoder_scan_fwd_tma_f32"):
        lib._typed = False

        def run():
            with using("decoder_scan", lib):
                return list(ds.kernel_fwd(*fargs))
        return run
    lib.decoder_scan_fwd_f32.argtypes = [ctypes.POINTER(_FirstFwdArgs), ds._P]
    lib.decoder_scan_fwd_f32.restype = ds._I
    (descs, tables, gx0, us, ws, bs, w_feed, w_comb, enc_proj, enc_out, score_bias, h0, c0,
     feed0, lengths) = fargs
    nl = len(us)
    T, B, G = gx0.shape
    H, S = w_feed.shape[0], enc_out.shape[1]
    u_st, w_st, b_st = torch.stack(list(us)), torch.stack(list(ws)), torch.stack(list(bs))

    def run():
        e = lambda *shape: torch.empty(shape, device="cuda")
        outs = [e(T, B, H), e(T, B, S), e(nl, T, B, G), e(nl, T, B, H), e(nl, T, B, H),
                e(nl, B, H), e(B, H)]      # htil, alpha, gates, hs, cs; scratch hcur, ctx
        a = _FirstFwdArgs(T, B, H, S, nl, int(lengths is not None),
                          *(ds._ptr(t) for t in (gx0, u_st, w_st, b_st, w_feed, w_comb, enc_proj,
                                                 enc_out, score_bias, h0, c0, feed0, lengths)),
                          ds._site_args(descs, tables, T, B, H, gx0),
                          *(ds._ptr(t) for t in outs))
        code = lib.decoder_scan_fwd_f32(ctypes.byref(a), torch.cuda.current_stream().cuda_stream)
        assert code == 0, code
        htil, alpha, gates, hs, cs = outs[:5]
        return [htil, gates, hs, cs, alpha]
    return run


def f64_dist(got, want):
    """max |got - want| / max(1, max |want|) over the tensors of a group."""
    return max((g.double() - w).abs().max().item() / max(1.0, w.abs().max().item())
               for g, w in zip(got, want))


def k4_inputs(cs, gen, T, B, H, p):
    """K4's operands (the plain forward's residuals) and the float64 plain
    backward on them."""
    cell = ls.lstm_cell_spec(0.0)
    gx, U, h0, c0, ids, mask, lengths, scale, dy, dcT = cs.scan_inputs(
        gen, T, B, H, p, "structured")
    rh = (ids, mask, lengths, scale)
    hs, gates, (cst,) = cs_mod.plain_fwd(cell, gx, U, h0, (c0,), *rh)
    saved = (gates, (cst,), (c0,), hs, h0, U)
    plain = cs_mod.plain_bwd(cell, dy, (dcT,), *saved, *rh)
    d = lambda t: t.double()
    ref = cs_mod.plain_bwd(cell, d(dy), (d(dcT),), d(gates), (d(cst),), (d(c0),), d(hs),
                           d(h0), d(U), *rh)
    flat = lambda o: (o[0], o[1], o[2], o[3][0])
    return dict(dy=dy, dcT=dcT, saved=saved, rh=rh), flat(plain), flat(ref)


def k8_inputs(cs, gen):
    """K8's operands (the plain forward's residuals) and the float64 plain
    backward on them."""
    T, B, S, H, p = K8_SHAPE
    descs, tables, o, lengths, dout = cs.decoder_inputs(gen, T, B, S, H, "sp", p, 1, False)
    fargs = (descs, tables, o["gx0"], o["us"], o["ws"], o["bs"], o["w_feed"], o["w_comb"],
             o["enc_proj"], o["enc_out"], o["score_bias"], o["h0"], o["c0"], o["feed0"],
             lengths)
    res = ds.plain_fwd(*fargs)
    bargs = (descs, tables, res, dout, o["us"], o["ws"], o["w_feed"], o["w_comb"],
             o["enc_proj"], o["enc_out"], o["h0"], o["c0"], o["feed0"], lengths)
    flat = lambda g: [x for v in g for x in (v if isinstance(v, list) else [v])]
    plain = flat(ds.plain_bwd(*bargs))
    d = lambda t: t.double()
    dd = lambda v: [d(t) for t in v]
    ref = flat(ds.plain_bwd(descs, tables, tuple(dd(res)), tuple(dd(dout)), dd(o["us"]),
                            dd(o["ws"]), d(o["w_feed"]), d(o["w_comb"]), d(o["enc_proj"]),
                            d(o["enc_out"]), d(o["h0"]), d(o["c0"]), d(o["feed0"]), lengths))
    return bargs, plain, ref


def k3_inputs(cs, gen, T, B, H, p):
    """K3's operands, the float32 plain forward on them and a float64 run of
    it."""
    cell = ls.lstm_cell_spec(0.0)
    gx, U, h0, c0, ids, mask, lengths, scale, _, _ = cs.scan_inputs(gen, T, B, H, p, "structured")
    rh = (ids, mask, lengths, scale)
    flat = lambda o: (o[0], o[1], o[2][0])
    plain = flat(cs_mod.plain_fwd(cell, gx, U, h0, (c0,), *rh))
    d = lambda t: t.double()
    ref = flat(cs_mod.plain_fwd(cell, d(gx), d(U), d(h0), (d(c0),), *rh))
    return dict(ins=(gx, U, h0, c0), rh=rh), plain, ref


def k7_inputs(cs, gen):
    """K7's operands (``kernel_fwd``'s arguments), the float32 plain forward
    on them and a float64 run of it."""
    T, B, S, H, p = K8_SHAPE
    descs, tables, o, lengths, _ = cs.decoder_inputs(gen, T, B, S, H, "sp", p, 1, False)
    keys = ("gx0", "us", "ws", "bs", "w_feed", "w_comb", "enc_proj", "enc_out", "score_bias",
            "h0", "c0", "feed0")
    fargs = (descs, tables, *(o[k] for k in keys), lengths)
    plain = list(ds.plain_fwd(*fargs))
    d = lambda v: [x.double() for x in v] if isinstance(v, list) else v.double()
    ref = list(ds.plain_fwd(descs, tables, *(d(o[k]) for k in keys), lengths))
    return fargs, plain, ref


# kind -> (source, phase flag, C function naming the phases)
PHASE_SRC = {"k3": ("lstm_scan", "-DLSTM_PHASES", "lstm_scan_fwd_phase_names"),
             "k4": ("lstm_scan", "-DLSTM_PHASES", "lstm_scan_phase_names"),
             "k7": ("decoder_scan", "-DDEC_PHASES", "decoder_scan_fwd_phase_names"),
             "k8": ("decoder_scan", "-DDEC_PHASES", "decoder_scan_phase_names")}


def phases(kind, run_of, ms, T):
    """The repo build's step split into its phases: its source built with
    the phase flag, one launch; thread 0's cycles per phase, averaged over
    the CTAs that counted any, as shares of the step and as us a step at
    the uninstrumented build's time ``ms``."""
    name, flag, names_fn = PHASE_SRC[kind]
    lib = compile_lib(_build.CSRC / f"{name}.cu", f"{name}_phases", [flag])
    getattr(lib, f"{name}_phases").argtypes = [ctypes.c_void_p]
    getattr(lib, f"{name}_phases").restype = ctypes.c_int
    getattr(lib, names_fn).restype = ctypes.c_char_p
    names = getattr(lib, names_fn)().decode().split(",")
    buf = (ctypes.c_ulonglong * (1024 * 16))()
    run = run_of(lib)
    assert getattr(lib, f"{name}_phases")(buf) == 0      # zero
    run()
    torch.cuda.synchronize()
    assert getattr(lib, f"{name}_phases")(buf) == 0
    cyc = [[buf[c * 16 + i] for i in range(len(names))] for c in range(1024)]
    cyc = [c for c in cyc if any(c)]
    mean = [sum(c[i] for c in cyc) / len(cyc) for i in range(len(names))]
    tot = sum(mean)
    return {ph: {"share": m / tot, "us_per_step": m / tot * ms * 1e3 / T}
            for ph, m in zip(names, mean)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--phases", action="store_true",
                    help="also split the repo build's step into phases")
    ap.add_argument("--no-probes", action="store_true", help="skip the floor probes")
    ap.add_argument("--kernels", default="k3,k4,k7,k8",
                    help="comma-separated subset of k3,k4,k7,k8 to run")
    ap.add_argument("--phase-probes", action="store_true",
                    help="also time pieces of the redesigned step alone")
    ap.add_argument("--wg-rate", type=float, action="append", default=[], metavar="P",
                    help="also K4 at zaremba-medium's shape with RH rate P (WG runs dense "
                         "over the units, BP over the kept ones)")
    ap.add_argument("--turns", type=int, default=2,
                    help="rounds of the builds in turns (a, b, ..., b, a)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scan_bench: no CUDA device")
    from repro_torch.device import set_full_fp32
    set_full_fp32()
    import chip_smoke as cs   # the repo root's inputs and timing helpers

    libs = {"repo": (ls._lib(), ds._lib())}
    for name, log in _build.BUILD_LOG.items():
        if name in ("lstm_scan", "decoder_scan"):
            for line in log.splitlines():
                if any(w in line for w in ("Compiling entry", "registers", "spill")):
                    print(f"  [{name}] {line.strip()}")
    for spec in args.src:
        name, path = spec.split("=", 1)
        libs[name] = tuple(compile_lib(Path(path) / f"{n}.cu", f"{n}_variant_{name}")
                           for n in ("lstm_scan", "decoder_scan"))
    kinds = set(args.kernels.split(","))
    T, B, H, _ = K4_SHAPES["zaremba"]
    k4_shapes = dict(K4_SHAPES, **{f"zaremba_p{p:g}": (T, B, H, p) for p in args.wg_rate})
    out = {"card": cs.smi_line(), "k4_shapes": k4_shapes, "k8_shape": K8_SHAPE}
    gen = torch.Generator().manual_seed(0)
    rows = {}
    if "k3" in kinds:
        for tag, (T, B, H, p) in K4_SHAPES.items():
            x, plain, ref = k3_inputs(cs, gen, T, B, H, p)
            k = x["rh"][0].shape[1]
            rows[f"k3_{tag}"] = dict(T=T, kind="k3", plain=plain, ref=ref, B=B, H=H, k=k,
                                     probe_k=k, run_of=lambda lib, x=x: k3_call(lib, x))
    if "k4" in kinds:
        for tag, (T, B, H, p) in k4_shapes.items():
            x, plain, ref = k4_inputs(cs, gen, T, B, H, p)
            k = x["rh"][0].shape[1]
            rows[f"k4_{tag}"] = dict(T=T, kind="k4", plain=plain, ref=ref, B=B, H=H, k=k,
                                     probe_k=k, run_of=lambda lib, x=x: k4_call(lib, x))
    T, B, S, H, p = K8_SHAPE
    if "k7" in kinds:
        fargs, plain, ref = k7_inputs(cs, gen)
        k = fargs[1][1].shape[1]
        # a gate phase reads two sites' kept units
        rows["k7_nmt"] = dict(T=T, kind="k7", plain=plain, ref=ref, B=B, H=H, k=k, probe_k=2 * k,
                              run_of=lambda lib: k7_call(lib, fargs))
    if "k8" in kinds:
        bargs, plain, ref = k8_inputs(cs, gen)
        k = bargs[1][1].shape[1]
        rows["k8_nmt"] = dict(T=T, kind="k8", plain=plain, ref=ref, B=B, H=H, k=k, probe_k=k,
                              run_of=lambda lib: k8_call(lib, bargs))
    for r in rows.values():
        r["fns"] = {n: r["run_of"](lib[0 if r["kind"] in ("k3", "k4") else 1])
                    for n, lib in libs.items()}
    if not args.no_probes:
        out["floor"] = {}
        for row, r in rows.items():
            fwd = r["kind"] in ("k3", "k7")
            fl = floor_probes(cs, r["T"], r["B"], r["H"], r["probe_k"], forward=fwd)
            # K7's step chains four dependent exchanges
            fl["floor_ms"] = floor_ms(fl["us_per_step"], r["T"], 4 if r["kind"] == "k7" else 1)
            if r["kind"] == "k8":
                fl["floor_ms_3_exchanges"] = floor_ms(fl["us_per_step"], r["T"], 3)
            out["floor"][row] = fl
    if args.phase_probes:
        out["phase_probes"] = {}
        for row, r in rows.items():
            if r["kind"] == "k4":
                plan = ls._bwd_plan(0, r["B"], r["H"], 1, r["k"])
                out["phase_probes"][row] = pp = phase_probes(cs, r["B"], r["H"], r["k"], plan)
                print(f"{row} pieces (us a call): " + ", ".join(
                    f"{n} {v:.3f}" for n, v in pp.items() if n != "plan") + f"; {pp['plan']}")
    out["f64_dist"] = {row: {"plain_f32": f64_dist(r["plain"], r["ref"])} for row, r in rows.items()}
    for row, r in rows.items():
        for n, fn in r["fns"].items():
            out["f64_dist"][row][n] = f64_dist(fn(), r["ref"])
    out["ms"] = {row: {n: [] for n in r["fns"]} for row, r in rows.items()}
    names = list(dict.fromkeys(n for r in rows.values() for n in r["fns"]))
    turns = names + list(reversed(names))
    for _ in range(args.turns):
        for n in turns:
            for row, r in rows.items():
                if n in r["fns"]:
                    out["ms"][row][n].append(cs.time_ms(r["fns"][n], cold_l2=True))
    if args.phases:
        out["phases"] = {}
        for row, r in rows.items():
            out["phases"][row] = phases(r["kind"], r["run_of"], min(out["ms"][row]["repo"]),
                                        r["T"])
    for row, r in rows.items():
        if "floor" in out:
            fl = out["floor"][row]
            print(f"{row} floor: " + ", ".join(f"{k} {v:.3f} us/step"
                                                for k, v in fl["us_per_step"].items())
                  + f"; floor {fl['floor_ms']:.4f} ms (clusters resident: "
                  f"{fl['max_clusters_of']})")
        for n, t in out["ms"][row].items():
            print(f"{row} {n}: {min(t):.4f} ms (best of {len(t)}; median "
                  f"{sorted(t)[len(t) // 2]:.4f}); float64 {out['f64_dist'][row][n]:.3e} "
                  f"(plain f32 {out['f64_dist'][row]['plain_f32']:.3e})")
        if args.phases:
            print(f"{row} phases: " + ", ".join(
                f"{k} {v['share']:.3f} ({v['us_per_step']:.3f} us)"
                for k, v in out["phases"][row].items()))
    print(f"card: {out['card']}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
