// Block-gather GEMM for structured dropout on Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernels of repro/kernels/gather_matmul.py:
//   K1  _mm_kernel          via gather_matmul          (one ids row)
//   K2  _mm_kernel_stepped  via gather_matmul_stepped  (a (T, nk) ids table)
// Both are the same product, so one kernel serves them: K1 is T = 1.
//
// With uid[t] the kept unit ids of step t (block ids expanded by the
// wrapper, so any dropout block size works, including the paper's 1):
//   MODE 0  FP    y[t] (M, N) = a_c[t] (M, k) @ b[uid[t], :]      (a may be
//                 full width and gathered on its columns instead)
//   MODE 1  BP    y[t] (M, k) = a[t] (M, N)   @ b[uid[t], :]^T    (compact)
//   MODE 2  COLS  y[t] (M, k) = a[t] (M, K)   @ b[:, uid[t]]      (compact)
// times alpha (the inverted-dropout scale), accumulated in f32 FFMA.
//
// What bounds each row on the H100 (the main paths' shapes; f32 FFMA peak
// 67 TFLOP/s, HBM 3.35 TB/s):
//   K2 (T = 35 or 50 steps of M = 20 or 64 rows, k = 325 / 358 of
//   H = 650 / 512): 1.18 / 4.69 GFLOP, so the FFMA rate is the roofline
//   (17.7 / 70.0 us); each step's gathered rows of b also cross L2 once per
//   row tile (T k N 4 bytes: 118 / 147 MB). In practice the issue rate is
//   the limit: every FFMA shares the schedulers with the copies, the
//   shared-memory reads and the loop.
//   K1 (one step): 34 / 94 MFLOP over 3-4 MB, a microsecond of either; a
//   call really pays latency and parallelism: BP contracts over
//   C = 4H = 2600 / 2048 into only k = 325 / 358 output columns, and the
//   launch of even one CTA of one chunk takes ~2 us on the card.
// Design, against each:
//   * Row tiles of exactly M: 20 rows (zaremba's batch, 160 threads) or 64
//     (luong-nmt's, 256 threads; larger M takes several), so each step's
//     gathered b is read once from L2 and no FFMA goes to padding rows.
//     Column tiles of 16 or 32 (BP), 32, 64 or 128 (FP), 64 (COLS).
//   * Each thread owns a 4 x 4 output tile (4 x 8 on the 64 x 128 tile) and
//     reads its operands from shared memory as float4, four contraction
//     steps at a time: 8 vector loads for 64 FFMAs. A (and B in BP) is
//     stored contraction-contiguous in rows padded to 36 floats, B in
//     FP/COLS output-contiguous, so a quarter-warp's float4 reads hit
//     distinct banks. Where the tile has fewer 4 x 4 tiles than the CTA has
//     threads, KS groups of threads take every KS-th group of four
//     contraction steps (k-slices), summed through shared memory at the end.
//   * Narrow outputs (BP, and K1's one step) split the contraction over a
//     thread block cluster of S <= 8 CTAs; the S partial tiles are summed
//     through distributed shared memory in rank order, each rank writing
//     1/S of the tile: one launch, no atomics, the same bits every run.
//   * The contraction streams in 32-wide chunks through a 4-stage cp.async
//     ring (three chunks in flight while one is multiplied); ragged edges
//     are zero-filled by the copy itself. The CTA's unit ids are staged in
//     shared memory first, so no gathered address waits on a global load,
//     and each thread's copy slots (row pointers, shared addresses, row
//     masks) are set up once: a copy in the loop is a pointer add, a
//     select and the cp.async, with no branch. Operands whose rows start on
//     16-byte boundaries (base pointer and row length) are copied 16 bytes
//     at a time, the others 4 bytes at a time (VA / VB): zaremba's and
//     luong-nmt's compact FP rows (k = 325, 358) are the latter. COLS,
//     which gathers along the fast axis, always copies 4 bytes; FP with a
//     gathered on its columns (AG) too.
// The tile, split and copy width are chosen by the wrapper's _plan
// (kernels/gather_matmul.py, tuned with launch/tune_gather.py);
// gather_matmul_f32 checks the plan and returns cudaErrorInvalidValue for
// one it cannot run.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 32;           // contraction chunk
constexpr int NS = 4;            // cp.async ring stages
constexpr int LDK = BK + 4;      // row of a contraction-contiguous tile
constexpr int MAX_SPLIT = 8;     // portable cluster size
constexpr int MAX_SMEM = 232448; // opt-in shared memory of one CTA

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16-byte copy of which the first `bytes` are read and the rest zeroed.
// The copies carry no memory clobber, so the compiler may batch the id
// reads and address arithmetic around them; cp_wait orders the ring.
__device__ __forceinline__ void cp16(unsigned dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp4(unsigned dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Thread layout of a BM x BN tile: RG x CG threads of 4 x TN outputs each
// (TN = 4: 8 float4 reads of shared memory for 64 FFMAs), times KS
// k-slices.
template <int BM, int BN, int TN>
struct Shape {
  static constexpr int TM = 4;
  static constexpr int RG = BM / TM;
  static constexpr int CG = BN / TN;
  static constexpr int NT = BM == 20 ? 160 : 256;
  static constexpr int KS = NT / (RG * CG);
  static constexpr bool ok = KS >= 1 && KS * RG * CG == NT && (BK / 4) % KS == 0;
};

template <int MODE, int BM, int BN>
__host__ __device__ constexpr int stage_floats() {
  return BM * LDK + (MODE == 1 ? BN * LDK : BK * (BN + 4));
}

// Shared memory of one CTA, in floats: the ring, or the k-slice partial
// tiles that reuse it at the end, whichever is larger.
template <int MODE, int BM, int BN, int TN>
__host__ __device__ constexpr int ring_floats() {
  return NS * stage_floats<MODE, BM, BN>() > Shape<BM, BN, TN>::KS * BM * BN
             ? NS * stage_floats<MODE, BM, BN>() : Shape<BM, BN, TN>::KS * BM * BN;
}

__device__ __forceinline__ float lane(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

template <int MODE, int BM, int BN, int TN_, bool VA, bool VB, bool AG>
__global__ void __launch_bounds__(Shape<BM, BN, TN_>::NT)
gather_mm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const int* __restrict__ ids, float* __restrict__ y,
                 int M, int C, int O, int lda, int ldb, int ids_tstride,
                 int split, int csplit, float alpha) {
  using SH = Shape<BM, BN, TN_>;
  static_assert(SH::ok, "bad tile");
  constexpr int NT = SH::NT, CG = SH::CG, RG = SH::RG, KS = SH::KS;
  constexpr int TM = SH::TM, TN = TN_;
  constexpr int LDB = MODE == 1 ? LDK : BN + 4;   // row of the B tile
  constexpr int STAGE = stage_floats<MODE, BM, BN>();
  constexpr int TILE = BM * BN;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int* sid = reinterpret_cast<int*>(smem + ring_floats<MODE, BM, BN, TN_>());

  const int tid = threadIdx.x;
  const int rank = blockIdx.x % split;           // cluster dims (split, 1, 1)
  const int o0 = (blockIdx.x / split) * BN;
  const int m0 = blockIdx.y * BM;
  const int t = blockIdx.z;
  const int cb = rank * csplit;                  // this CTA's contraction
  const int ce = min(C, cb + csplit);
  const int nch = ce > cb ? (ce - cb + BK - 1) / BK : 0;
  const int* __restrict__ uid = ids + (long)t * ids_tstride;
  const float* __restrict__ at = a + (long)t * M * lda;

  // The unit ids this CTA gathers by: its contraction range (FP) or its
  // output columns (BP, COLS).
  if (MODE == 0) {
    for (int i = tid; i < ce - cb; i += NT) sid[i] = __ldg(uid + cb + i);
  } else {
    for (int i = tid; i < BN; i += NT) sid[i] = o0 + i < O ? __ldg(uid + o0 + i) : 0;
  }
  __syncthreads();

  // Copy slots. In every chunk a thread copies the same positions of each
  // tile (slot q at its first row plus q * STEP rows); only the chunk's
  // offset and, in FP, the unit ids change. Row pointers, shared addresses
  // and row masks are set up once here, so a copy in the loop is a pointer
  // add, a select and the cp.async, with no branch.
  const unsigned s0 = smem_u32(smem);
  constexpr unsigned SB = 4u * STAGE;                // bytes per ring stage
  // a: BM rows x BK, AW floats a copy; AQ slots cover the BM rows exactly.
  constexpr int AW = VA ? 4 : 1, APR = BK / AW, ASTEP = NT / APR;
  constexpr int AQ = BM / ASTEP;
  static_assert(NT % APR == 0 && BM % ASTEP == 0, "a copy slots");
  const int a_col = AW * (tid % APR), a_row = tid / APR;
  const unsigned a_dst = s0 + 4u * (a_row * LDK + a_col);
  const float* a_rowp[AQ];                           // nullptr: row >= M
#pragma unroll
  for (int q = 0; q < AQ; ++q) {
    const int m = m0 + a_row + q * ASTEP;
    a_rowp[q] = m < M ? at + (long)m * lda + (AG ? 0 : a_col) : nullptr;
  }
  // b, 16-byte copies: FP rows uid[c] (BN / 4 copies a row, a slot's column
  // fixed); BP rows uid[o], fixed for the CTA, so their pointers are too.
  constexpr int BPR = MODE == 1 ? BK / 4 : BN / 4, BSTEP = NT / BPR;
  constexpr int BROWS = MODE == 1 ? BN : BK;
  constexpr int BQ = (BROWS + BSTEP - 1) / BSTEP;
  static_assert(!VB || NT % BPR == 0, "b copy slots");
  const int b_col = 4 * (tid % BPR), b_row = tid / BPR;
  const unsigned b_dst = s0 + 4u * (BM * LDK + b_row * LDB + b_col);
  const float* b_rowp[MODE == 1 && VB ? BQ : 1];     // BP; nullptr: o >= O
  if constexpr (MODE == 1 && VB) {
#pragma unroll
    for (int q = 0; q < BQ; ++q) {
      const int r = b_row + q * BSTEP;
      b_rowp[q] = r < BN && o0 + r < O ? b + (long)sid[r] * ldb + b_col : nullptr;
    }
  }
  const float* b_colp = b + o0 + b_col;              // FP
  const bool b_col_ok = o0 + b_col < O;

  // Issue the copies of chunk j into ring stage st.
  auto load = [&](int j, int st) {
    const int c0 = cb + j * BK;
    const unsigned stage = st * SB;
    {                                                // a
      const int c = c0 + a_col;
      int bytes, off;
      if constexpr (AG) {                            // a's columns uid[c]
        bytes = c < ce ? 4 : 0;
        off = sid[min(c, ce - 1) - cb];
      } else {
        bytes = 4 * max(0, min(AW, ce - c));
        off = c0;
      }
#pragma unroll
      for (int q = 0; q < AQ; ++q) {
        const bool ok = bytes && a_rowp[q] != nullptr;
        const unsigned dst = a_dst + stage + 4u * q * ASTEP * LDK;
        const float* g = ok ? a_rowp[q] + off : a;
        if constexpr (VA) cp16(dst, g, ok ? bytes : 0);
        else cp4(dst, g, ok ? 4 : 0);
      }
    }
    if constexpr (MODE == 0 && VB) {                 // rows uid[c] of b
#pragma unroll
      for (int q = 0; q < BQ; ++q) {
        const int kk = b_row + q * BSTEP;
        if (BROWS % BSTEP != 0 && kk >= BK) break;   // past the tile
        const int c = c0 + kk;
        const bool ok = b_col_ok && c < ce;
        const int id = sid[min(c, ce - 1) - cb];
        cp16(b_dst + stage + 4u * q * BSTEP * LDB, ok ? b_colp + (long)id * ldb : b,
             ok ? 16 : 0);
      }
    } else if constexpr (MODE == 1 && VB) {          // rows uid[o] of b
      const int n = max(0, min(4, ce - (c0 + b_col)));
#pragma unroll
      for (int q = 0; q < BQ; ++q) {
        if (BROWS % BSTEP != 0 && b_row + q * BSTEP >= BN) break;
        const bool ok = n && b_rowp[q] != nullptr;
        cp16(b_dst + stage + 4u * q * BSTEP * LDK, ok ? b_rowp[q] + c0 : b, ok ? 4 * n : 0);
      }
    } else {                                         // 4-byte copies of b
      float* Bs = smem + st * STAGE + BM * LDK;
      constexpr int N1 = BK * BN;
#pragma unroll 4
      for (int q = 0; q < (N1 + NT - 1) / NT; ++q) {
        const int e = tid + q * NT;
        if (N1 % NT == 0 || e < N1) {
          int c, o, dst;
          if constexpr (MODE == 1) {                 // rows uid[o], along c
            o = e / BK; c = e % BK; dst = o * LDB + c;
          } else {                                   // along o
            c = e / BN; o = e % BN; dst = c * LDB + o;
          }
          c += c0;
          o += o0;
          const bool ok = c < ce && o < O;
          const float* g = b;
          if (ok) {
            if constexpr (MODE == 0) g = b + (long)sid[c - cb] * ldb + o;
            else if constexpr (MODE == 1) g = b + (long)sid[o - o0] * ldb + c;
            else g = b + (long)c * ldb + sid[o - o0];
          }
          cp4(smem_u32(Bs + dst), g, ok ? 4 : 0);
        }
      }
    }
  };

  // Thread (cgi, rgi, ks): rows m0 + rgi + RG i; columns o0 + 4 CG u +
  // 4 cgi + j (FP, COLS: float4 groups u) or o0 + cgi + CG j (BP); k-groups
  // ks, ks + KS, ... of each chunk.
  const int cgi = tid % CG;
  const int rgi = (tid / CG) % RG;
  const int ks = tid / (CG * RG);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // One chunk: the KS-strided k-groups of 4, fragments read as float4.
  auto compute = [&](int st) {
    const float* As = smem + st * STAGE + rgi * LDK;
    const float* Bs = smem + st * STAGE + BM * LDK;
#pragma unroll
    for (int g = 0; g < BK / 4 / KS; ++g) {
      const int kk = 4 * (ks + g * KS);
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(As + RG * i * LDK + kk);
      if constexpr (MODE == 1) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float4 bv = *reinterpret_cast<const float4*>(Bs + (cgi + CG * j) * LDK + kk);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int i = 0; i < TM; ++i)
              acc[i][j] = fmaf(lane(av[i], q), lane(bv, q), acc[i][j]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float4 bw[TN / 4];
#pragma unroll
          for (int u = 0; u < TN / 4; ++u)
            bw[u] = *reinterpret_cast<const float4*>(Bs + (kk + q) * LDB + 4 * (CG * u + cgi));
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(lane(av[i], q), lane(bw[j / 4], j % 4), acc[i][j]);
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nch) load(s, s);
    cp_commit();
  }
  for (int j = 0; j < nch; ++j) {
    cp_wait<NS - 2>();            // chunk j has landed (this thread's copies)
    __syncthreads();              // ... everyone's; stage (j - 1) % NS is free
    if (j + NS - 1 < nch) load(j + NS - 1, (j + NS - 1) % NS);
    cp_commit();
    compute(j % NS);
  }
  cp_wait<0>();

  // Sum the k-slices, then the cluster's contraction splits, in fixed order.
  __syncthreads();                               // the ring is free
  float* red = smem;                             // [KS][BM][BN]
  float* yt = y + (long)t * M * O;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float* r = red + ks * TILE + (rgi + RG * i) * BN;
    if constexpr (MODE == 1) {
#pragma unroll
      for (int j = 0; j < TN; ++j) r[cgi + CG * j] = acc[i][j];
    } else {
#pragma unroll
      for (int u = 0; u < TN / 4; ++u)
        *reinterpret_cast<float4*>(r + 4 * (CG * u + cgi)) = make_float4(
            acc[i][4 * u], acc[i][4 * u + 1], acc[i][4 * u + 2], acc[i][4 * u + 3]);
    }
  }
  __syncthreads();
  if (KS > 1) {
    for (int e = tid; e < TILE; e += NT) {
      float v = red[e];
#pragma unroll
      for (int s = 1; s < KS; ++s) v += red[s * TILE + e];
      red[e] = v;
    }
  }
  if (split == 1) {
    for (int e = tid; e < TILE; e += NT) {       // the elements this thread summed
      const int m = m0 + e / BN, o = o0 + e % BN;
      if (m < M && o < O) yt[(long)m * O + o] = alpha * red[e];
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                                // every rank's partial tile is in place
  const int crank = (int)cluster.block_rank();
  for (int e = crank * NT + tid; e < TILE; e += split * NT) {
    float v = cluster.map_shared_rank(red, 0)[e];
    for (int s = 1; s < split; ++s) v += cluster.map_shared_rank(red, s)[e];
    const int m = m0 + e / BN, o = o0 + e % BN;
    if (m < M && o < O) yt[(long)m * O + o] = alpha * v;
  }
  cluster.sync();                                // keep red alive for the peers
}

struct Call {
  const float* a;
  const float* b;
  const int* ids;
  float* y;
  int T, M, C, O, lda, ldb, ids_tstride, a_gather, split, csplit;
  float alpha;
  cudaStream_t stream;
};

template <int MODE, int BM, int BN, int TN, bool VA, bool VB, bool AG = false>
int launch(const Call& p) {
  using SH = Shape<BM, BN, TN>;
  auto kern = gather_mm_kernel<MODE, BM, BN, TN, VA, VB, AG>;
  const int staged_ids = MODE == 0 ? p.csplit : BN;
  const size_t smem = sizeof(float) * (size_t)(ring_floats<MODE, BM, BN, TN>() + staged_ids);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  static bool opted_in = false;                  // once per instantiation
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((p.O + BN - 1) / BN) * p.split),
                     (unsigned)((p.M + BM - 1) / BM), (unsigned)p.T);
  cfg.blockDim = dim3(SH::NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = p.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kern, p.a, p.b, p.ids, p.y, p.M, p.C, p.O,
                                 p.lda, p.ldb, p.ids_tstride, p.split, p.csplit,
                                 p.alpha);
}

// The copy-width variants that exist: FP (4, 4), (4, 16), (16, 16) bytes
// for (a, b), and (4, 4) with a gathered on its columns; BP (4, 4),
// (16, 16); COLS (4, 4).
template <int MODE, int BM, int BN, int TN>
int dispatch(const Call& p, int va, int vb) {
  if constexpr (MODE == 2) {
    return !va && !vb ? launch<2, BM, BN, TN, false, false>(p) : (int)cudaErrorInvalidValue;
  } else {
    if constexpr (MODE == 0)
      if (p.a_gather) return !va && !vb ? launch<0, BM, BN, TN, false, false, true>(p)
                                        : (int)cudaErrorInvalidValue;
    if (!va && !vb) return launch<MODE, BM, BN, TN, false, false>(p);
    if (va && vb) return launch<MODE, BM, BN, TN, true, true>(p);
    if constexpr (MODE == 0)
      if (!va && vb) return launch<0, BM, BN, TN, false, true>(p);
    return (int)cudaErrorInvalidValue;
  }
}

// The tiles _plan chooses from: FP 32, 64 or (64 rows) 128 columns, BP 16
// or 32, COLS 64. 4 x 4 thread tiles, 4 x 8 on the 64 x 128 tile (4 x 8
// elsewhere was no faster in launch/tune_gather.py's sweep).
template <int MODE>
int dispatch_tile(const Call& p, int bm, int bn, int va, int vb) {
  if constexpr (MODE == 0) {
    if (bm == 20 && bn == 32) return dispatch<0, 20, 32, 4>(p, va, vb);
    if (bm == 20 && bn == 64) return dispatch<0, 20, 64, 4>(p, va, vb);
    if (bm == 64 && bn == 32) return dispatch<0, 64, 32, 4>(p, va, vb);
    if (bm == 64 && bn == 64) return dispatch<0, 64, 64, 4>(p, va, vb);
    if (bm == 64 && bn == 128) return dispatch<0, 64, 128, 8>(p, va, vb);
  } else if constexpr (MODE == 1) {
    if (bm == 20 && bn == 16) return dispatch<1, 20, 16, 4>(p, va, vb);
    if (bm == 20 && bn == 32) return dispatch<1, 20, 32, 4>(p, va, vb);
    if (bm == 64 && bn == 16) return dispatch<1, 64, 16, 4>(p, va, vb);
    if (bm == 64 && bn == 32) return dispatch<1, 64, 32, 4>(p, va, vb);
  } else {
    if (bm == 20 && bn == 64) return dispatch<2, 20, 64, 4>(p, va, vb);
    if (bm == 64 && bn == 64) return dispatch<2, 64, 64, 4>(p, va, vb);
  }
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p, int ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 4 == 0;
}

}  // namespace

// plan: 15 ints from the wrapper's _plan, {mode, T, M, C, O, lda, ldb,
// ids_tstride, a_gather, bm, bn, split, csplit, va, vb}. mode: 0 FP, 1 BP,
// 2 COLS (see the header). a: (T, M, lda) rows; b: (rows, ldb); ids: unit
// ids, row t at ids + t * ids_tstride (0: one row for all steps); y:
// (T, M, O). C is the contraction length (k for FP, N for BP, K for COLS)
// and O the output width (N for FP, k otherwise). The grid is
// (ceil(O / bn) * split, ceil(M / bm), T) in clusters of (split, 1, 1);
// cluster rank r sums contraction [r * csplit, min(C, (r + 1) * csplit)).
// Returns cudaErrorInvalidValue for a plan the kernel does not take, else
// the launch's error code.
extern "C" int gather_matmul_f32(const int* plan, const float* a, const float* b,
                                 const int* ids, float* y, float alpha,
                                 void* stream) {
  cudaGetLastError();  // clear any stale error from an earlier call
  const int mode = plan[0], bm = plan[9], bn = plan[10], va = plan[13], vb = plan[14];
  Call p{a, b, ids, y, plan[1], plan[2], plan[3], plan[4], plan[5], plan[6],
         plan[7], plan[8], plan[11], plan[12], alpha, (cudaStream_t)stream};
  if (p.T <= 0 || p.M <= 0 || p.O <= 0) return (int)cudaSuccess;
  const bool bad =
      p.C <= 0 || p.T > 65535 || (p.M + bm - 1) / bm > 65535 ||
      p.split < 1 || p.split > MAX_SPLIT || p.csplit < 1 ||
      (long)(p.split - 1) * p.csplit >= p.C || (long)p.split * p.csplit < p.C ||
      (p.split > 1 && p.csplit % 4 != 0) ||
      (p.a_gather && (mode != 0 || va || vb)) ||
      (va && !aligned16(a, p.lda)) ||
      (vb && (!aligned16(b, p.ldb) || (mode == 0 && p.O % 4 != 0)));
  if (bad) return (int)cudaErrorInvalidValue;
  if (mode == 0) return dispatch_tile<0>(p, bm, bn, va, vb);
  if (mode == 1) return dispatch_tile<1>(p, bm, bn, va, vb);
  if (mode == 2) return dispatch_tile<2>(p, bm, bn, va, vb);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
