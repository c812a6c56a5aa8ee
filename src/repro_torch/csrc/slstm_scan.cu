// Fused persistent-scan sLSTM recurrence on Hopper (sm_90a), float32 or
// bfloat16 xg and R with float32 states and float32 arithmetic.
//
// Replaces the Pallas TPU kernels of repro/kernels/cell_scan.py in their
// sLSTM instance (repro/kernels/slstm_scan.py, SLSTM_CELL), K6:
//   _fwd_kernel via _pallas_fwd  -> slstm_fwd_kernel
//   _bwd_kernel via _pallas_bwd  -> slstm_bwd_kernel (dgates, dh, dc/dn/dm)
//                                   + slstm_wg_kernel (dR, after the scan)
// Forward: gates_t = xg_t + drop(h_{t-1}) @ R per head (R block-diagonal,
// (NH, dh, 4dh), gate order i, f, z, o), then the exponential-gating update
// with the (c, n, m) cell / normalizer / stabilizer carries, for all T steps
// in one launch, saving hs, gates and the c, n, m sequences.
// Backward: reverse time; dgates into dgx, compact BP into dh_{t-1},
// dh0/dc0/dn0/dm0; frozen (ragged) steps give exactly zero dgates and pass
// their cotangents straight through. dR (the weight gradient, WG) does not
// feed the recurrence: a second kernel computes it after the scan from hs
// and dgx, over the kept (step, unit block) pairs only.
// RH dropout over dh, shared across heads: 0 off, 1 structured (a (T|1, k)
// table of kept unit ids; compact gathers, the paper's (1-p) FLOPs),
// 2 dense ((T|1, B, 1|NH, dh) mask). A one-row table is FIXED.
//
// Numerics: built without fast math, so expf, log1pf and the divisions are
// IEEE. The fresh-start stabilizer m0 = -1e30 stays finite: lf + m - m_new
// is then about -1e30 and expf gives exactly 0. log-sigmoid is the stable
// two-branch min(x, 0) - log1p(exp(-|x|)). The backward re-evaluates the
// stabilizer's branch (lf + m_prev >= gi, ties to forget) from the gates and
// m values that the forward stored. Every sum runs in a fixed order (no
// atomics), so a second launch gives the same bits.
//
// bfloat16 (the reference's dtype contract, repro/kernels/cell_scan.py):
// xg and R may be bfloat16, h0 and the states float32. Loads widen to
// float32 and every product and state update stays float32; the gates
// residual and dgx are written in xg's dtype, hs and the state sequences
// in float32, dR in R's dtype. The backward reads the rounded gates
// residual, as the reference's does, and also writes its float32 dgates to
// a second buffer: WG sums dR from those, not from the rounded dgx. The
// scans stage a step's bfloat16 xg or gates columns in shared memory by
// 4-byte cp.async of unit pairs (by plain copies where dh or J is odd); R
// is widened into the same float32 shared-memory tile as in float32.
//
// What bounds it on the H100: the recurrence is serial in T, and one step's
// product is tiny (xlstm-1.3b: B=2 rows x k=384 kept units x 2048 columns
// per head, 4 heads, ~12.6 MFLOP), so the latency of one step, not FLOPs or
// HBM bytes, bounds it: the exchange of a step's values between SMs (one
// L2 round trip, ~1 us a step on the H100 by launch/slstm_scan_bench.py's
// probes) plus the serial work between two exchanges. R is 16.8 MB at
// NH=4, dh=512, which fits no SM. Design: one persistent launch
// (cooperative, for co-residency) in which each CTA owns J units of ONE
// head and their four gate columns; those columns of its head's R (dh x 4J,
// 128 KB at J=16) stay in shared memory for the whole scan, in both
// directions, when they fit, else they are read through L2.
// Heads are independent, so there is no grid-wide barrier: the barrier is
// per head and merged with the data. Each step a CTA publishes its values
// as 64-bit words that carry the value and the step (tag) together, into a
// two-slot ring in global memory, and its readers poll the words they need
// until the tags match: one L2 round trip for barrier and data. A CTA also
// publishes a sentinel word a step once it has read the previous slot, and
// a reader that would not otherwise read a word of every CTA of its head
// polls their sentinels, so a slot is rewritten only after all its readers
// are done with it (dropout lets a CTA skip the words of others). The next
// step's ids row, xg columns and mask row (forward) or residuals
// (backward) are prefetched with cp.async during the step before, so only
// h_{t-1} (forward) or the dh partials (backward) are on the critical path.
// Forward: every CTA polls its head's compact h_{t-1} (B x k words); its
// 256 threads compute the (1-p) product as J unit quads (float4 reads of
// the resident R columns: one unit's i, f, z, o) x a K-split of 16 over the
// kept rows, then one warp sums the split and runs the pointwise update.
// Backward: each CTA computes its own units' dgates, then the partial BP of
// every kept unit of its head from its own 4J columns, one thread a kept
// row (the dgates in registers, R rows at a padded stride so that 32 rows
// read without bank conflicts), and publishes B x k partials; the owner of
// each unit sums its head's CTAs' partials in a fixed order. So each step
// moves B x k words out and B x J x CTAs-per-head words in per CTA, and R
// never leaves shared memory. The loops of a step avoid integer division
// (a multiply-high by reciprocals set once) and are not unrolled beyond
// need: the step's code is fetched anew every step, and its size showed in
// the step time.
// WG: dR[hd, u, :] = sc * sum over (t, b) with u's block kept at t of
// hp[t, b, hd, u] dgx[t, b, hd, :], hp = h_{t-1} (x keep or mask), the
// contraction over a per-block list of active steps built by the wrapper.
// At xlstm-1.3b it is 25.8 GFLOP a call over ~0.2 GB, so operations bound
// it. It runs on the TF32 tensor cores in split precision ("3xTF32",
// csrc/tf32x3.cuh, as K12): three mma.sync.m16n8k8 a product, each chunk of
// 32 pairs summed on the cores from zero and added to the float32 sums by
// an FADD (the contraction is ~3072 pairs long, and the cores truncate as
// they add). Both operands are split with hi rounded to the nearest TF32
// value (split_rn), not truncated as K12 does: the contraction may be as
// short as a few pairs, and each output is held elementwise to float32
// sums (truncating, the kernel sat 3-5x the plain float32 version's
// distance to float64 on small inputs; rounding halves that for 6% of its
// time, and rounding lo as well gained nothing more).
// A CTA of 8 warps owns 64 units x 256 columns (a warp 64 x 32; 64 x 128
// on 4 warps ran 20% slower: it re-read hp twice as often and spent more
// of each thread on copies); hp rows (64 units of a pair), the factor's
// rows and dgx rows (256 columns of a pair) arrive k-outer by 16-byte
// cp.async (4-byte where dh % 4 != 0) in a 3-deep ring, rows padded by 8
// floats so the fragment loads hit 32 banks; a chunk's step ids are read
// while the chunk before it is issued. The keep / mask factor multiplies
// each hp value where its fragment is split, and is staged only where it
// is not 1 everywhere: mode 2, and the unit blocks of mode 1 where an
// active step keeps part of the block (none at xlstm-1.3b, whose RH block
// is the tile's 64 units). (Splitting each staged hp value once into hi
// and lo planes, with a barrier, ran 3% slower than the 8 warps splitting
// it as they read it, and 6% slower pipelined a chunk ahead.) The grid
// walks the unit blocks fastest, so CTAs resident together share their
// dgx columns in L2. Each output is summed by one thread in chunk order:
// no atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "tf32x3.cuh"

namespace {

typedef unsigned long long u64;

constexpr int NT = 256;   // threads per CTA (scan kernels)
constexpr int BT = 2;     // batch rows per register chunk
constexpr int PW = 4;     // words a thread polls at once
constexpr unsigned SPIN_MAX = 1u << 26;   // polls of one word before the launch fails
constexpr int SMAX = 32;  // forward: K-split cap
constexpr int QC = 16;    // backward product: dgates quads held in registers
constexpr int NF = 9;     // backward residual fields a (row, unit)
// WG: a CTA of WT threads owns WU units x WC columns, a warp all WU units
// x WN columns (WMI x WNI m16n8 tiles), and walks chunks of WK (step, row)
// pairs through a WS-deep cp.async ring of hp, factor and dgx rows.
constexpr int WU = 64, WC = 256, WK = 32, WT = 256, WS = 3, WN = 32;
static_assert(WT / 32 * WN == WC && WU == 64, "WG: one warp a column slice; 16 lanes a hp row");
constexpr int WMI = WU / 16, WNI = WN / 8;
constexpr int WRP = WT / 32, WNP = WK / WRP;       // rows a copy pass, passes a chunk
constexpr int WBC = WC / 128;                      // 16-byte dgx copies a lane a row
constexpr int WLA = WU + 8, WLB = WC + 8;          // staged row strides, floats
constexpr int W_STAGE = WK * (2 * WLA + WLB);     // floats: hp, factor, dgx rows
constexpr int W_SMEM = WS * W_STAGE * 4;          // bytes
constexpr size_t SMEM_MAX = 227 * 1024;
constexpr float EPS = 1e-6f;   // normalizer floor

// Built with -DSLSTM_PHASES (launch/slstm_scan_bench.py --phases), the scan
// kernels add the SM cycles thread 0 of each CTA spends in each phase of a
// step to g_phase[direction][CTA][phase]; otherwise the macros are empty.
#ifdef SLSTM_PHASES
__device__ unsigned long long g_phase[2][1024][8];
#define PHASE_START() long long ph_t = clock64()
#define PHASE(dir, i)                                                    \
  if (threadIdx.x == 0) {                                                \
    const long long ph_n = clock64();                                    \
    g_phase[dir][blockIdx.x][i] += (unsigned long long)(ph_n - ph_t);    \
    ph_t = ph_n;                                                         \
  }
#else
#define PHASE_START()
#define PHASE(dir, i)
#endif

struct ScanArgs {
  int T, B, NH, D;   // D = dh, units per head
  int mode;          // 0 off, 1 structured, 2 dense
  int k;             // kept units per ids row (structured)
  int ids_rows;      // 1 (FIXED) or T
  int mask_rows;     // 1 (FIXED) or T
  int mask_heads;    // 1 (shared across heads) or NH
  int ragged;
  int J;             // units per CTA (all of one head)
  int cph;           // CTAs per head
  float scale;
};

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float log_sigm(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ u64 pack(float v, unsigned tag) {
  return ((u64)tag << 32) | __float_as_uint(v);
}

// n / d by a multiply-high, exact for n d < 2^32; the reciprocal is set
// once per kernel, so the per-step index splits cost no division.
struct Div {
  u64 m;
  __device__ explicit Div(int d) : m(d > 0 ? ((1ull << 32) + d - 1) / d : 0) {}
  __device__ __forceinline__ int q(int n) const { return (int)(((u64)(unsigned)n * m) >> 32); }
};

// Ring words go through L2 at GPU scope: a relaxed load never hits a stale
// L1 line, and a 64-bit word is read whole, value and tag together.
__device__ __forceinline__ void st_word(u64* p, u64 w) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ u64 ld_word(const u64* p) {
  u64 w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\n" : "=l"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ size_t mask_at(const ScanArgs& p, int row, int b, int hd, int u) {
  return (((size_t)row * p.B + b) * p.mask_heads + (p.mask_heads == 1 ? 0 : hd)) * p.D + u;
}

// Polls words addr(0..n-1) until each carries tag `want`, then hands each
// value to sink(e, v). PW loads in flight a thread; addr(e) == nullptr
// skips e.
template <class Addr, class Sink>
__device__ __forceinline__ void poll(int n, unsigned want, Addr addr, Sink sink) {
#pragma unroll 1
  for (int e0 = threadIdx.x; e0 < n; e0 += PW * NT) {
    const u64* a[PW];
    u64 w[PW];
#pragma unroll
    for (int u = 0; u < PW; ++u) {
      const int e = e0 + u * NT;
      a[u] = e < n ? addr(e) : nullptr;
      w[u] = a[u] ? ld_word(a[u]) : (u64)want << 32;
    }
#pragma unroll
    for (int u = 0; u < PW; ++u)
      for (unsigned spin = 0; (unsigned)(w[u] >> 32) != want; ++spin) {
        if (spin == SPIN_MAX) __trap();   // a lost word: fail the launch, do not hang
        w[u] = ld_word(a[u]);
      }
#pragma unroll
    for (int u = 0; u < PW; ++u)
      if (a[u]) sink(e0 + u * NT, __uint_as_float((unsigned)w[u]));
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// v[0] + v[stride] + ... + v[(n - 1) stride] as four interleaved chains,
// summed in a fixed order.
__device__ __forceinline__ float4 sum_split(const float4* v, size_t stride, int n) {
  float4 c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  int s = 0;
  for (; s + 4 <= n; s += 4)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = add4(c[i], v[(s + i) * stride]);
  for (; s < n; ++s) c[0] = add4(c[0], v[s * stride]);
  return add4(add4(c[0], c[1]), add4(c[2], c[3]));
}

__device__ __forceinline__ float sum_split(const float* v, size_t stride, int n) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  int s = 0;
  for (; s + 4 <= n; s += 4)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] += v[(s + i) * stride];
  for (; s < n; ++s) c[0] += v[s * stride];
  return (c[0] + c[1]) + (c[2] + c[3]);
}

__device__ __forceinline__ float ld_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld_f(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// One unit's four gate columns (i, f, z, o) of row u of this head's R.
template <class TI>
__device__ __forceinline__ float4 r_quad(const TI* Rh, int u, int D, int col, bool ok) {
  if (!ok) return make_float4(0.f, 0.f, 0.f, 0.f);
  const TI* r = Rh + (size_t)u * 4 * D + col;
  return make_float4(ld_f(r), ld_f(r + D), ld_f(r + 2 * D), ld_f(r + 3 * D));
}

// Rs[u * stride + q]: the quads of the own units q < J, rows u < D.
template <class TI>
__device__ __forceinline__ void fill_rs(float4* Rs, int stride, const TI* Rh, int D, int J,
                                        int j0, int Jc) {
#pragma unroll 1
  for (int e = threadIdx.x; e < D * J; e += NT) {
    const int u = e / J, q = e % J;
    Rs[(size_t)u * stride + q] = r_quad(Rh, u, D, j0 + q, q < Jc);
  }
}

// bfloat16 scans: the own units' four gate columns of one step (xg in the
// forward, the gates residual in the backward; src_t at the step's first
// row) into dst[(b * 4 + g) * JE + q], JE = J rounded up to even. Unit
// pairs go by 4-byte cp.async where `pairs` (dh and J even, src 4-byte
// aligned), the rest by plain copies.
__device__ __forceinline__ void stage_gates(__nv_bfloat16* dst, const __nv_bfloat16* src_t,
                                            int B, int NH, int hd, int D, int j0, int Jc,
                                            int JE, bool pairs) {
  const int np = (Jc + 1) / 2;
#pragma unroll 1
  for (int e = threadIdx.x; e < B * 4 * np; e += NT) {
    const int bg = e / np, pq = e - bg * np, b = bg >> 2, g = bg & 3, q = 2 * pq;
    const __nv_bfloat16* s = src_t + ((size_t)b * NH + hd) * 4 * D + (size_t)g * D + j0 + q;
    __nv_bfloat16* d = dst + (size_t)bg * JE + q;
    if (pairs && q + 1 < Jc) {
      cp4(d, s, true);
    } else {
      d[0] = s[0];
      if (q + 1 < Jc) d[1] = s[1];
    }
  }
}

// The four gate values of unit q, row b, from stage_gates's layout.
__device__ __forceinline__ float4 staged_quad(const __nv_bfloat16* gs, int b, int q, int JE) {
  const __nv_bfloat16* p = gs + (size_t)b * 4 * JE + q;
  return make_float4(to_f(p[0]), to_f(p[JE]), to_f(p[2 * JE]), to_f(p[3 * JE]));
}

// RES: the CTA's R columns (D x 4J) stay resident in shared memory. TI:
// the dtype of xg, R and the gates residual.
template <class TI, bool RES>
__global__ void __launch_bounds__(NT, 1)
slstm_fwd_kernel(const TI* __restrict__ gx, const TI* __restrict__ R,
                 const float* __restrict__ h0, const float* __restrict__ c0,
                 const float* __restrict__ n0, const float* __restrict__ m0,
                 const int* __restrict__ ids, const float* __restrict__ mask,
                 const int* __restrict__ lens, float* hs, TI* gates, float* cs,
                 float* ns, float* ms, u64* ring, ScanArgs p) {
  constexpr bool BF = std::is_same<TI, __nv_bfloat16>::value;
  extern __shared__ float4 smem4[];
  const int T = p.T, B = p.B, NH = p.NH, D = p.D, G = 4 * D, J = p.J, cph = p.cph;
  const int hd = blockIdx.x / cph, me = blockIdx.x % cph;
  const int j0 = me * J, Jc = min(J, D - j0);
  const int KC = p.mode == 1 ? p.k : D;
  const int S = min(NT / J, SMAX);
  const int Bp = (B + BT - 1) / BT * BT;
  const int BJ = B * J, JE = J + (J & 1);
  const TI* Rh = R + (size_t)hd * D * G;
  const Div dJ(J), dJc(Jc), d4Jc(4 * Jc), dKC(KC), dD(D);
  float4* Rs = smem4;                                  // RES: D x J unit quads
  float4* part = Rs + (RES ? (size_t)D * J : 0);       // S x BT x J partial sums
  float4* gxb = part + (size_t)S * BT * J;             // 2 x B x J: xg of a step
  // bfloat16: 2 x B x 4 x JE staged xg values (stage_gates) in its place
  __nv_bfloat16* gsb = reinterpret_cast<__nv_bfloat16*>(gxb);
  const bool pairs = BF && D % 2 == 0 && J % 2 == 0 && ((uintptr_t)gx & 3) == 0;
  float* hsm = reinterpret_cast<float*>(gxb + (BF ? (size_t)B * JE : 2 * (size_t)BJ));  // Bp x KC h_{t-1}
  float* mkb = hsm + (size_t)Bp * KC;                  // mode 2: 2 x B x D mask rows
  float* hc = mkb + (p.mode == 2 ? 2 * (size_t)B * D : 0);  // B x J carries
  float* cc = hc + BJ;
  float* nc = cc + BJ;
  float* mc = nc + BJ;
  int* uidb = reinterpret_cast<int*>(mc + BJ);         // mode 1: 2 x KC unit ids
  int* lns = uidb + (p.mode == 1 ? 2 * KC : 0);        // ragged: B lengths
  const int tid = threadIdx.x;
  const size_t slot_words = (size_t)B * NH * D;
  u64* sent = ring + 2 * slot_words;                   // 2 x NH x cph sentinels

#pragma unroll 1
  for (int e = tid; e < BJ; e += NT) {
    const int b = e / J, q = e % J;
    if (q >= Jc) continue;
    const size_t o = ((size_t)b * NH + hd) * D + j0 + q;
    hc[e] = h0[o];
    cc[e] = c0[o];
    nc[e] = n0[o];
    mc[e] = m0[o];
  }
  if (RES) fill_rs(Rs, J, Rh, D, J, j0, Jc);
#pragma unroll 1
  for (int e = tid; e < (Bp - B) * KC; e += NT) hsm[(size_t)B * KC + e] = 0.f;
  if (p.ragged)
#pragma unroll 1
    for (int b = tid; b < B; b += NT) lns[b] = lens[b];

  // step t's ids row, xg columns of the own units and mask row, into buffer t & 1
  auto prefetch = [&](int t) {
    const int buf = t & 1;
    if (p.mode == 1) {
      const int* src = ids + (size_t)(p.ids_rows == 1 ? 0 : t) * p.k;
#pragma unroll 1
      for (int kk = tid; kk < KC; kk += NT) cp4(uidb + buf * KC + kk, src + kk, true);
    }
    if constexpr (BF) {
      stage_gates(gsb + (size_t)buf * 4 * B * JE, gx + (size_t)t * B * NH * G, B, NH, hd, D,
                  j0, Jc, JE, pairs);
    } else {
      float* gdst = reinterpret_cast<float*>(gxb + (size_t)buf * BJ);
#pragma unroll 1
      for (int e = tid; e < B * 4 * Jc; e += NT) {
        const int b = d4Jc.q(e), r = e - b * 4 * Jc, g = dJc.q(r), q = r - g * Jc;
        cp4(gdst + ((size_t)b * J + q) * 4 + g,
            gx + (((size_t)t * B + b) * NH + hd) * G + (size_t)g * D + j0 + q, true);
      }
    }
    if (p.mode == 2) {
      const int row = p.mask_rows == 1 ? 0 : t;
      float* mdst = mkb + (size_t)buf * B * D;
#pragma unroll 1
      for (int e = tid; e < B * D; e += NT) {
        const int b = dD.q(e);
        cp4(mdst + e, mask + mask_at(p, row, b, hd, e - b * D), true);
      }
    }
    cp_commit();
  };
  prefetch(0);

  const int wq = tid % J, ws = tid / J;   // product: unit quad, K-slice
  const float sc = p.mode == 1 ? p.scale : 1.f;
  PHASE_START();
  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    cp_wait<0>();
    __syncthreads();
    PHASE(0, 0);
    if (t + 1 < T) prefetch(t + 1);
    const int* uid = uidb + buf * KC;
    const float* mk = mkb + (size_t)buf * B * D;
    auto stage = [&](int e, float v) {
      if (p.mode == 2) {
        const int b = dKC.q(e);
        v *= mk[(size_t)b * D + e - b * KC] * p.scale;
      }
      hsm[e] = v;
    };
    // this head's compact h_{t-1}
    if (t == 0) {
#pragma unroll 1
      for (int e = tid; e < B * KC; e += NT) {
        const int b = dKC.q(e), kk = e - b * KC;
        stage(e, h0[((size_t)b * NH + hd) * D + (p.mode == 1 ? uid[kk] : kk)]);
      }
    } else {
      const u64* slot = ring + (size_t)((t - 1) & 1) * slot_words;
      const u64* snt = sent + ((size_t)((t - 1) & 1) * NH + hd) * cph;
      poll(B * KC + cph, (unsigned)t,
           [&](int e) -> const u64* {
             if (e >= B * KC) return snt + (e - B * KC);
             const int b = dKC.q(e), kk = e - b * KC;
             return slot + ((size_t)b * NH + hd) * D + (p.mode == 1 ? uid[kk] : kk);
           },
           [&](int e, float v) {
             if (e < B * KC) stage(e, v);
           });
    }
    __syncthreads();
    PHASE(0, 1);
    // done with slot (t-1) & 1: it may be rewritten at step t + 1
    if (tid == 0) st_word(sent + ((size_t)buf * NH + hd) * cph + me, pack(0.f, t + 1));

    for (int b0 = 0; b0 < B; b0 += BT) {
      if (ws < S) {
        float4 acc[BT];
#pragma unroll
        for (int bb = 0; bb < BT; ++bb) acc[bb] = make_float4(0.f, 0.f, 0.f, 0.f);
        const float* h = hsm + (size_t)b0 * KC;
#pragma unroll 4
        for (int kk = ws; kk < KC; kk += S) {
          const int u = p.mode == 1 ? uid[kk] : kk;
          const float4 r = RES ? Rs[(size_t)u * J + wq] : r_quad(Rh, u, D, j0 + wq, wq < Jc);
#pragma unroll
          for (int bb = 0; bb < BT; ++bb) {
            const float hv = h[(size_t)bb * KC + kk];
            acc[bb].x = fmaf(hv, r.x, acc[bb].x);
            acc[bb].y = fmaf(hv, r.y, acc[bb].y);
            acc[bb].z = fmaf(hv, r.z, acc[bb].z);
            acc[bb].w = fmaf(hv, r.w, acc[bb].w);
          }
        }
#pragma unroll
        for (int bb = 0; bb < BT; ++bb) part[((size_t)ws * BT + bb) * J + wq] = acc[bb];
      }
      __syncthreads();
      PHASE(0, 2);
#pragma unroll 1
      for (int e = tid; e < BT * J; e += NT) {
        const int bb = dJ.q(e), q = e - bb * J, b = b0 + bb;
        if (b >= B || q >= Jc) continue;
        const float4 sum = sum_split(part + (size_t)bb * J + q, (size_t)BT * J, S);
        PHASE(0, 3);
        float4 xg;
        if constexpr (BF) xg = staged_quad(gsb + (size_t)buf * 4 * B * JE, b, q, JE);
        else xg = gxb[(size_t)buf * BJ + b * J + q];
        const float gv[4] = {xg.x + sum.x * sc, xg.y + sum.y * sc, xg.z + sum.z * sc,
                             xg.w + sum.w * sc};
        const int o = b * J + q;
        const float c_prev = cc[o], n_prev = nc[o], m_prev = mc[o];
        float h_new, c_new, n_new, m_new;
        if (p.ragged && t >= lns[b]) {        // frozen row: carry t-1 through
          h_new = hc[o];
          c_new = c_prev;
          n_new = n_prev;
          m_new = m_prev;
        } else {
          const float lfm = log_sigm(gv[1]) + m_prev;
          m_new = fmaxf(lfm, gv[0]);          // stabilizer
          const float ig = expf(gv[0] - m_new);
          const float fg = expf(lfm - m_new);
          const float z = tanhf(gv[2]);
          const float og = sigm(gv[3]);
          c_new = fg * c_prev + ig * z;
          n_new = fg * n_prev + ig;
          h_new = og * (c_new / fmaxf(n_new, EPS));
        }
        PHASE(0, 4);
        hc[o] = h_new;
        cc[o] = c_new;
        nc[o] = n_new;
        mc[o] = m_new;
        const size_t row = ((size_t)t * B + b) * NH + hd;
        st_word(ring + (size_t)buf * slot_words + ((size_t)b * NH + hd) * D + j0 + q,
                pack(h_new, t + 1));
        const size_t hofs = row * D + j0 + q, gofs = row * G + j0 + q;
        hs[hofs] = h_new;
        cs[hofs] = c_new;
        ns[hofs] = n_new;
        ms[hofs] = m_new;
#pragma unroll
        for (int g2 = 0; g2 < 4; ++g2) put(gates + gofs + (size_t)g2 * D, gv[g2]);
        PHASE(0, 5);
      }
      if (b0 + BT < B) __syncthreads();
    }
    PHASE(0, 6);
  }
}

// Backward. TI: the dtype of the gates residual, R and dgx; with bfloat16,
// dg32 receives the float32 dgates for WG.
template <class TI, bool RES>
__global__ void __launch_bounds__(NT, 1)
slstm_bwd_kernel(const float* __restrict__ dy, const float* __restrict__ dcT,
                 const float* __restrict__ dnT, const float* __restrict__ dmT,
                 const TI* __restrict__ gates, const float* __restrict__ cs,
                 const float* __restrict__ ns, const float* __restrict__ ms,
                 const float* __restrict__ c0, const float* __restrict__ n0,
                 const float* __restrict__ m0, const TI* __restrict__ R,
                 const int* __restrict__ ids, const float* __restrict__ mask,
                 const int* __restrict__ lens, TI* dgx, float* dg32, float* dh0, float* dc0,
                 float* dn0, float* dm0, u64* ring, ScanArgs p) {
  constexpr bool BF = std::is_same<TI, __nv_bfloat16>::value;
  extern __shared__ float4 smem4[];
  const int T = p.T, B = p.B, NH = p.NH, D = p.D, G = 4 * D, J = p.J, cph = p.cph;
  const int hd = blockIdx.x / cph, me = blockIdx.x % cph;
  const int j0 = me * J, Jc = min(J, D - j0);
  const int KC = p.mode == 1 ? p.k : D;
  const int Bp = (B + BT - 1) / BT * BT;
  const int BJ = B * J, JE = J + (J & 1);
  const TI* Rh = R + (size_t)hd * D * G;
  const Div dJ(J), dJc(Jc), dBJc(B * Jc), dcph(cph);
  const int JP = J + 1;   // row stride of Rs: 32 consecutive rows hit distinct banks
  float4* Rs = smem4;                                  // RES: D x JP unit quads
  float4* dgs = Rs + (RES ? (size_t)D * JP : 0);       // Bp x J: own dgates quads
  // bfloat16: 2 x B x 4 x JE staged gates (stage_gates); resb's fields 0-3 unused
  __nv_bfloat16* gsb = reinterpret_cast<__nv_bfloat16*>(dgs + (size_t)Bp * J);
  const bool pairs = BF && D % 2 == 0 && J % 2 == 0 && ((uintptr_t)gates & 3) == 0;
  float* resb = reinterpret_cast<float*>(dgs + (size_t)Bp * J + (BF ? (size_t)B * JE : 0));  // 2 x NF x B x J
  float* psum = resb + 2 * NF * (size_t)BJ;            // B x cph x J polled partials
  float* cn = psum + (size_t)B * cph * J;              // B x J: c, n, m at step r
  float* nn = cn + BJ;
  float* mn = nn + BJ;
  float* dhc = mn + BJ;                                // B x J carries
  float* dcc = dhc + BJ;
  float* dnc = dcc + BJ;
  float* dmc = dnc + BJ;
  int* uidb = reinterpret_cast<int*>(dmc + BJ);        // mode 1: 2 x KC unit ids
  int* flg = uidb + (p.mode == 1 ? 2 * KC : 0);        // mode 1: 2 x J: row an own unit was kept
  int* lns = flg + (p.mode == 1 ? 2 * J : 0);          // ragged: B lengths
  const int tid = threadIdx.x;
  const size_t step_h = (size_t)B * NH * D;
  const size_t slot_words = (size_t)B * NH * cph * D;
  u64* sent = ring + 2 * slot_words;                   // 2 x NH x cph sentinels
  const float sc = p.mode == 1 ? p.scale : 1.f;

  if (RES) fill_rs(Rs, JP, Rh, D, J, j0, Jc);
#pragma unroll 1
  for (int e = tid; e < Bp * J; e += NT) dgs[e] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
  for (int e = tid; e < BJ; e += NT) {
    const int b = e / J, q = e % J;
    const size_t o = ((size_t)b * NH + hd) * D + j0 + q;
    const size_t oT = (size_t)(T - 1) * step_h + o;
    const bool ok = q < Jc;
    dhc[e] = 0.f;
    dcc[e] = ok ? dcT[o] : 0.f;
    dnc[e] = ok ? dnT[o] : 0.f;
    dmc[e] = ok ? dmT[o] : 0.f;
    cn[e] = ok ? cs[oT] : 0.f;
    nn[e] = ok ? ns[oT] : 0.f;
    mn[e] = ok ? ms[oT] : 0.f;
  }
  if (p.mode == 1)
#pragma unroll 1
    for (int e = tid; e < 2 * J; e += NT) flg[e] = -1;
  if (p.ragged)
#pragma unroll 1
    for (int b = tid; b < B; b += NT) lns[b] = lens[b];

  // step r's ids row and residuals of the own units (gates, dy, the states
  // of r - 1, the mask of row r + 1), into buffer r & 1
  auto prefetch = [&](int r) {
    const int buf = r & 1;
    if (p.mode == 1) {
      const int* src = ids + (size_t)(p.ids_rows == 1 ? 0 : r) * p.k;
#pragma unroll 1
      for (int kk = tid; kk < KC; kk += NT) cp4(uidb + buf * KC + kk, src + kk, true);
    }
    float* dst = resb + (size_t)buf * NF * BJ;
    const int nf = p.mode == 2 && r + 1 < T ? NF : NF - 1;
    const int f0 = BF ? 4 : 0;                 // bfloat16: the gates go to gsb
    if constexpr (BF)
      stage_gates(gsb + (size_t)buf * 4 * B * JE, gates + (size_t)r * B * NH * G, B, NH, hd, D,
                  j0, Jc, JE, pairs);
#pragma unroll 1
    for (int e = f0 * B * Jc + tid; e < nf * B * Jc; e += NT) {
      const int f = dBJc.q(e), bq = e - f * B * Jc, b = dJc.q(bq), q = bq - b * Jc;
      const size_t row = ((size_t)r * B + b) * NH + hd;
      const size_t h = row * D + j0 + q;
      const size_t h0o = ((size_t)b * NH + hd) * D + j0 + q;
      const void* src;
      if (f < 4) src = gates + row * G + (size_t)f * D + j0 + q;   // float32 only
      else if (f == 4) src = dy + h;
      else if (f < 8) {
        const float* seq = f == 5 ? cs : f == 6 ? ns : ms;
        const float* s0 = f == 5 ? c0 : f == 6 ? n0 : m0;
        src = r > 0 ? seq + h - step_h : s0 + h0o;
      } else {
        src = mask + mask_at(p, p.mask_rows == 1 ? 0 : r + 1, b, hd, j0 + q);
      }
      cp4(dst + (size_t)f * BJ + b * J + q, src, true);
    }
    cp_commit();
  };
  prefetch(T - 1);

  // the partials of step r (dh_{r-1} of the own units) from every CTA of the
  // head; the sentinels too when no own unit was kept at r (else the words
  // of every CTA are read already)
  auto poll_partials = [&](int r, bool kept) {
    const int buf = r & 1;
    const u64* slot = ring + (size_t)buf * slot_words;
    const u64* snt = sent + ((size_t)buf * NH + hd) * cph;
    const int n = B * cph * J;
    poll(n + (kept ? 0 : cph), (unsigned)(r + 1),
         [&](int e) -> const u64* {
           if (e >= n) return snt + (e - n);
           const int bx = dJ.q(e), q = e - bx * J, b = dcph.q(bx), x = bx - b * cph;
           if (q >= Jc || (p.mode == 1 && flg[buf * J + q] != r)) return nullptr;
           return slot + (((size_t)b * NH + hd) * cph + x) * D + j0 + q;
         },
         [&](int e, float v) {
           if (e < n) psum[e] = v;
         });
  };
  // their sum for own unit (b, q), scaled (mask row `mrow` value mv for mode 2)
  auto incoming = [&](int r, int b, int q, float mv) {
    if (p.mode == 1 && flg[(r & 1) * J + q] != r) return 0.f;
    const float v = sum_split(psum + (size_t)b * cph * J + q, (size_t)J, cph);
    return v * (p.mode == 2 ? mv * p.scale : sc);
  };

  PHASE_START();
  // whether an own unit was kept at row r (its flags set at step r)
  auto own_kept = [&](int r) {
    return p.mode != 1 || (tid < Jc && flg[(r & 1) * J + tid] == r);
  };
  for (int r = T - 1; r >= 0; --r) {
    const int buf = r & 1;
    cp_wait<0>();
    const bool kept = __syncthreads_or(r + 1 < T && own_kept(r + 1));
    PHASE(1, 0);
    if (r > 0) prefetch(r - 1);
    const int* uid = uidb + buf * KC;
    if (p.mode == 1)
#pragma unroll 1
      for (int kk = tid; kk < KC; kk += NT) {
        const int u = uid[kk];
        if (u >= j0 && u < j0 + Jc) flg[buf * J + u - j0] = r;
      }
    if (r + 1 < T) poll_partials(r + 1, kept);
    __syncthreads();
    PHASE(1, 1);
    // done with slot (r + 1) & 1: it may be rewritten at step r - 1
    if (tid == 0) st_word(sent + ((size_t)buf * NH + hd) * cph + me, pack(0.f, r + 1));

    // phase 1: dgates of the own units (pointwise reverse)
    const float* rs = resb + (size_t)buf * NF * BJ;
#pragma unroll 1
    for (int e = tid; e < B * Jc; e += NT) {
      const int b = dJc.q(e), q = e - b * Jc, o = b * J + q;
      const float inc = r + 1 < T ? incoming(r + 1, b, q, rs[8 * BJ + o]) : 0.f;
      const float dh = rs[4 * BJ + o] + dhc[o] + inc;
      PHASE(1, 2);
      const float c_prev = rs[5 * BJ + o], n_prev = rs[6 * BJ + o], m_prev = rs[7 * BJ + o];
      float4 dg = make_float4(0.f, 0.f, 0.f, 0.f);
      if (!p.ragged || r < lns[b]) {
        float4 gq;
        if constexpr (BF) gq = staged_quad(gsb + (size_t)buf * 4 * B * JE, b, q, JE);
        else gq = make_float4(rs[o], rs[BJ + o], rs[2 * BJ + o], rs[3 * BJ + o]);
        const float gi = gq.x, gf = gq.y, gz = gq.z, go = gq.w;
        const float cnv = cn[o], nnv = nn[o], mnv = mn[o];
        const float lfm = log_sigm(gf) + m_prev;
        const float ig = expf(gi - mnv);
        const float fg = expf(lfm - mnv);
        const float z = tanhf(gz);
        const float og = sigm(go);
        const float inv = 1.f / fmaxf(nnv, EPS);
        const float do_ = dh * cnv * inv;
        const float dc_t = dcc[o] + dh * og * inv;
        const float dn_t = dnc[o] - (nnv > EPS ? dh * og * cnv * inv * inv : 0.f);
        const float df = dc_t * c_prev + dn_t * n_prev;
        const float di = dc_t * z + dn_t;
        const float dz = dc_t * ig;
        const float dm_t = dmc[o] - di * ig - df * fg;
        const bool sel = lfm >= gi;           // ties to the forget branch
        const float dlf = df * fg + (sel ? dm_t : 0.f);
        dg = make_float4(di * ig + (sel ? 0.f : dm_t), dlf * sigm(-gf), dz * (1.f - z * z),
                         do_ * og * (1.f - og));
        dcc[o] = dc_t * fg;
        dnc[o] = dn_t * fg;
        dmc[o] = dlf;
        dhc[o] = 0.f;
      } else {                                // frozen: zero dgates, pass through
        dhc[o] = dh;
      }
      PHASE(1, 3);
      const size_t gofs = (((size_t)r * B + b) * NH + hd) * G + j0 + q;
      put(dgx + gofs, dg.x);
      put(dgx + gofs + D, dg.y);
      put(dgx + gofs + 2 * (size_t)D, dg.z);
      put(dgx + gofs + 3 * (size_t)D, dg.w);
      if constexpr (BF) {
        dg32[gofs] = dg.x;
        dg32[gofs + D] = dg.y;
        dg32[gofs + 2 * (size_t)D] = dg.z;
        dg32[gofs + 3 * (size_t)D] = dg.w;
      }
      dgs[o] = dg;
      cn[o] = c_prev;
      nn[o] = n_prev;
      mn[o] = m_prev;
    }
    __syncthreads();
    PHASE(1, 4);

    // phase 2: partial dh_{r-1}[b, u] = sum over the own 4J columns of
    // dgates[b, c] R[u, c] for every kept u of the head: one thread a row,
    // the dgates quads in registers QC at a time, four FMA chains a row
    u64* out = ring + (size_t)buf * slot_words;
    for (int b0 = 0; b0 < B; b0 += BT) {
      float4 dr[QC][BT];
      const bool one = J <= QC;            // all quads in registers, loaded once
      for (int kk0 = 0; kk0 < KC; kk0 += NT) {
        if (kk0 + (tid & ~31) >= KC) break;   // the warp's rows are all past KC
        // no branch: a row past KC reads row KC - 1 and is not published,
        // a quad past J reads quad J - 1 against a zero dgates quad
        const int kk = min(kk0 + tid, KC - 1);
        const int u = p.mode == 1 ? uid[kk] : kk;
        float a[BT][4];
#pragma unroll
        for (int bb = 0; bb < BT; ++bb) a[bb][0] = a[bb][1] = a[bb][2] = a[bb][3] = 0.f;
        for (int c0 = 0; c0 < J; c0 += QC) {
          if (!one || kk0 == 0)
#pragma unroll
            for (int m = 0; m < QC; ++m)
#pragma unroll
              for (int bb = 0; bb < BT; ++bb)
                dr[m][bb] = c0 + m < J ? dgs[(size_t)(b0 + bb) * J + c0 + m]
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int m = 0; m < QC; ++m) {
            const int qd = min(c0 + m, J - 1);
            const float4 w = RES ? Rs[(size_t)u * JP + qd] : r_quad(Rh, u, D, j0 + qd, qd < Jc);
#pragma unroll
            for (int bb = 0; bb < BT; ++bb) {
              const float4 d = dr[m][bb];
              a[bb][m % 4] = fmaf(d.x, w.x, fmaf(d.y, w.y, fmaf(d.z, w.z, fmaf(d.w, w.w, a[bb][m % 4]))));
            }
          }
        }
        PHASE(1, 5);
        if (kk0 + tid < KC)
#pragma unroll
          for (int bb = 0; bb < BT; ++bb)
            if (b0 + bb < B)
              st_word(out + (((size_t)(b0 + bb) * NH + hd) * cph + me) * D + u,
                      pack((a[bb][0] + a[bb][1]) + (a[bb][2] + a[bb][3]), r + 1));
        PHASE(1, 6);
      }
    }
    PHASE(1, 7);
  }

  // dh0: the partials of step 0
  poll_partials(0, __syncthreads_or(own_kept(0)));
  __syncthreads();
#pragma unroll 1
  for (int e = tid; e < B * Jc; e += NT) {
    const int b = e / Jc, q = e % Jc, o = b * J + q;
    const size_t o0 = ((size_t)b * NH + hd) * D + j0 + q;
    const float mv = p.mode == 2 ? mask[mask_at(p, 0, b, hd, j0 + q)] : 0.f;
    dh0[o0] = dhc[o] + incoming(0, b, q, mv);
    dc0[o0] = dcc[o];
    dn0[o0] = dnc[o];
    dm0[o0] = dmc[o];
  }
}

// WG: dR[hd, u, c] for u in unit block `blk` (WU rows), c in column tile
// `ct` (WC columns) of head `hd`, over the block's active steps
// steps[blk, :nsteps[blk]] x the B rows: a GEMM whose A[k][u] is hp of pair
// k and B[k][c] dgx of pair k, both staged k-outer (a pair's row of WU
// units, a pair's row of WC columns). The factor (the keep table in mode 1
// where partial[blk] says an active step keeps part of the block, the mask
// in mode 2) is staged beside hp and applied to each A value where it is
// split; the scale multiplies the sums at the end. dgx is float32 (the
// backward's dg32 for bfloat16 inputs); TO is dR's dtype.
template <class TO, bool VEC>
__global__ void __launch_bounds__(WT, 1)
slstm_wg_kernel(const float* __restrict__ hs, const float* __restrict__ h0,
                const float* __restrict__ dgx, const int* __restrict__ steps,
                const int* __restrict__ nsteps, const int* __restrict__ partial,
                const float* __restrict__ keep, const float* __restrict__ mask,
                TO* __restrict__ dR, ScanArgs p, int nblk, int ncol) {
  extern __shared__ __align__(16) float wsm[];
  const int T = p.T, B = p.B, NH = p.NH, D = p.D, G = 4 * D;
  // the unit block fastest, then the column tile, then the head: the CTAs
  // resident together read the same dgx columns
  const int blk = blockIdx.x % nblk, ct = blockIdx.x / nblk % ncol;
  const int hd = blockIdx.x / (nblk * ncol);
  const int u0 = blk * WU, c0 = ct * WC;
  const int n = nsteps[blk] * B;            // (step, row) pairs
  const int nk = (n + WK - 1) / WK;         // chunks
  const int* st = steps + (size_t)blk * T;
  const bool fac = p.mode == 2 || (p.mode == 1 && partial[blk]);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;    // mma fragment coordinates
  const int wn = warp * WN;
  const Div dB(B);

  // Copy slots: rows tid / 32 + WRP i (i < WNP) of a chunk; lane l copies
  // dgx columns 4 l + 128 x .. (x < WBC) and, l < 16, hp units 4 l .., else
  // the factor's units 4 (l - 16) ... The step ids of a chunk are read
  // while the chunk before it is issued.
  int sid[WNP];
  auto ids_of = [&](int c) {
#pragma unroll
    for (int i = 0; i < WNP; ++i) {
      const int pr = c * WK + (tid >> 5) + WRP * i;
      sid[i] = pr < n ? st[dB.q(pr)] : -1;
    }
  };
  auto issue = [&](int c) {
    float* As = wsm + (c % WS) * W_STAGE;
    float* Fs = As + WK * WLA;
    float* Bs = Fs + WK * WLA;
    const bool is_f = lane >= 16;
    const int uq = u0 + 4 * (lane & 15);
#pragma unroll
    for (int i = 0; i < WNP; ++i) {
      const int r = (tid >> 5) + WRP * i, pr = c * WK + r, ts = sid[i];
      const bool live = ts >= 0;
      const int b = live ? pr - dB.q(pr) * B : 0;
      const float* brow = live ? dgx + (((size_t)ts * B + b) * NH + hd) * G : dgx;
      const float* row = hs;
      if (live) {
        if (!is_f)
          row = ts == 0 ? h0 + ((size_t)b * NH + hd) * D
                        : hs + (((size_t)(ts - 1) * B + b) * NH + hd) * D;
        else if (p.mode == 1)
          row = keep + (size_t)(p.ids_rows == 1 ? 0 : ts) * D;
        else if (p.mode == 2)
          row = mask + mask_at(p, p.mask_rows == 1 ? 0 : ts, b, hd, 0);
      }
      float* adst = (is_f ? Fs : As) + r * WLA + 4 * (lane & 15);
      const bool want = !is_f || fac;
#pragma unroll
      for (int x = 0; x < WBC; ++x) {
        const int col = 4 * lane + 128 * x;
        const bool bok = live && c0 + col < G;
        if constexpr (VEC) {
          cp16(Bs + r * WLB + col, bok ? brow + c0 + col : dgx, bok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            cp4(Bs + r * WLB + col + e, bok ? brow + c0 + col + e : dgx, bok);
        }
      }
      if (want) {
        if constexpr (VEC) {
          const bool ok = live && uq < D;
          cp16(adst, ok ? row + uq : hs, ok);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = live && uq + e < D;
            cp4(adst + e, ok ? row + uq + e : hs, ok);
          }
        }
      }
    }
    ids_of(c + 1);
  };

  // acc: the float32 sums; part: one chunk's products, summed on the tensor
  // cores from zero, then added to acc by a round-to-nearest FADD
  float acc[WMI][WNI][4], part[WMI][WNI][4];
#pragma unroll
  for (int i = 0; i < WMI; ++i)
#pragma unroll
    for (int j = 0; j < WNI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = part[i][j][q] = 0.f;

  // one chunk's products: A element (k, u) of m-tile i at As[k][16 i + u],
  // x the factor Fs[k][...] when FAC, rows of WLA = WU + 8 floats (bank 8 t
  // + g: conflict-free); B at Bs[k][wn + 8 j + c], rows of WLB = WC + 8;
  // both split (split_rn) as they are read
  auto chunk = [&](const float* As, auto fac_c) {
    constexpr bool FAC = decltype(fac_c)::value;
    const float* Fs = As + WK * WLA;
    const float* Bs = Fs + WK * WLA;
#pragma unroll
    for (int kk = 0; kk < WK; kk += 8) {
      uint32_t ah[WMI][4], al[WMI][4], bh[WNI][2], bl[WNI][2];
#pragma unroll
      for (int i = 0; i < WMI; ++i) {
        const int off = (kk + t) * WLA + 16 * i + g;
        const int o[4] = {off, off + 8, off + 4 * WLA, off + 4 * WLA + 8};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float v = As[o[q]];
          if constexpr (FAC) v *= Fs[o[q]];
          split_rn(v, ah[i][q], al[i][q]);
        }
      }
#pragma unroll
      for (int j = 0; j < WNI; ++j) {
        const float* bp = Bs + (kk + t) * WLB + wn + 8 * j + g;
        split_rn(bp[0], bh[j][0], bl[j][0]);
        split_rn(bp[4 * WLB], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int e = 0; e < 3 * WMI * WNI; ++e) {
        const int q = e / (WMI * WNI), i = e % (WMI * WNI) / WNI, j = e % WNI;
        mma(part[i][j], q == 0 ? al[i] : ah[i], q == 1 ? bl[j] : bh[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < WMI; ++i)
#pragma unroll
      for (int j = 0; j < WNI; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][j][q] += part[i][j][q];
          part[i][j][q] = 0.f;
        }
  };

  ids_of(0);
#pragma unroll
  for (int s = 0; s < WS - 1; ++s) {
    if (s < nk) issue(s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<WS - 2>();
    __syncthreads();               // chunk kt landed; chunk kt - 1's stage is free
    if (kt + WS - 1 < nk) issue(kt + WS - 1);
    cp_commit();
    const float* As = wsm + (kt % WS) * W_STAGE;
    if (fac) chunk(As, std::true_type());
    else chunk(As, std::false_type());
  }
  cp_wait<0>();

  // accumulator q of tile (i, j): unit u0 + 16 i + g + 8 (q / 2), column
  // c0 + wn + 8 j + 2 t + q % 2
  const float sc = p.mode == 0 ? 1.f : p.scale;
#pragma unroll
  for (int i = 0; i < WMI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = u0 + 16 * i + g + 8 * h;
      if (u >= D) continue;
      TO* out = dR + ((size_t)hd * D + u) * G;
#pragma unroll
      for (int j = 0; j < WNI; ++j) {
        const int c = c0 + wn + 8 * j + 2 * t;
        if (c < G) store2(out + c, acc[i][j][2 * h] * sc, acc[i][j][2 * h + 1] * sc);
      }
    }
}

size_t fwd_smem(const ScanArgs& p, bool res, bool bf) {
  const size_t KC = p.mode == 1 ? p.k : p.D, J = p.J, B = p.B, JE = J + (J & 1);
  const size_t S = std::min(NT / p.J, SMAX), Bp = (B + BT - 1) / BT * BT;
  return 16 * ((res ? (size_t)p.D * J : 0) + S * BT * J + (bf ? B * JE : 2 * B * J)) +
         4 * (Bp * KC + (p.mode == 2 ? 2 * B * p.D : 0) + 4 * B * J) +
         4 * ((p.mode == 1 ? 2 * KC : 0) + B);
}

size_t bwd_smem(const ScanArgs& p, bool res, bool bf) {
  const size_t KC = p.mode == 1 ? p.k : p.D, J = p.J, B = p.B, JE = J + (J & 1);
  const size_t Bp = (B + BT - 1) / BT * BT;
  return 16 * ((res ? (size_t)p.D * (J + 1) : 0) + Bp * J + (bf ? B * JE : 0)) +
         4 * (2 * NF * B * J + B * p.cph * J + 7 * B * J) +
         4 * ((p.mode == 1 ? 2 * KC + 2 * J : 0) + B);
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Sets the kernel's shared memory and checks that the grid of p->NH x
// p->cph CTAs is co-resident; returns a CUDA error code (0 = launchable).
int check_launch(const ScanArgs& p, const void* kernel, size_t smem) {
  int dev = 0, coop = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sm_count() < p.NH * p.cph) return (int)cudaErrorCooperativeLaunchTooLarge;
  return 0;
}

// The fewest units per CTA, J >= ceil(NH dh / SMs), for which one CTA per
// (head, slice of J units) fits on the card, one CTA per SM.
void set_units(ScanArgs* p) {
  const int sms = sm_count();
  p->J = (p->NH * p->D + sms - 1) / sms;
  for (;;) {
    p->cph = (p->D + p->J - 1) / p->J;
    if (p->NH * p->cph <= sms || p->J >= p->D) break;
    ++p->J;
  }
}

ScanArgs scan_args(int T, int B, int NH, int D, int mode, int k, int ids_rows, int mask_rows,
                   int mask_heads, int ragged, float scale) {
  ScanArgs p{T, B, NH, D, mode, k, ids_rows, mask_rows, mask_heads, ragged, 0, 0, scale};
  set_units(&p);
  return p;
}

int launch(const ScanArgs& p, const void* kernel, size_t smem, void** args, void* stream) {
  int code = check_launch(p, kernel, smem);
  if (code) return code;
  cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(p.NH * p.cph), dim3(NT), args,
                                                smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class TI>
int scan_fwd(const TI* gx, const TI* R, const float* h0, const float* c0, const float* n0,
             const float* m0, const int* ids, const float* mask, const int* lens, float* hs,
             TI* gates, float* cs, float* ns, float* ms, u64* ring, int T, int B, int NH, int D,
             int mode, int k, int ids_rows, int mask_rows, int mask_heads, int ragged,
             float scale, void* stream) {
  constexpr bool BF = std::is_same<TI, __nv_bfloat16>::value;
  cudaGetLastError();
  if (T <= 0 || B <= 0) return 0;
  ScanArgs p = scan_args(T, B, NH, D, mode, k, ids_rows, mask_rows, mask_heads, ragged, scale);
  if (4 * p.J > NT) return (int)cudaErrorInvalidValue;
  // R columns resident in shared memory when they fit, else read through L2.
  const bool res = fwd_smem(p, true, BF) <= SMEM_MAX;
  const void* kernel = res ? (const void*)slstm_fwd_kernel<TI, true>
                           : (const void*)slstm_fwd_kernel<TI, false>;
  void* args[] = {&gx, &R, &h0, &c0, &n0, &m0, &ids, &mask, &lens,
                  &hs, &gates, &cs, &ns, &ms, &ring, &p};
  return launch(p, kernel, fwd_smem(p, res, BF), args, stream);
}

template <class TI>
int scan_bwd(const float* dy, const float* dcT, const float* dnT, const float* dmT,
             const TI* gates, const float* cs, const float* ns, const float* ms,
             const float* c0, const float* n0, const float* m0, const TI* R, const int* ids,
             const float* mask, const int* lens, TI* dgx, float* dg32, float* dh0, float* dc0,
             float* dn0, float* dm0, u64* ring, int T, int B, int NH, int D, int mode, int k,
             int ids_rows, int mask_rows, int mask_heads, int ragged, float scale,
             void* stream) {
  constexpr bool BF = std::is_same<TI, __nv_bfloat16>::value;
  cudaGetLastError();
  if (T <= 0 || B <= 0) return 0;
  ScanArgs p = scan_args(T, B, NH, D, mode, k, ids_rows, mask_rows, mask_heads, ragged, scale);
  const bool res = bwd_smem(p, true, BF) <= SMEM_MAX;
  const void* kernel = res ? (const void*)slstm_bwd_kernel<TI, true>
                           : (const void*)slstm_bwd_kernel<TI, false>;
  void* args[] = {&dy, &dcT, &dnT, &dmT, &gates, &cs, &ns, &ms, &c0, &n0, &m0, &R,
                  &ids, &mask, &lens, &dgx, &dg32, &dh0, &dc0, &dn0, &dm0, &ring, &p};
  return launch(p, kernel, bwd_smem(p, res, BF), args, stream);
}

template <class TO>
int wg(const float* hs, const float* h0, const float* dgx, const int* steps, const int* nsteps,
       const int* partial, const float* keep, const float* mask, TO* dR, int T, int B, int NH,
       int D, int mode, int ids_rows, int mask_rows, int mask_heads, float scale,
       void* stream) {
  cudaGetLastError();
  if (D <= 0 || NH <= 0) return 0;
  ScanArgs p{T, B, NH, D, mode, 0, ids_rows, mask_rows, mask_heads, 0, 0, 0, scale};
  const int nblk = (D + WU - 1) / WU, ncol = (4 * D + WC - 1) / WC;
  const long long ctas = (long long)nblk * ncol * NH;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // 16-byte copies where every row starts on 16 bytes
  const uintptr_t bases = (uintptr_t)hs | (uintptr_t)h0 | (uintptr_t)dgx |
                          (uintptr_t)keep | (uintptr_t)mask;
  const bool vec = D % 4 == 0 && bases % 16 == 0;
  auto kern = vec ? slstm_wg_kernel<TO, true> : slstm_wg_kernel<TO, false>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         W_SMEM);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)ctas, WT, W_SMEM, (cudaStream_t)stream>>>(
      hs, h0, dgx, steps, nsteps, partial, keep, mask, dR, p, nblk, ncol);
  return (int)cudaGetLastError();
}

}  // namespace

// K6's grid for NH heads of D units: *J units a CTA, *cph CTAs a head.
extern "C" void slstm_scan_units(int NH, int D, int* J, int* cph) {
  const ScanArgs p = scan_args(1, 1, NH, D, 0, 0, 1, 1, 1, 0, 1.f);
  *J = p.J;
  *cph = p.cph;
}

// Words of the zeroed ring a scan launch needs: (direction 0 forward, 1
// backward); the wrapper allocates them with torch.zeros.
extern "C" long long slstm_scan_ring_words(int direction, int B, int NH, int D) {
  const ScanArgs p = scan_args(1, B, NH, D, 0, 0, 1, 1, 1, 0, 1.f);
  const long long per_slot = (long long)B * NH * D * (direction ? p.cph : 1);
  return 2 * per_slot + 2LL * NH * p.cph;
}

// xg (T, B, NH, 4dh) with the bias folded in; R (NH, dh, 4dh); h0, c0, n0,
// m0 (B, NH, dh); ids (ids_rows, k) int32 unit ids (mode 1); mask
// (mask_rows, B, mask_heads, dh) (mode 2); lens (B,) int32 when ragged;
// ring: slstm_scan_ring_words(0, ...) zeroed words.
// Outputs hs, cs, ns, ms (T, B, NH, dh) and gates (T, B, NH, 4dh). The
// _bf16 entry takes xg and R and writes gates in bfloat16, the rest float32.
extern "C" int slstm_scan_fwd_f32(const float* gx, const float* R, const float* h0,
                                  const float* c0, const float* n0, const float* m0,
                                  const int* ids, const float* mask, const int* lens,
                                  float* hs, float* gates, float* cs, float* ns, float* ms,
                                  u64* ring, int T, int B, int NH, int D, int mode, int k,
                                  int ids_rows, int mask_rows, int mask_heads, int ragged,
                                  float scale, void* stream) {
  return scan_fwd(gx, R, h0, c0, n0, m0, ids, mask, lens, hs, gates, cs, ns, ms, ring, T, B,
                  NH, D, mode, k, ids_rows, mask_rows, mask_heads, ragged, scale, stream);
}

extern "C" int slstm_scan_fwd_bf16(const __nv_bfloat16* gx, const __nv_bfloat16* R,
                                   const float* h0, const float* c0, const float* n0,
                                   const float* m0, const int* ids, const float* mask,
                                   const int* lens, float* hs, __nv_bfloat16* gates, float* cs,
                                   float* ns, float* ms, u64* ring, int T, int B, int NH, int D,
                                   int mode, int k, int ids_rows, int mask_rows, int mask_heads,
                                   int ragged, float scale, void* stream) {
  return scan_fwd(gx, R, h0, c0, n0, m0, ids, mask, lens, hs, gates, cs, ns, ms, ring, T, B,
                  NH, D, mode, k, ids_rows, mask_rows, mask_heads, ragged, scale, stream);
}

// dy (T, B, NH, dh): dL/dhs with dL/dh_T already added at T-1; dcT, dnT, dmT
// (B, NH, dh); gates, cs, ns, ms from the forward; ring:
// slstm_scan_ring_words(1, ...) zeroed words. Outputs dgx (T, B, NH, 4dh),
// dh0, dc0, dn0, dm0 (B, NH, dh). dR is slstm_wg_*'s. The _bf16 entry takes
// gates and R and writes dgx in bfloat16, and writes the float32 dgates to
// dg32 (T, B, NH, 4dh) for slstm_wg_bf16.
extern "C" int slstm_scan_bwd_f32(const float* dy, const float* dcT, const float* dnT,
                                  const float* dmT, const float* gates, const float* cs,
                                  const float* ns, const float* ms, const float* c0,
                                  const float* n0, const float* m0, const float* R,
                                  const int* ids, const float* mask, const int* lens,
                                  float* dgx, float* dh0, float* dc0, float* dn0, float* dm0,
                                  u64* ring, int T, int B, int NH, int D, int mode, int k,
                                  int ids_rows, int mask_rows, int mask_heads, int ragged,
                                  float scale, void* stream) {
  return scan_bwd(dy, dcT, dnT, dmT, gates, cs, ns, ms, c0, n0, m0, R, ids, mask, lens, dgx,
                  (float*)nullptr, dh0, dc0, dn0, dm0, ring, T, B, NH, D, mode, k, ids_rows,
                  mask_rows, mask_heads, ragged, scale, stream);
}

extern "C" int slstm_scan_bwd_bf16(const float* dy, const float* dcT, const float* dnT,
                                   const float* dmT, const __nv_bfloat16* gates,
                                   const float* cs, const float* ns, const float* ms,
                                   const float* c0, const float* n0, const float* m0,
                                   const __nv_bfloat16* R, const int* ids, const float* mask,
                                   const int* lens, __nv_bfloat16* dgx, float* dg32, float* dh0,
                                   float* dc0, float* dn0, float* dm0, u64* ring, int T, int B,
                                   int NH, int D, int mode, int k, int ids_rows, int mask_rows,
                                   int mask_heads, int ragged, float scale, void* stream) {
  return scan_bwd(dy, dcT, dnT, dmT, gates, cs, ns, ms, c0, n0, m0, R, ids, mask, lens, dgx,
                  dg32, dh0, dc0, dn0, dm0, ring, T, B, NH, D, mode, k, ids_rows, mask_rows,
                  mask_heads, ragged, scale, stream);
}

// hs (T, B, NH, dh), h0 (B, NH, dh), dgx (T, B, NH, 4dh) float32 dgates;
// steps (ceil(dh / 64), T) int32: each 64-unit block's active steps,
// ascending, nsteps of them; mode 1: partial (ceil(dh / 64),) int32, 1 where
// an active step keeps only part of the block, and keep (ids_rows, dh) 1/0;
// mode 2: mask as the scan's. Output dR (NH, dh, 4dh), every element
// written, float32 (_f32) or bfloat16 (_bf16). Returns the error of
// cudaFuncSetAttribute or of the launch.
extern "C" int slstm_wg_f32(const float* hs, const float* h0, const float* dgx,
                            const int* steps, const int* nsteps, const int* partial,
                            const float* keep, const float* mask, float* dR, int T, int B,
                            int NH, int D, int mode, int ids_rows, int mask_rows,
                            int mask_heads, float scale, void* stream) {
  return wg(hs, h0, dgx, steps, nsteps, partial, keep, mask, dR, T, B, NH, D, mode, ids_rows,
            mask_rows, mask_heads, scale, stream);
}

extern "C" int slstm_wg_bf16(const float* hs, const float* h0, const float* dgx,
                             const int* steps, const int* nsteps, const int* partial,
                             const float* keep, const float* mask, __nv_bfloat16* dR, int T,
                             int B, int NH, int D, int mode, int ids_rows, int mask_rows,
                             int mask_heads, float scale, void* stream) {
  return wg(hs, h0, dgx, steps, nsteps, partial, keep, mask, dR, T, B, NH, D, mode, ids_rows,
            mask_rows, mask_heads, scale, stream);
}

#ifdef SLSTM_PHASES
// Copies g_phase (2 x 1024 x 8 cycle counts) to host memory `out` and zeroes it.
extern "C" int slstm_scan_phases(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  if (err == cudaSuccess) {
    static unsigned long long zero[2][1024][8];
    err = cudaMemcpyToSymbol(g_phase, zero, sizeof(g_phase));
  }
  return (int)err;
}
#endif

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
