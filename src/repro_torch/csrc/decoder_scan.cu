// Fused teacher-forced seq2seq decoder recurrence on Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernels of repro/kernels/decoder_scan.py:
//   K7  _pl_fwd_kernel via _pallas_fwd  -> dec_fwd_tma
//   K8  _pl_bwd_kernel via _pallas_bwd  -> dec_bwd_kernel
// Per step t: nl stacked LSTM layers (layer 0 adds drop(h~_{t-1}) @ W_feed
// to the hoisted gx0_t, upper layers drop(h_{l-1,t}) @ W_l + b_l), each with
// drop(h_{l,t-1}) @ U_l; Luong general attention of the top h over the
// encoder memory with the additive score_bias; h~_t = tanh([ctx; h] @ w_comb)
// becomes the next step's feed. 2*nl dropout sites in canonical order
// [feed, rh_0..rh_{nl-1}, nr_1..nr_{nl-1}], each off (0), structured (1: a
// (T|1, k) table of kept unit ids, compact gathers) or dense (2: a
// (T|1, B, H) mask). A one-row table is the FIXED time pattern. Ragged
// lengths freeze every carry (h, c, feed); the in-step math of a frozen row
// still runs on its unfrozen values, as in the reference.
//
// What bounds it on the H100: the recurrence is serial in T and its chain
// (layer-0 gates -> h_0 -> layer-1 gates -> h_1 -> attention -> h~ -> next
// feed) has four dependent phases per step, each far too small to fill the
// card (B=64 rows x ~358 kept units x 2048 columns per product). Latency per
// phase (grid barriers, L2 round trips), not FLOPs or HBM bytes, bounds it.
// Design: one persistent launch per direction, every CTA resident, barriers
// of all CTAs on an L2 counter between dependent phases. The kernels take
// nl = 2 layers (the paper's NMT model).
// Forward (K7, dec_fwd_tma below): gate phases are owned by hidden units: a
// CTA owns J units and computes their 4 gate columns for all B rows; its
// columns of W_feed, U_l, W_l and of w_comb stay in shared memory (H=512:
// 144 KB), and its inputs, published by their owners in its compact layout,
// arrive by TMA. Attention is owned by batch rows (encoder memory read
// through L2). The readout is owned by units again (columns of w_comb).
// Barriers per step: nl + 2.
// Backward (reverse time; K8, dec_bwd_kernel below): the grid of K4's
// backward (csrc/scan_exchange.cuh: P clusters of Q CTAs, J units a CTA).
// The readout backward is owned by units (their rows of w_comb resident,
// dpre staged), the attention backward by batch rows, then per layer the
// pointwise backward by units and BP through the cluster exchange of K4
// (tagged partial sums, no grid-wide barrier), three barriers of all CTAs
// on an L2 counter a step. The weight gradients (dW_feed, dU, dW, dW_comb)
// and d enc_proj / d enc_out, which do not feed the recurrence, are
// products over the T x B pairs after the scan, each output summed by one
// thread in a fixed order: no atomics, a second launch gives the same bits.
// A dropped unit gets x = 0 in WG and no BP partial: BP runs over the kept
// units only, WG over all H units, the dropped ones times zero (1 / (1 - p)
// times the kept units' FLOPs, csrc/scan_exchange.cuh). The backward takes
// B <= 256, H % 4 == 0 and at most 8 units a CTA (H <= 960 on 120 CTAs);
// both directions refuse a shape whose plan does not fit (the wrapper
// raises). Data written by other CTAs in the same launch is read through L2
// only (__ldcg, cp.async.cg, TMA).
// No fast-math: score_bias is -1e30 and the softmax subtracts its max.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "scan_exchange.cuh"
#include "sm90.cuh"

namespace cg = cooperative_groups;

constexpr int NL = 2;   // layers: the only depth the kernels take

// Argument structs of the C entry points (mirrored by ctypes Structures in
// kernels/decoder_scan.py); outside the anonymous namespace so that the
// entry points keep external linkage.
struct SiteArg {
  int mode;        // 0 off, 1 structured, 2 dense
  int k;           // kept units per ids row
  int rows;        // 1 (FIXED) or T
  float scale;
  const int* ids;  // (rows, k) unit ids
  const float* mask;  // (rows, B, H)
};

struct FwdArgs {
  int T, B, H, S, nl, ragged;
  const float *gx0, *us, *ws, *bs, *wf, *wc, *ep, *eo, *sb, *h0, *c0, *f0;
  const int* lens;
  SiteArg sites[2 * NL];
  float *htil, *alpha, *gates, *hs, *cs;
};

struct BwdArgs {
  int T, B, H, S, nl, ragged;
  const float *dy, *dhT, *dcT, *dfT, *gates, *hs, *cs, *htil, *alpha, *h0, *c0, *f0;
  const float *us, *ws, *wf, *wc, *ep, *eo;
  const int* lens;
  SiteArg sites[2 * NL];
  float *dgx0, *dus, *dws, *dbs, *dwf, *dwc, *dep, *deo, *dh0, *dc0, *df0;
  // scratch: layer 1's dgates (T, B, 4H); dpre, dctx (T, B, H); dcur (B, H);
  // ds (T, B, S); ctx (T, B, H) = alpha_t enc_out, recomputed in B
  float *dgs, *dpre, *dctx, *dcur, *dss, *ctxs;
  unsigned long long* ring;   // the zeroed exchange (kernels/decoder_scan.py)
  int Q, J;                   // clusters of Q CTAs, J units a CTA
};

// K7 (dec_fwd_tma): FwdArgs and the consumer layouts that
// kernels/decoder_scan.py builds on the device.
struct TmaArgs {
  FwdArgs f;
  const int* inv[2 * NL];   // structured site: (rows, H) 1 + a unit's column in the compact row, 0 dropped
  float* pub[2 * NL];       // (2, B, kp) the site's input as its product reads it, a slot per step parity
  int kp[2 * NL];           // the compact width (k, or H for dense / off) rounded up to 4
  float* rdx;               // (B, 2 Hq) the readout's input [h_top | ctx], Hq = H rounded up to 32
  unsigned* bar;            // the zeroed grid-barrier counter
  int Q, J, NS;             // clusters of Q CTAs, J units a CTA, ring stages
};

namespace {

constexpr int NT = 256;          // threads per CTA
constexpr int RA = 32;           // backward: dpre rows per staged chunk (readout)
constexpr int KSA = NT / RA;     // backward: K-split of the readout
constexpr int JMAX = 8;          // backward: most hidden units a CTA owns
constexpr int BC = 64;           // backward: dgates rows per cluster gather
constexpr int NFD = 12;          // backward: residual fields a (row, unit), both layers
constexpr size_t SMEM_MAX = 227 * 1024;

__host__ __device__ inline size_t al4(size_t n) { return (n + 3) & ~size_t(3); }

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Site i's weight: 0 -> W_feed, 1+l -> U_l, nl+l -> W_l (l >= 1).
__device__ __forceinline__ const float* site_w(const float* wf, const float* us,
                                               const float* ws, int nl, int i,
                                               size_t HG) {
  return i == 0 ? wf : (i <= nl ? us + (size_t)(i - 1) * HG : ws + (size_t)(i - nl - 1) * HG);
}

// Luong attention of batch row b at step t, by NTH threads: the scores of
// the top h (hsrc, H floats written in this launch, staged into cur) against
// enc_proj[b] plus score_bias into sc (S floats), their softmax into
// alpha_t[b], the context alpha_t[b] enc_out[b] into ctx (H floats).
// mark(i) closes phase i of the phase counters.
template <int NTH, class Mark>
__device__ __forceinline__ void attend_row(const FwdArgs& a, int t, int b, const float* hsrc,
                                           float* ctx, float* cur, float* sc, Mark mark) {
  const int B = a.B, H = a.H, S = a.S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int h = tid; h < H; h += NTH) cur[h] = __ldcg(hsrc + h);
  __syncthreads();
  for (int s = warp; s < S; s += NTH / 32) {
    const float* e = a.ep + ((size_t)b * S + s) * H;
    float d = 0.f;
    for (int h = lane; h < H; h += 32) d = fmaf(cur[h], __ldg(e + h), d);
    d = warp_sum(d);
    if (lane == 0) sc[s] = d + __ldg(a.sb + (size_t)b * S + s);
  }
  __syncthreads();
  mark(8);
  if (warp == 0) {
    float m = __int_as_float(0xff800000);   // -inf
    for (int s = lane; s < S; s += 32) m = fmaxf(m, sc[s]);
    m = warp_max(m);
    float z = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float ex = expf(sc[s] - m);
      sc[s] = ex;
      z += ex;
    }
    z = warp_sum(z);
    for (int s = lane; s < S; s += 32) {
      const float al = sc[s] / z;
      sc[s] = al;
      a.alpha[((size_t)t * B + b) * S + s] = al;
    }
  }
  __syncthreads();
  mark(9);
  for (int h = tid; h < H; h += NTH) {
    float v = 0.f;
    for (int s = 0; s < S; ++s) v = fmaf(sc[s], __ldg(a.eo + ((size_t)b * S + s) * H + h), v);
    ctx[h] = v;
  }
  __syncthreads();
  mark(10);
}

// ---------------------------------------------------------------------------
// K7: forward, dec_fwd_tma
// ---------------------------------------------------------------------------
//
// J units a CTA, their columns of W_feed, U_l, W_1 and w_comb resident, four
// barriers a step, attention by batch rows. Its staging:
//   * every carry is published by its owner in its consumer's layout:
//     dropped, scaled and compacted, through the site's inverse map, into a
//     dense (B, kp) block (TmaArgs::pub, one slot per step parity, so a copy
//     for step t + 1 never overwrites one a slower CTA still reads in step
//     t); h_0 (unfrozen) to nr_1 at t, h_0 and h_1 (frozen) to rh_0, rh_1 at
//     t + 1, h~ (frozen) to the feed at t + 1, h_1 (unfrozen) and ctx densely
//     into rdx = [h_top | ctx] for the attention and the readout;
//   * a gate or readout phase reads its inputs as 64-row x 32-column boxes
//     (8 KB) by TMA, multicast to the Q CTAs of a cluster (CTA r issues the
//     boxes n with n % Q == r; L2 serves a box once a cluster instead of once
//     a CTA), into a ring of NS stages that one producer warp keeps filled
//     while eight consumer warps multiply: the product of box i runs while
//     the next NS - 1 land. A stage is refilled once the four consumer warps
//     of every CTA of the cluster have released it (the issuer's `empty`
//     mbarrier, arrived on across the cluster);
//   * the gate products run on the TF32 tensor cores in split precision
//     (3xTF32, hi rounded to nearest: csrc/tf32x3.cuh), A from the ring and
//     B from the resident weights, split as they are loaded; the readout's
//     (4 columns a CTA) on FFMA. Warp w takes rows 16 (w % 4) .. + 15 of a
//     row block and the boxes of parity w / 4; each box's product is summed
//     from zero and added to the warp's sums, and the two parities' sums
//     are added in a fixed order: a second launch gives the same bits;
//   * the barriers between phases are grid_barrier on a zeroed L2 counter.
// The generic stores of other CTAs that a TMA box reads are ordered before
// it by the barrier's acquire and a fence.proxy.async in the producer.

constexpr int TNT = 288;             // threads: 8 consumer warps and a producer warp
constexpr int TNC = 256;             // consumer threads
constexpr int TMB = 64;              // rows of a box: a row block
constexpr int TKC = 32;              // columns of a box (128 bytes, the swizzle's width)
constexpr uint32_t TBOX = TMB * TKC * 4;
constexpr int TJMAX = 4;             // units a CTA: 16 gate columns, two mma n-tiles

struct alignas(64) TmaMaps {
  CUtensorMap site[2 * NL][2];       // each site's published block, by slot
  CUtensorMap rd;                    // rdx
};

__host__ __device__ inline int rup(int n, int m) { return (n + m - 1) / m * m; }

// Byte offsets of K7's shared memory from its 1024-aligned base:
// o[0] the ring (NS boxes); o[1] the gate weights (4 sites x H rows x 16
// columns, column c of a row at 2 (c % 8) + c / 8, so that a lane reads its
// column of both n-tiles at once); o[2] w_comb's columns (KR rows x 4, in
// rdx's order: h_top's rows, then ctx's); o[3]
// the partial sums (TMB x 16) and then the two sites' kept-unit lists (2 x
// KRG), which the attention's vectors share; o[4] the cell state (NL x B x
// J); o[5] the mbarriers (full[NS], empty[NS]); o[6] the bytes to ask for,
// the alignment's slack included.
__host__ __device__ inline void tma_layout(int B, int H, int S, int J, int NS, size_t (&o)[7]) {
  const int Hp = rup(H, 4), KR = 2 * rup(H, TKC), KRG = rup(Hp, TKC);
  const size_t lists = (size_t)TMB * 16 * 4 + (size_t)2 * KRG * 4;
  const size_t att = (size_t)4 * (Hp + rup(S, 4));
  o[0] = 0;
  o[1] = (size_t)NS * TBOX;
  o[2] = o[1] + (size_t)4 * H * 16 * 4;
  o[3] = o[2] + (size_t)KR * 4 * 4;
  o[4] = o[3] + (lists > att ? lists : att);
  o[5] = o[4] + (size_t)rup(NL * B * J * 4, 16);
  o[6] = o[5] + (size_t)16 * NS + 1024;
}

size_t tma_smem(int B, int H, int S, int J, int NS) {
  size_t o[7];
  tma_layout(B, H, S, J, NS, o);
  return o[6];
}

__device__ __forceinline__ void ldsm4_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(TNC) : "memory");
}

// The A fragment (16 x 8, split) of rows 16 mt .. + 15 and columns 8 kk ..
// + 7 of the box at `tile` (64 rows of 128 bytes, 16-byte chunk c of row r
// at c ^ (r % 8): TMA's 128-byte swizzle, so ldmatrix's eight rows fall on
// eight bank groups).
__device__ __forceinline__ void box_frag_a(uint32_t tile, int mt, int kk, int lane,
                                           uint32_t (&h)[4], uint32_t (&l)[4]) {
  const int m = lane >> 3;
  uint32_t raw[4];
  ldsm4_at(raw, tile + (16 * mt + (m & 1) * 8 + (lane & 7)) * 128 +
                    (((2 * kk + (m >> 1)) ^ (lane & 7)) << 4));
#pragma unroll
  for (int q = 0; q < 4; ++q) split_rn(__uint_as_float(raw[q]), h[q], l[q]);
}

// acc[nt] += the box's rows 16 mt .. (its 32 compact columns, unit ul[k] of
// column k) x W's rows ul[k], n-tile nt of the 16 gate columns; the box's
// terms summed from zero, small terms apart, then added in. (Every load of
// the box first and four chains a n-tile measured no faster on the card.)
__device__ __forceinline__ void tma_gate_box(float (&acc)[2][4], uint32_t tile, const float* W,
                                             const int* ul, int mt, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float dl[2][4] = {}, dh[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < TKC / 8; ++kk) {
    uint32_t ah[4], al[4], bh[2][2], bl[2][2];
    box_frag_a(tile, mt, kk, lane, ah, al);
    const float2 w0 = *reinterpret_cast<const float2*>(W + ul[8 * kk + t] * 16 + 2 * g);
    const float2 w1 = *reinterpret_cast<const float2*>(W + ul[8 * kk + t + 4] * 16 + 2 * g);
    split_rn(w0.x, bh[0][0], bl[0][0]);
    split_rn(w1.x, bh[0][1], bl[0][1]);
    split_rn(w0.y, bh[1][0], bl[1][0]);
    split_rn(w1.y, bh[1][1], bl[1][1]);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      mma(dl[nt], al, bh[nt]);
      mma(dl[nt], ah, bl[nt]);
      mma(dh[nt], ah, bh[nt]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] += dh[nt][e] + dl[nt][e];
}

// The readout's box on FFMA: lane l takes row r = 16 mt + l / 2 and the
// units q = 2 (l % 2), q + 1 of the box's 32 columns against Wc's 32 rows (4
// columns a row), summed in column order from zero and then added in. (On
// the TF32 tensor cores half of each 8-column n-tile idles; FFMA measured
// faster on the card.)
__device__ __forceinline__ void tma_readout_box(float (&acc)[2], const float* tile, const float* Wc,
                                                int mt, int lane) {
  const int r = 16 * mt + (lane >> 1), q = 2 * (lane & 1);
  const float* row = tile + r * TKC;
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int c = 0; c < TKC / 4; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(row + 4 * (c ^ (r & 7)));
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 w = *reinterpret_cast<const float2*>(Wc + (4 * c + e) * 4 + q);
      d0 = fmaf(xs[e], w.x, d0);
      d1 = fmaf(xs[e], w.y, d1);
    }
  }
  acc[0] += d0;
  acc[1] += d1;
}

// The two box parities' sums of the gate columns into red[row * 16 +
// column]: the even boxes' plus the odd ones'. Between consumer barriers.
__device__ __forceinline__ void tma_reduce(float* red, const float (&acc)[2][4], int mt, int kh,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  auto at = [&](int nt, int e) {
    return red + (16 * mt + g + 8 * (e >> 1)) * 16 + 8 * nt + 2 * t + (e & 1);
  };
  if (kh == 1)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) *at(nt, e) = acc[nt][e];
  consumers_sync();
  if (kh == 0)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) *at(nt, e) = acc[nt][e] + *at(nt, e);
  consumers_sync();
}

__global__ void __launch_bounds__(TNT, 1)
    dec_fwd_tma(const __grid_constant__ TmaMaps maps, const __grid_constant__ TmaArgs ta) {
  const FwdArgs& a = ta.f;
  const int T = a.T, B = a.B, H = a.H, G = 4 * H, J = ta.J, Q = ta.Q, NS = ta.NS;
  constexpr int nl = NL;
  const int Hp = rup(H, 4), Hq = rup(H, TKC), H2 = 2 * Hq, KR = H2, KRG = rup(Hp, TKC);
  const int NRB = (B + TMB - 1) / TMB;
  const size_t HG = (size_t)H * G;
  size_t o[7];
  tma_layout(B, H, a.S, J, NS, o);
  extern __shared__ float4 smem4[];
  const uint32_t raw0 = smem_u32(smem4), base = (raw0 + 1023u) & ~1023u;
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4) + (base - raw0);
  float* Wsm = reinterpret_cast<float*>(sm + o[1]);
  float* Wcs = reinterpret_cast<float*>(sm + o[2]);
  float* red = reinterpret_cast<float*>(sm + o[3]);
  int* uid = reinterpret_cast<int*>(sm + o[3] + (size_t)TMB * 16 * 4);
  float* cst = reinterpret_cast<float*>(sm + o[4]);
  const uint32_t ring = base, full0 = base + (uint32_t)o[5], empty0 = full0 + 8 * NS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mt = warp & 3, kh = (warp >> 2) & 1;
  const int rank = (int)cluster_rank();
  const uint16_t ctas = (uint16_t)((1u << Q) - 1);
  const int j0 = blockIdx.x * J, Jc = max(0, min(J, H - j0));

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, Q * 4);   // the four consumer warps of a parity, in each CTA
    }
    mbar_init_fence();
  }
  for (int i = 0; i < 2 * nl; ++i) {
    const float* w = site_w(a.wf, a.us, a.ws, nl, i, HG);
    for (int e = tid; e < H * 16; e += TNT) {
      const int u = e >> 4, p = e & 15, c = 8 * (p & 1) + (p >> 1), gate = c / J, q = c - gate * J;
      Wsm[(size_t)i * H * 16 + e] =
          c < 4 * J && q < Jc ? w[(size_t)u * G + (size_t)gate * H + j0 + q] : 0.f;
    }
  }
  for (int e = tid; e < KR * 4; e += TNT) {   // rdx's column k: h_top, then ctx
    const int k = e >> 2, q = e & 3;
    const int row = k < H ? H + k : (k >= Hq && k < Hq + H ? k - Hq : -1);
    Wcs[e] = row >= 0 && q < Jc ? a.wc[(size_t)row * H + j0 + q] : 0.f;
  }
  for (int e = tid; e < nl * B * J; e += TNT) {
    const int l = e / (B * J), b = (e / J) % B, q = e % J;
    cst[e] = q < Jc ? a.c0[((size_t)l * B + b) * H + j0 + q] : 0.f;
  }

  // where site i's product at step tc reads unit j of row b, with the factor
  // the unit takes there; null where it is dropped
  auto pub_slot = [&](int i, int tc, int b, int j, float& f) -> float* {
    const SiteArg& st = a.sites[i];
    const int row = st.rows == 1 ? 0 : tc;
    float* dst = ta.pub[i] + ((size_t)(tc & 1) * B + b) * ta.kp[i];
    if (st.mode == 1) {
      const int p = __ldg(ta.inv[i] + (size_t)row * H + j) - 1;
      f = st.scale;
      return p < 0 ? nullptr : dst + p;
    }
    f = st.mode == 2 ? __ldg(st.mask + ((size_t)row * B + b) * H + j) * st.scale : 1.f;
    return dst + j;
  };
  // the units of the compact columns of sites sa and sb at step t (0 past
  // the width: those columns read as zeros), by the consumer threads
  auto load_uids = [&](int t, int sa, int sb) {
    for (int e = tid; e < 2 * KRG; e += TNC) {
      const int second = e >= KRG, kk = e - second * KRG;
      const SiteArg& st = a.sites[second ? sb : sa];
      uid[e] = st.mode == 1 ? (kk < st.k ? __ldg(st.ids + (size_t)(st.rows == 1 ? 0 : t) * st.k + kk)
                                         : 0)
                            : (kk < H ? kk : 0);
    }
  };
  auto boxes = [&](int i) {
    const SiteArg& st = a.sites[i];
    return ((st.mode == 1 ? st.k : H) + TKC - 1) / TKC;
  };
  // a product phase's boxes, row block by row block: box jc of a row block
  // from map m1's columns TKC jc while jc < ch1, else from m2's TKC (jc -
  // ch1)
  struct Phase {
    const CUtensorMap *m1, *m2;
    int ch1, nch;
  };
  auto gate_phase = [&](int l, int t) {   // rh_l, then the feed or nr_1
    const int s1 = 1 + l, s2 = l == 0 ? 0 : nl + l;
    const int ch1 = boxes(s1);
    return Phase{&maps.site[s1][t & 1], &maps.site[s2][t & 1], ch1, ch1 + boxes(s2)};
  };
  const Phase ro{&maps.rd, &maps.rd, KR / TKC, KR / TKC};   // [h_top | ctx]
  // the producer: the boxes of the phase whose first box is seq
  auto produce = [&](int seq, const Phase& ph) {
    fence_proxy_async();
    for (int i = 0; i < NRB * ph.nch; ++i) {
      const int n = seq + i, rb = i / ph.nch, jc = i - rb * ph.nch, s = n % NS;
      const uint32_t fb = full0 + 8 * s;
      if (n >= NS) mbar_wait(fb, (n / NS - 1) & 1);   // box n - NS has landed here
      mbar_expect_tx(fb, TBOX);
      if (n % Q == rank) {
        if (n >= NS) mbar_wait(empty0 + 8 * s, (n / NS - 1) & 1);   // and was read
        const bool first = jc < ph.ch1;
        tma_load_2d_mc(ring + s * TBOX, first ? ph.m1 : ph.m2, fb,
                       TKC * (first ? jc : jc - ph.ch1), TMB * rb, ctas);
      }
    }
  };
  auto take = [&](int n) { mbar_wait(full0 + 8 * (n % NS), (n / NS) & 1); };
  auto give = [&](int n) {
    __syncwarp();
    if (lane == 0) mbar_arrive_remote(empty0 + 8 * (n % NS), n % Q);
  };
  const bool producer = warp == TNC / 32 && lane == 0;

  // the initial carries, published for step 0
  for (int e = tid; e < B * J; e += TNT) {
    const int b = e / J, q = e - b * J, j = j0 + q;
    if (q >= Jc) continue;
    float f, *d;
    if ((d = pub_slot(0, 0, b, j, f))) *d = a.f0[(size_t)b * H + j] * f;
    for (int l = 0; l < nl; ++l)
      if ((d = pub_slot(1 + l, 0, b, j, f))) *d = a.h0[((size_t)l * B + b) * H + j] * f;
  }
  if (tid < TNC) load_uids(0, 1, 0);
  __syncthreads();
  cl_arrive();
  cl_wait();   // the cluster's mbarriers are initialised
  unsigned nbar = 0;
  grid_barrier(ta.bar, ++nbar);

  int seq = 0;   // the first box of the phase
  FPHASE_START();
  for (int t = 0; t < T; ++t) {
    const float* feed_prev = t == 0 ? a.f0 : a.htil + (size_t)(t - 1) * B * H;
    // ---- LSTM layers ----
    for (int l = 0; l < nl; ++l) {
      const Phase ph = gate_phase(l, t);
      const int s1 = 1 + l, s2 = l == 0 ? 0 : nl + l, total = NRB * ph.nch;
      const float* hprev = t == 0 ? a.h0 + (size_t)l * B * H
                                  : a.hs + ((size_t)l * T + t - 1) * B * H;
      if (warp == TNC / 32) {
        if (producer) produce(seq, ph);
      } else {
        for (int rb = 0; rb < NRB; ++rb) {
          // this thread's (row, unit) of the pointwise and its inputs, loaded
          // before the product
          const int bb = tid / J, q = tid - bb * J, b = TMB * rb + bb, j = j0 + q;
          const bool pw = bb < TMB && b < B && q < Jc;
          float base[4] = {0.f, 0.f, 0.f, 0.f}, hold = 0.f, fA = 0.f, fB = 0.f;
          float *dA = nullptr, *dB = nullptr;
          bool frozen = false;
          if (pw) {
#pragma unroll
            for (int g2 = 0; g2 < 4; ++g2)
              base[g2] = l == 0 ? __ldg(a.gx0 + ((size_t)t * B + b) * G + (size_t)g2 * H + j)
                                : __ldg(a.bs + (size_t)(l - 1) * G + (size_t)g2 * H + j);
            frozen = a.ragged && t >= __ldg(a.lens + b);
            if (frozen) hold = __ldcg(hprev + (size_t)b * H + j);
            if (l == 0) dA = pub_slot(nl + 1, t, b, j, fA);       // nr_1, this step
            if (t + 1 < T) dB = pub_slot(1 + l, t + 1, b, j, fB);  // rh_l, the next
          }
          float acc[2][4] = {};
          const bool act = 16 * mt < B - TMB * rb;
          int n = seq + rb * ph.nch;
          for (int jc = 0; jc < ph.nch; ++jc, ++n) {
            if ((jc & 1) != kh) continue;
            take(n);
            FPHASE(4 * l);
            if (act) {
              const bool first = jc < ph.ch1;
              tma_gate_box(acc, ring + (n % NS) * TBOX, Wsm + (size_t)(first ? s1 : s2) * H * 16,
                           uid + (first ? TKC * jc : KRG + TKC * (jc - ph.ch1)), mt, lane);
            }
            give(n);
            FPHASE(4 * l + 1);
          }
          tma_reduce(red, acc, mt, kh, lane);
          if (pw) {
            float gv[4];
#pragma unroll
            for (int g2 = 0; g2 < 4; ++g2) gv[g2] = base[g2] + red[bb * 16 + g2 * J + q];
            const float ig = sigm(gv[0]), fg = sigm(gv[1]), gt = tanhf(gv[2]), og = sigm(gv[3]);
            float* cp = cst + ((size_t)l * B + b) * J + q;
            const float c_prev = *cp;
            float c_new = fg * c_prev + ig * gt;
            float h_new = og * tanhf(c_new);
            const size_t gofs = (((size_t)l * T + t) * B + b) * G + j;
#pragma unroll
            for (int g2 = 0; g2 < 4; ++g2) a.gates[gofs + (size_t)g2 * H] = gv[g2];
            // the in-step (unfrozen) value: layer 1's input, or the top h
            if (l == 0) {
              if (dA) *dA = h_new * fA;
            } else {
              ta.rdx[(size_t)b * H2 + j] = h_new;
            }
            if (frozen) {   // a frozen row carries t - 1
              h_new = hold;
              c_new = c_prev;
            }
            *cp = c_new;
            const size_t hofs = (((size_t)l * T + t) * B + b) * H + j;
            a.hs[hofs] = h_new;
            a.cs[hofs] = c_new;
            if (dB) *dB = h_new * fB;
          }
          consumers_sync();
          FPHASE(4 * l + 2);
        }
        if (l == 0) load_uids(t, 2, nl + 1);   // layer 1's sites
      }
      seq += total;
      grid_barrier(ta.bar, ++nbar);
      FPHASE(4 * l + 3);
    }
    // ---- attention: one batch row per CTA ----
    for (int b = blockIdx.x; b < B; b += gridDim.x)
      attend_row<TNT>(a, t, b, ta.rdx + (size_t)b * H2, ta.rdx + (size_t)b * H2 + Hq, red,
                      red + Hp, [](int) {});
    FPHASE(8);
    grid_barrier(ta.bar, ++nbar);
    FPHASE(9);
    // ---- readout h~ = tanh([ctx ; h_top] @ w_comb), owned by columns ----
    const int total = NRB * ro.nch;
    if (warp == TNC / 32) {
      if (producer) produce(seq, ro);
    } else {
      for (int rb = 0; rb < NRB; ++rb) {
        const int bb = tid / J, q = tid - bb * J, b = TMB * rb + bb, j = j0 + q;
        const bool pw = bb < TMB && b < B && q < Jc;
        float hold = 0.f, fB = 0.f;
        float* dB = nullptr;
        bool frozen = false;
        if (pw) {
          frozen = a.ragged && t >= __ldg(a.lens + b);
          if (frozen) hold = __ldcg(feed_prev + (size_t)b * H + j);
          if (t + 1 < T) dB = pub_slot(0, t + 1, b, j, fB);   // the feed, the next step
        }
        float acc[2] = {0.f, 0.f};
        const bool act = 16 * mt < B - TMB * rb;
        int n = seq + rb * ro.nch;
        for (int jc = 0; jc < ro.nch; ++jc, ++n) {
          if ((jc & 1) != kh) continue;
          take(n);
          FPHASE(10);
          if (act)
            tma_readout_box(acc, reinterpret_cast<const float*>(sm + (size_t)(n % NS) * TBOX),
                            Wcs + (size_t)TKC * jc * 4, mt, lane);
          give(n);
          FPHASE(11);
        }
        {   // the two parities' sums, in order, into red (row, unit)
          float* at = red + (16 * mt + (lane >> 1)) * 16 + 2 * (lane & 1);
          if (kh == 1) at[0] = acc[0], at[1] = acc[1];
          consumers_sync();
          if (kh == 0) at[0] = acc[0] + at[0], at[1] = acc[1] + at[1];
          consumers_sync();
        }
        if (pw) {
          const float v = frozen ? hold : tanhf(red[bb * 16 + q]);
          a.htil[((size_t)t * B + b) * H + j] = v;
          if (dB) *dB = v * fB;
        }
        consumers_sync();
        FPHASE(12);
      }
      if (t + 1 < T) load_uids(t + 1, 1, 0);   // layer 0's sites, the next step
    }
    seq += total;
    grid_barrier(ta.bar, ++nbar);
    FPHASE(13);
  }
  cl_arrive();
  cl_wait();   // no CTA leaves while its cluster may still arrive on its barriers
  FPHASE_END();
}

// ---------------------------------------------------------------------------
// K8: backward
// ---------------------------------------------------------------------------

// The backward's union region (floats): a chunk of dpre rows (readout);
// phase B's vectors; a chunk of the cluster's dgates rows and, from
// bwd_wofs on, the staged weight blocks of a layer's two sites (BP).
// phase B's vectors (dctx, h, alpha, ds rows), then its partial sums (8
// warps x 128 float4 contexts, or NT float4 of dcur)
__host__ __device__ inline size_t bwd_bvec(int H, int S) { return al4(2 * (size_t)H + 2 * S); }
__host__ __device__ inline size_t bwd_wofs(int B, int H, int S, int Q, int J) {
  const size_t b = (size_t)(((B < BC ? B : BC) + 15) & ~15) * (clu_cols8(Q, J) + 4);
  const size_t c = bwd_bvec(H, S) + 16 * (size_t)NT;   // B's partial sums
  return al4(b > c ? b : c);
}
__host__ __device__ inline size_t bwd_xregion(int B, int H, int S, int Q, int J) {
  const int P = ((H + J - 1) / J + Q - 1) / Q;
  const size_t a = (size_t)(B < RA ? B : RA) * (H + 4);
  const size_t w = bwd_wofs(B, H, S, Q, J) + 2 * (size_t)P * J * (clu_cols8(Q, J) + 4);
  return al4(a > w ? a : w);
}

// Bytes of shared memory; `pre`: with the residual prefetch buffers.
size_t bwd_smem(const BwdArgs& a, int Q, int J, bool pre) {
  const size_t P = ((a.H + J - 1) / J + Q - 1) / Q, BJ = (size_t)a.B * J;
  const size_t f = 2 * (size_t)J * (a.H + 4) + bwd_xregion(a.B, a.H, a.S, Q, J) +
                   (size_t)KSA * RA * 2 * J + 8 * J * ((a.B + 3) & ~size_t(3)) +
                   (pre ? 2 * NFD * BJ : 0) + 8 * BJ +
                   36 * (size_t)J;
  const size_t ints = 8 * P * J + 4 + 8 * (size_t)J + a.B + 128;
  return std::max(4 * f + 4 * ints, WG_SMEM);
}

// Grid: P clusters of Q CTAs, CTA i owning the J units [i J, i J + J)
// (csrc/scan_exchange.cuh). Per step r, in reverse time:
//   A  readout backward: dctx, dcur = dpre_r @ w_comb^T at the own units
//      (their 2J rows of w_comb in shared memory, dpre_r staged in chunks
//      of 32 rows), then a barrier of all CTAs;
//   B  attention backward, one batch row a CTA: ds_r (saved for d enc_proj)
//      and the context ctx_r (for dW_comb) on the same loads of enc_out, and
//      dcur += ds @ enc_proj, then a barrier;
//   C  per layer, top down: the pointwise backward of the own units (dh
//      with the BP partials of U_l from step r + 1, polled at its end, and,
//      at layer 0, of W_1 from this step), a cluster.sync() and a gather of
//      the cluster's dgates, then the BP partials of the layer's two sites
//      (U_l, and W_1 or W_feed; their weight blocks staged in shared memory
//      while the layer's pointwise runs), published as tagged words on four
//      channels (U_0, U_1, W_1, W_feed; two slots each);
//   end: dfeed of the own units (W_feed's partials) and this step's U_l
//      partials, their loads in flight together; dpre_{r-1}; a barrier.
// The barriers of every step keep the two-slot channels safe. After the
// scan the weight gradients run as products over the T x B pairs
// (csrc/scan_exchange.cuh wg_pass): dW_feed, dU_0, dU_1, dW_1, dW_comb's
// rows ([ctx ; h], the context recomputed in B on enc_out's loads: the
// forward does not store it), d enc_out[b] = sum_t alpha_t[b]^T dctx_t[b]
// and d enc_proj[b] = sum_t ds_t[b]^T h_t[b].
__global__ void __launch_bounds__(NT, 1) dec_bwd_kernel(BwdArgs a, int pre) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = a.T, B = a.B, H = a.H, S = a.S, G = 4 * H, J = a.J, Q = a.Q;
  const int P = ((H + J - 1) / J + Q - 1) / Q;
  constexpr int nl = NL;
  const size_t HG = (size_t)H * G;
  const Clu L(Q, J, P, H);
  const int j0 = L.j0, Jc = L.Jc, BJ = B * J, PJ = P * J, Bp = (B + 3) & ~3;
  const int ldh = H + 4, ldc = clu_cols8(Q, J) + 4, H4 = H / 4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* wcs = smem;                                         // 2J x ldh rows of w_comb
  float* X = wcs + 2 * (size_t)J * ldh;                      // union region
  float* wst = X + bwd_wofs(B, H, S, Q, J);                  // 2 x PJ x ldc staged weights
  float* redA = X + bwd_xregion(B, H, S, Q, J);              // KSA x RA x 2J
  float* dgo = redA + (size_t)KSA * RA * 2 * J;              // 2 x 4J x Bp own dgates
  float* resb = dgo + 8 * (size_t)J * Bp;                    // pre: 2 x NFD x B x J
  float* dhc = resb + (pre ? 2 * NFD * (size_t)BJ : 0);      // nl x B x J
  float* dcc = dhc + 2 * BJ;                                 // nl x B x J
  float* dfo = dcc + 2 * BJ;                                 // B x J
  float* pf = dfo + BJ;                                      // B x J
  float* dbo = pf + BJ;                                      // 4J
  float* dbp = dbo + 4 * J;                                  // 8 x 4J
  float* uin = dbp + 32 * J;                                 // nl x B x J
  int* kl = reinterpret_cast<int*>(uin + 2 * BJ);            // 4 sites x PJ (indices)
  int* ku = kl + 4 * PJ;                                     // 4 sites x PJ (unit ids)
  int* nkl = ku + 4 * PJ;                                    // 4
  int* flg = nkl + 4;                                        // 4 sites x 2 x J
  int* lns = flg + 8 * J;                                    // B
  int* wsum = lns + B;                                       // 4 x 32: warps' kept counts
  const size_t chw = 2 * (size_t)P * B * H;                  // words of a channel
  u64* ring = a.ring;
  unsigned* bar = reinterpret_cast<unsigned*>(ring + 4 * chw + 2 * (size_t)P * Q);
  float* keep = reinterpret_cast<float*>(ring + 4 * chw + 2 * (size_t)P * Q + 2);  // 4 x T x H
  unsigned nbar = 0;
  enum { CH_U0 = 0, CH_U1 = 1, CH_W1 = 2, CH_F = 3 };
  // channel ch's slot of step r (cluster c's block of it: + c B H)
  auto chan = [&](int ch, int r) { return ring + ch * chw + (size_t)(r & 1) * P * B * H; };
  const float* hs1 = a.hs + (size_t)(nl - 1) * T * B * H;    // the top layer's h

  // site i kept own unit q at row-step t (flags set at step t)
  auto kept = [&](int i, int t, int q) {
    return q < Jc && (a.sites[i].mode != 1 || flg[(i * 2 + (t & 1)) * J + q] == t);
  };
  // BP factor of site i at step t for (b, j)
  auto fct = [&](int i, int t, int b, int j) {
    const SiteArg& st = a.sites[i];
    if (st.mode == 0) return 1.f;
    if (st.mode == 1) return st.scale;
    return st.mask[((size_t)(st.rows == 1 ? 0 : t) * B + b) * H + j] * st.scale;
  };

  // ---- init ----
#pragma unroll 1
  for (int e = tid; e < 2 * J * H; e += NT) {
    const int o = e / H, h = e - o * H, q = o % J;
    wcs[(size_t)o * ldh + h] = q < Jc ? a.wc[(size_t)((o < J ? 0 : H) + j0 + q) * H + h] : 0.f;
  }
#pragma unroll 1
  for (int e = tid; e < 8 * J * Bp; e += NT) dgo[e] = 0.f;
#pragma unroll 1
  for (int b = tid; b < B; b += NT) lns[b] = a.ragged ? a.lens[b] : T;
#pragma unroll 1
  for (int e = tid; e < 8 * J; e += NT) flg[e] = -1;
#pragma unroll 1
  for (int e = tid; e < 4 * J; e += NT) dbo[e] = 0.f;
#pragma unroll 1
  for (int e = tid; e < 2 * BJ; e += NT) uin[e] = 0.f;
  int nk_all = 0;   // S_q's units in H: an ascending prefix of the indices
  while (nk_all < PJ && L.unit(nk_all) < H) ++nk_all;
#pragma unroll 1
  for (int i = 0; i < 4; ++i)
    if (a.sites[i].mode != 1)
      for (int s = tid; s < nk_all; s += NT) {
        kl[i * PJ + s] = s;
        ku[i * PJ + s] = L.unit(s);
      }
  const Div dB(B), dJc(Jc), dBJc(B * Jc), dH4(H4), d2J(2 * J), d4J(4 * J);
  if (tid < 4) nkl[tid] = a.sites[tid].mode != 1 ? nk_all : 0;
  __syncthreads();
#pragma unroll 1
  for (int e = tid; e < BJ; e += NT) {
    const int b = e / J, q = e % J, j = j0 + q;
    const bool ok = q < Jc;
    for (int l = 0; l < nl; ++l) {
      dhc[l * BJ + e] = ok ? a.dhT[((size_t)l * B + b) * H + j] : 0.f;
      dcc[l * BJ + e] = ok ? a.dcT[((size_t)l * B + b) * H + j] : 0.f;
    }
    dfo[e] = ok ? a.dfT[(size_t)b * H + j] : 0.f;
    pf[e] = 0.f;
    if (ok) {
      const size_t o = ((size_t)(T - 1) * B + b) * H + j;
      const float ht = a.htil[o];
      a.dpre[o] = T - 1 < lns[b] ? (a.dy[o] + dfo[e]) * (1.f - ht * ht) : 0.f;
    }
  }

  // step r's residuals of the own units, both layers (gates, c_r, c_{r-1}),
  // into buffer r & 1
  auto prefetch = [&](int r) {
    if (!pre) {
      cp_commit();   // one group a call, empty or not
      return;
    }
    float* dst = resb + (size_t)(r & 1) * NFD * BJ;
#pragma unroll 1
    for (int e = tid; e < NFD * B * Jc; e += NT) {
      const int f = dBJc.q(e), bq = e - f * B * Jc, b = dJc.q(bq), q = bq - b * Jc;
      const int l = f / 6, g = f - l * 6, j = j0 + q;
      const size_t row = ((size_t)l * T + r) * B + b;
      const float* src = g < 4 ? a.gates + row * G + (size_t)g * H + j
                       : g == 4 ? a.cs + row * H + j
                       : r > 0 ? a.cs + (row - B) * H + j
                               : a.c0 + ((size_t)l * B + b) * H + j;
      cp4(dst + (size_t)f * BJ + b * J + q, src, true);
    }
    cp_commit();
  };
  // residual g (gates 0-3, c_r 4, c_{r-1} 5) of layer l for own (b, q)
  auto resid = [&](int r, int l, int g, int b, int q) {
    if (pre) return resb[((size_t)(r & 1) * NFD + 6 * l + g) * BJ + b * J + q];
    const int j = j0 + q;
    const size_t row = ((size_t)l * T + r) * B + b;
    if (g < 4) return a.gates[row * G + (size_t)g * H + j];
    if (g == 4) return a.cs[row * H + j];
    return r > 0 ? a.cs[(row - B) * H + j] : a.c0[((size_t)l * B + b) * H + j];
  };
  prefetch(T - 1);
  grid_barrier(bar, ++nbar);

  PHASE_START();
  for (int r = T - 1; r >= 0; --r) {
    cp_wait<0>();
    __syncthreads();
    // dpre_r's rows b0 .. b0 + RA for A, one copy group
    auto stage_dpre = [&](int b0) {
      const int nb = min(RA, B - b0);
#pragma unroll 1
      for (int e = tid; e < nb * H4; e += NT) {
        const int bb = dH4.q(e), m = e - bb * H4;
        cp16(X + (size_t)bb * ldh + 4 * m, a.dpre + ((size_t)r * B + b0 + bb) * H + 4 * m, true);
      }
      cp_commit();
    };
    stage_dpre(0);   // before the residuals of step r - 1, which A does not wait for
    if (r > 0) prefetch(r - 1);
    else cp_commit();
    // kept units of S_q of each structured site at row r, in ids order; own
    // ones flagged
    int kmax = 0;
    for (int i = 0; i < 4; ++i)
      if (a.sites[i].mode == 1) kmax = max(kmax, a.sites[i].k);
    if (kmax > 0)
      kept_lists<4>(
          kmax,
          [&](int i, int kk) {
            const SiteArg& st = a.sites[i];
            return st.mode == 1 && kk < st.k
                       ? __ldg(st.ids + (size_t)(st.rows == 1 ? 0 : r) * st.k + kk) : -1;
          },
          [&](int i, int u) {
            flg[(i * 2 + (r & 1)) * J + u - j0] = r;
            keep[((size_t)i * T + (a.sites[i].rows == 1 ? 0 : r)) * H + u] = 1.f;
          },
          [&](int i) { return a.sites[i].mode == 1; }, L, kl, ku, PJ, nkl, wsum);
    // ---- A: dctx, dcur = dpre_r @ w_comb^T at the own units ----
#pragma unroll 1
    for (int b0 = 0; b0 < B; b0 += RA) {
      const int nb = min(RA, B - b0);
      if (b0 == 0) {
        cp_wait<1>();
      } else {
        stage_dpre(b0);
        cp_wait<0>();
      }
      __syncthreads();
      const int bb = tid % RA, ks = tid / RA;
      float acc[2 * JMAX];
#pragma unroll
      for (int o = 0; o < 2 * JMAX; ++o) acc[o] = 0.f;
      if (bb < nb) {
        const float4* xr = reinterpret_cast<const float4*>(X + (size_t)bb * ldh);
#pragma unroll 2
        for (int m = ks; m < H4; m += KSA) {
          const float4 x = xr[m];
#pragma unroll
          for (int o = 0; o < 2 * JMAX; ++o) {
            if (o < 2 * J) {
              const float4 w = reinterpret_cast<const float4*>(wcs + (size_t)o * ldh)[m];
              acc[o] = fmaf(x.x, w.x, fmaf(x.y, w.y, fmaf(x.z, w.z, fmaf(x.w, w.w, acc[o]))));
            }
          }
        }
      }
#pragma unroll
      for (int o = 0; o < 2 * JMAX; ++o)
        if (o < 2 * J) redA[((size_t)ks * RA + bb) * 2 * J + o] = acc[o];
      __syncthreads();
#pragma unroll 1
      for (int e = tid; e < nb * 2 * J; e += NT) {
        const int eb = d2J.q(e), o = e - eb * 2 * J, q = o < J ? o : o - J, b = b0 + eb;
        if (q >= Jc) continue;
        float v = 0.f;
        for (int k2 = 0; k2 < KSA; ++k2) v += redA[((size_t)k2 * RA + eb) * 2 * J + o];
        if (o < J) a.dctx[((size_t)r * B + b) * H + j0 + q] = v;
        else a.dcur[(size_t)b * H + j0 + q] = v;
      }
      __syncthreads();
    }
    PHASE(0);
    grid_barrier(bar, ++nbar);
    PHASE(1);
    // the top layer's weight blocks arrive while B runs
    stage_block(wst, ldc, site_w(a.wf, a.us, a.ws, nl, nl, HG), L);
    stage_block(wst + (size_t)PJ * ldc, ldc, site_w(a.wf, a.us, a.ws, nl, 2 * nl - 1, HG), L);
    cp_commit();

    // ---- B: attention backward, one batch row a CTA ----
#pragma unroll 1
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      float* dct = X;
      float* cur = X + H;
      float* al = X + 2 * H;
      float* ds = al + S;
      for (int h = tid; h < H; h += NT) {
        dct[h] = __ldcg(a.dctx + ((size_t)r * B + b) * H + h);
        cur[h] = hs1[((size_t)r * B + b) * H + h];
      }
      for (int s = tid; s < S; s += NT) al[s] = a.alpha[((size_t)r * B + b) * S + s];
      __syncthreads();
      // dalpha[s] = dctx . enc_out[b, s] and, on the same loads, this step's
      // context ctx = alpha enc_out[b] (for dW_comb after the scan): a warp
      // 4 positions at once, its lanes along the quads of h (at most 4 a
      // lane, H <= 512; else a second pass), every load of a round issued
      // first; the warps' context sums added in warp order
      const float4* dct4 = reinterpret_cast<const float4*>(dct);
      const float4* eo4 = reinterpret_cast<const float4*>(a.eo) + (size_t)b * S * H4;
      float4* cxp = reinterpret_cast<float4*>(X + bwd_bvec(H, S));   // 8 x H4 partial contexts
#pragma unroll 1
      for (int mb = 0; mb < H4; mb += 128) {
        float4 cx[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cx[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
        for (int s0 = warp; s0 < S; s0 += 4 * (NT / 32)) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int m = mb + lane + 32 * i;
            if (m >= H4) break;
            float4 ev[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int s = s0 + k * (NT / 32);
              ev[k] = s < S ? __ldg(eo4 + (size_t)s * H4 + m) : make_float4(0.f, 0.f, 0.f, 0.f);
            }
            const float4 dv = dct4[m];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int s = s0 + k * (NT / 32);
              const float w = s < S ? al[s] : 0.f;
              d[k] = fmaf(dv.x, ev[k].x, fmaf(dv.y, ev[k].y, fmaf(dv.z, ev[k].z, fmaf(dv.w, ev[k].w, d[k]))));
              cx[i] = make_float4(fmaf(w, ev[k].x, cx[i].x), fmaf(w, ev[k].y, cx[i].y),
                                  fmaf(w, ev[k].z, cx[i].z), fmaf(w, ev[k].w, cx[i].w));
            }
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float v = warp_sum(d[k]);
            const int s = s0 + k * (NT / 32);
            if (lane == 0 && s < S) ds[s] = mb == 0 ? v : ds[s] + v;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = mb + lane + 32 * i;
          if (m < H4) cxp[warp * 128 + m - mb] = cx[i];
        }
        __syncthreads();
        for (int m = tid; m < H4 - mb && m < 128; m += NT) {
          float4 v = cxp[m];
          for (int w2 = 1; w2 < NT / 32; ++w2) {
            const float4 x = cxp[w2 * 128 + m];
            v = make_float4(v.x + x.x, v.y + x.y, v.z + x.z, v.w + x.w);
          }
          reinterpret_cast<float4*>(a.ctxs + ((size_t)r * B + b) * H)[mb + m] = v;
        }
        __syncthreads();
      }
      if (warp == 0) {
        float z = 0.f;
        for (int s = lane; s < S; s += 32) z += al[s] * ds[s];
        z = warp_sum(z);
        __syncwarp();
        for (int s = lane; s < S; s += 32) {
          const float v = al[s] * (ds[s] - z);
          ds[s] = v;
          a.dss[((size_t)r * B + b) * S + s] = v;
        }
      }
      __syncthreads();
      // dcur[b] += ds @ enc_proj[b]: thread (quad m, part) over the
      // positions part, part + np_, ...; the parts summed in order
      {
        const int np_ = NT / H4, m = tid % H4, part = tid / H4;
        float4* pb = reinterpret_cast<float4*>(X + bwd_bvec(H, S));
        if (part < np_) {
          const float4* ep4 = reinterpret_cast<const float4*>(a.ep) + (size_t)b * S * H4 + m;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
          for (int s0 = part; s0 < S; s0 += 13 * np_) {   // 13 loads in flight
            float4 e[13];
#pragma unroll
            for (int k = 0; k < 13; ++k) {
              const int s = s0 + k * np_;
              e[k] = s < S ? __ldg(ep4 + (size_t)s * H4) : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int k = 0; k < 13; ++k) {
              const int s = s0 + k * np_;
              const float w = s < S ? ds[s] : 0.f;
              v = make_float4(fmaf(w, e[k].x, v.x), fmaf(w, e[k].y, v.y), fmaf(w, e[k].z, v.z),
                              fmaf(w, e[k].w, v.w));
            }
          }
          pb[part * H4 + m] = v;
        }
        __syncthreads();
        if (tid < H4) {
          float4 v = __ldcg(reinterpret_cast<const float4*>(a.dcur + (size_t)b * H) + tid);
          for (int k2 = 0; k2 < np_; ++k2) {
            const float4 x = pb[k2 * H4 + tid];
            v = make_float4(v.x + x.x, v.y + x.y, v.z + x.z, v.w + x.w);
          }
          reinterpret_cast<float4*>(a.dcur + (size_t)b * H)[tid] = v;
        }
      }
      __syncthreads();
    }
    PHASE(2);
    grid_barrier(bar, ++nbar);
    PHASE(3);

    // ---- C: per layer, top down ----
#pragma unroll 1
    for (int l = nl - 1; l >= 0; --l) {
      const int sA = 1 + l, sB = l > 0 ? nl + l : 0;
      float* own = dgo + (size_t)(l & 1) * 4 * J * Bp;   // the layers alternate buffers
      const u64* inW = chan(CH_W1, r);
#pragma unroll 1
      for (int e = tid; e < B * Jc; e += NT) {
        const int q = dB.q(e), b = e - q * B, o = b * J + q, j = j0 + q;   // b fastest
        const bool act = r < lns[b];
        float dh = dhc[l * BJ + o];
        if (l == nl - 1) dh += __ldcg(a.dcur + (size_t)b * H + j);
        dh += uin[l * BJ + o];
        if (l == 0 && kept(nl + 1, r, q))
          dh += poll_sum(P, r + 1, [&](int c) { return inW + ((size_t)c * H + j) * B + b; }) *
                fct(nl + 1, r, b, j);
        const float dc_in = dcc[l * BJ + o];
        const float dh_c = act ? dh : 0.f, dc_c = act ? dc_in : 0.f;
        const float ig = sigm(resid(r, l, 0, b, q)), fg = sigm(resid(r, l, 1, b, q));
        const float gt = tanhf(resid(r, l, 2, b, q)), og = sigm(resid(r, l, 3, b, q));
        const float tc = tanhf(resid(r, l, 4, b, q)), c_prev = resid(r, l, 5, b, q);
        const float dc = dc_c + dh_c * og * (1.f - tc * tc);
        const float dg[4] = {dc * gt * ig * (1.f - ig), dc * c_prev * fg * (1.f - fg),
                             dc * ig * (1.f - gt * gt), dh_c * tc * og * (1.f - og)};
        float* dd = (l == 0 ? a.dgx0 : a.dgs) + ((size_t)r * B + b) * G + j;
#pragma unroll
        for (int g2 = 0; g2 < 4; ++g2) {
          __stcs(dd + (size_t)g2 * H, dg[g2]);   // read again only after the scan
          own[(size_t)(g2 * J + q) * Bp + b] = dg[g2];
        }
        dcc[l * BJ + o] = dc * fg + (act ? 0.f : dc_in);
        dhc[l * BJ + o] = act ? 0.f : dh;      // pass-through; BP arrives next step
        if (l == 0) pf[o] = act ? 0.f : a.dy[((size_t)r * B + b) * H + j] + dfo[o];
      }
      PHASE(4);
      // own dgates visible to the cluster, the layer's weight blocks staged
      cp_wait<0>();
      cg::this_cluster().sync();
      if (l > 0) {   // the upper layer's bias: 8 strided row sums, then their sum
#pragma unroll 1
        for (int e = tid; e < 32 * J; e += NT) {
          const int part = d4J.q(e), c = e - part * 4 * J;
          float v = 0.f;
          for (int b = part; b < B; b += 8) v += own[(size_t)c * Bp + b];
          dbp[e] = v;
        }
        __syncthreads();
#pragma unroll 1
        for (int e = tid; e < 4 * J; e += NT) {
          float v = 0.f;
          for (int k2 = 0; k2 < 8; ++k2) v += dbp[k2 * 4 * J + e];
          dbo[e] += v;
        }
      }
      PHASE(5);
      const float* wA = site_w(a.wf, a.us, a.ws, nl, sA, HG);
      const float* wB = site_w(a.wf, a.us, a.ws, nl, sB, HG);
      u64* outA = chan(l ? CH_U1 : CH_U0, r) + (size_t)L.c * B * H;
      u64* outB = chan(l ? CH_W1 : CH_F, r) + (size_t)L.c * B * H;
#pragma unroll 1
      for (int b0 = 0; b0 < B; b0 += BC) {
        const int nb = min(BC, B - b0);
        gather_cluster(X, ldc, own, Bp, L, b0, nb);
        __syncthreads();
        bp_partials<true>(X, ldc, wst, ldc, wA, kl + sA * PJ, nkl[sA], nb, L,
                          Publish{outA, ku + sA * PJ, B, b0, (unsigned)(r + 1)});
        bp_partials<true>(X, ldc, wst + (size_t)PJ * ldc, ldc, wB, kl + sB * PJ, nkl[sB], nb, L,
                          Publish{outB, ku + sB * PJ, B, b0, (unsigned)(r + 1)});
        __syncthreads();
      }
      if (l > 0) {   // layer 0's weight blocks arrive while its pointwise polls
        stage_block(wst, ldc, site_w(a.wf, a.us, a.ws, nl, 1, HG), L);
        stage_block(wst + (size_t)PJ * ldc, ldc, a.wf, L);
        cp_commit();
      }
      PHASE(6);
    }

    // ---- end of step: dfeed of the own units, dpre_{r-1}, and this step's
    // U_l partials (published before W_feed's) for step r - 1 and dh0 ----
#pragma unroll 1
    for (int e = tid; e < B * Jc; e += NT) {
      const int q = dB.q(e), b = e - q * B, o = b * J + q, j = j0 + q;
      const unsigned want[3] = {(unsigned)(r + 1), (unsigned)(r + 1), (unsigned)(r + 1)};
      const bool on[3] = {kept(0, r, q), kept(1, r, q), kept(2, r, q)};
      const u64* in[3] = {chan(CH_F, r), chan(CH_U0, r), chan(CH_U1, r)};
      float v[3];
      poll_sums<3>(P, want, on,
                   [&](int c, int x) { return in[c] + ((size_t)x * H + j) * B + b; }, v);
      dfo[o] = (on[0] ? v[0] * fct(0, r, b, j) : 0.f) + pf[o];
      if (r > 0) {
        const size_t x = ((size_t)(r - 1) * B + b) * H + j;
        const float ht = a.htil[x];
        a.dpre[x] = r - 1 < lns[b] ? (a.dy[x] + dfo[o]) * (1.f - ht * ht) : 0.f;
      }
      for (int l = 0; l < nl; ++l) uin[l * BJ + o] = on[1 + l] ? v[1 + l] * fct(1 + l, r, b, j) : 0.f;
    }
    grid_barrier(bar, ++nbar);
    PHASE(7);
  }

  // dh0 with step 0's partials of U_l, dc0, df0, db
#pragma unroll 1
  for (int e = tid; e < B * Jc; e += NT) {
    const int q = e / B, b = e - q * B, o = b * J + q, j = j0 + q;
    for (int l = 0; l < nl; ++l) {
      a.dh0[((size_t)l * B + b) * H + j] = dhc[l * BJ + o] + uin[l * BJ + o];
      a.dc0[((size_t)l * B + b) * H + j] = dcc[l * BJ + o];
    }
    a.df0[(size_t)b * H + j] = dfo[o];
  }
#pragma unroll 1
  for (int e = tid; e < 4 * J; e += NT) {
    const int g2 = e / J, q = e % J;
    if (q < Jc) a.dbs[(size_t)g2 * H + j0 + q] = dbo[e];
  }
  grid_barrier(bar, ++nbar);
  PHASE(8);

  // ---- the weight gradients, after the scan ----
  auto site_job = [&](int i, const float* x, const float* x0, int lag, const float* dg,
                      float* out) {
    const SiteArg& st = a.sites[i];
    const float* fac = st.mode == 1 ? keep + (size_t)i * T * H : st.mode == 2 ? st.mask : nullptr;
    return wg_job(x, x0, lag, dg, fac, st.mode, st.rows, st.mode == 0 ? 1.f : st.scale, out, T,
                  B, H, G);
  };
  const WgJob jobs[8] = {
      site_job(0, a.htil, a.f0, 1, a.dgx0, a.dwf),
      site_job(1, a.hs, a.h0, 1, a.dgx0, a.dus),
      site_job(2, hs1, a.h0 + (size_t)B * H, 1, a.dgs, a.dus + HG),
      site_job(nl + 1, a.hs, nullptr, 0, a.dgs, a.dws),
      // dW_comb = [ctx ; h]^T dpre over the pairs
      wg_job(a.ctxs, nullptr, 0, a.dpre, nullptr, 0, 1, 1.f, a.dwc, T, B, H, H),
      wg_job(hs1, nullptr, 0, a.dpre, nullptr, 0, 1, 1.f, a.dwc + (size_t)H * H, T, B, H, H),
      // d enc_out[b] = sum_t alpha_t[b]^T dctx_t[b]; d enc_proj[b] = sum_t
      // ds_t[b]^T h_t[b]
      WgJob{a.alpha, nullptr, a.dctx, nullptr, a.deo, 0, 0, 1, 1.f, S, H, T, 1,
            (long long)B * S, (long long)B * H, B, S, H, (long long)S * H},
      WgJob{a.dss, nullptr, hs1, nullptr, a.dep, 0, 0, 1, 1.f, S, H, T, 1,
            (long long)B * S, (long long)B * H, B, S, H, (long long)S * H}};
  wg_pass(smem, jobs, 8);
  PHASE(9);
}

}  // namespace

// Shapes (all float32, contiguous): gx0 (T, B, 4H); us (nl, H, 4H); ws
// (nl-1, H, 4H); bs (nl-1, 4H); wf (H, 4H); wc (2H, H); ep, eo (B, S, H);
// sb (B, S); h0, c0 (nl, B, H); f0 (B, H); lens (B,) int32 when ragged.
// Outputs htil (T, B, H), alpha (T, B, S), gates (nl, T, B, 4H), hs, cs
// (nl, T, B, H).
//
// K7's plan for (B, H, S) into *Q (CTAs a cluster), *J (units a CTA), *NS
// (ring stages) and *smem (bytes); 0, or a CUDA error where no plan fits
// (more than 4 units a CTA, shared memory past a CTA's, or clusters that
// cannot all be resident) or the occupancy query fails: the wrapper raises.
extern "C" int decoder_scan_fwd_tma_plan(int B, int H, int S, int* Q, int* J, int* NS,
                                         int* smem) {
  cudaGetLastError();
  *Q = *J = *NS = *smem = 0;
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int code = (int)cudaErrorInvalidValue;
  for (int j = (H + sms - 1) / sms; j <= TJMAX; ++j)
    for (int q = 4; q >= 2; q /= 2)
      for (int ns = 8; ns >= 4; ns /= 2) {
        const size_t bytes = tma_smem(B, H, S, j, ns);
        if (bytes > SMEM_MAX) continue;
        int mc = 0;
        const int err = max_clusters((const void*)dec_fwd_tma, q, TNT, bytes, &mc);
        if (err) return err;
        if (mc < ((H + j - 1) / j + q - 1) / q) {
          code = (int)cudaErrorCooperativeLaunchTooLarge;
          continue;
        }
        *Q = q;
        *J = j;
        *NS = ns;
        *smem = (int)bytes;
        return 0;
      }
  return code;
}

// K7: FwdArgs (shapes above) and the consumer layouts: pub[i] (2, B, kp[i])
// and rdx (B, 2 Hq) zeroed, inv[i] (rows, H) for structured sites, bar one zeroed word;
// (Q, J, NS) a plan of decoder_scan_fwd_tma_plan (the launch checks sizes
// only).
extern "C" int decoder_scan_fwd_tma_f32(const TmaArgs* in, void* stream) {
  cudaGetLastError();
  TmaArgs a = *in;
  const FwdArgs& f = a.f;
  if (f.T <= 0 || f.B <= 0) return 0;
  if (f.nl != NL || f.H <= 0 || f.S <= 0 || a.J < 1 || a.J > TJMAX || (a.Q != 2 && a.Q != 4) ||
      (a.NS != 4 && a.NS != 8))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 2 * NL; ++i) {
    const int need = f.sites[i].mode == 1 ? f.sites[i].k : f.H;
    if (a.kp[i] % 4 || a.kp[i] < std::max(need, 1)) return (int)cudaErrorInvalidValue;
  }
  const size_t smem = tma_smem(f.B, f.H, f.S, a.J, a.NS);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int Hq = rup(f.H, TKC);
  TmaMaps maps;
  for (int i = 0; i < 2 * NL; ++i)
    for (int s = 0; s < 2; ++s)
      if (!f32_map_2d(&maps.site[i][s], a.pub[i] + (size_t)s * f.B * a.kp[i], a.kp[i], f.B,
                      a.kp[i], TMB))
        return (int)cudaErrorInvalidValue;
  if (!f32_map_2d(&maps.rd, a.rdx, 2 * Hq, f.B, 2 * Hq, TMB)) return (int)cudaErrorInvalidValue;
  const int P = ((f.H + a.J - 1) / a.J + a.Q - 1) / a.Q;
  void* args[] = {&maps, &a};
  cudaError_t err = launch_clusters((const void*)dec_fwd_tma, P, a.Q, TNT, smem, args, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K8's plan for clusters of Q CTAs of J units: into *max_clu the clusters
// that can be resident at once (0 when no shared-memory plan fits), *smem
// its bytes, *pre whether it prefetches the residuals.
extern "C" int decoder_scan_bwd_clusters(int B, int H, int S, int Q, int J, int* max_clu,
                                         int* smem, int* pre) {
  cudaGetLastError();
  BwdArgs a = {};
  a.B = B;
  a.H = H;
  a.S = S;
  *pre = bwd_smem(a, Q, J, true) <= SMEM_MAX;
  const size_t bytes = bwd_smem(a, Q, J, *pre);
  *smem = (int)bytes;
  *max_clu = 0;
  if (bytes > SMEM_MAX || J > JMAX) return 0;
  return max_clusters((const void*)dec_bwd_kernel, Q, NT, bytes, max_clu);
}

// dy (T, B, H) = dL/dhtil; dhT, dcT (nl, B, H), dfT (B, H): the finals'
// cotangents; gates/hs/cs/htil/alpha from the forward. Outputs (written in
// full by the kernel): dgx0 (T, B, 4H), dus (nl, H, 4H), dws (nl-1, H, 4H),
// dbs (nl-1, 4H), dwf (H, 4H), dwc (2H, H), dep, deo (B, S, H), dh0, dc0
// (nl, B, H), df0 (B, H). Scratch as BwdArgs says; ring: the zeroed words of
// kernels/decoder_scan.py's plan of P clusters of Q CTAs of J units, which
// decoder_scan_bwd_clusters found resident (the wrapper's cached plan: the
// launch checks only its sizes).
extern "C" int decoder_scan_bwd_f32(const BwdArgs* in, void* stream) {
  cudaGetLastError();
  BwdArgs a = *in;
  if (a.T <= 0 || a.B <= 0) return 0;
  if (a.nl != NL || a.H <= 0 || a.S <= 0) return (int)cudaErrorInvalidValue;
  if (a.B > NT || a.H % 4 || a.Q < 1 || a.Q > 8 || a.J < 1 || a.J > JMAX)
    return (int)cudaErrorInvalidValue;
  int pre = bwd_smem(a, a.Q, a.J, true) <= SMEM_MAX;
  const size_t smem = bwd_smem(a, a.Q, a.J, pre);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int P = ((a.H + a.J - 1) / a.J + a.Q - 1) / a.Q;
  void* args[] = {&a, &pre};
  cudaError_t err = launch_clusters((const void*)dec_bwd_kernel, P, a.Q, NT, smem, args, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef DEC_PHASES
// Copies g_phase (1024 x 16 cycle counts) to host memory `out` and zeroes it.
extern "C" int decoder_scan_phases(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  if (err == cudaSuccess) {
    static unsigned long long zero[1024][16];
    err = cudaMemcpyToSymbol(g_phase, zero, sizeof(g_phase));
  }
  return (int)err;
}

extern "C" const char* decoder_scan_fwd_phase_names() {
  return "L0 stage wait,L0 product,L0 pointwise,L0 barrier,L1 stage wait,L1 product,"
         "L1 pointwise,L1 barrier,attention,attention barrier,readout stage wait,"
         "readout product,readout pointwise,readout barrier";
}

extern "C" const char* decoder_scan_phase_names() {
  return "A readout bwd,barrier after A,B attention bwd,barrier after B,"
         "C.1 polls + pointwise (per layer),cluster.sync + bias,gather + BP partials (per layer),"
         "dfeed + U partials + dpre + barrier (end of step),dh0 + barrier after the scan,"
         "WG after the scan";
}
#endif

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
