// Fused teacher-forced seq2seq decoder recurrence on Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernels of repro/kernels/decoder_scan.py:
//   K7  _pl_fwd_kernel via _pallas_fwd  -> dec_fwd_kernel
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
// Design, extending csrc/lstm_scan.cu: one persistent cooperative launch per
// direction (at most one CTA per SM, all co-resident), grid.sync() between
// dependent phases. The kernels take nl = 2 layers (the paper's NMT model).
// Gate phases are owned by hidden units: CTA owns J units and computes
// their 4 gate columns for all B rows; its columns of W_feed, U_l, W_l and
// of w_comb stay in shared memory (H=512: 144 KB), and the compact inputs
// are staged in 32-row chunks (one warp per row,
// its lanes along the compact units). Attention is owned by
// batch rows (encoder memory read through L2). The readout is owned by
// units again (columns of w_comb). Barriers per step: nl + 2.
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
// both entry points refuse a shape whose shared-memory plan does not fit
// (the wrapper raises). Data written by other
// CTAs in the same launch is read through L2 only (__ldcg, cp.async.cg).
// No fast-math: score_bias is -1e30 and the softmax subtracts its max.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "scan_exchange.cuh"

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
  float *htil, *alpha, *gates, *hs, *cs, *hcur, *ctx;
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

namespace {

constexpr int NT = 256;          // threads per CTA
constexpr int RB = 32;           // forward rows per staged chunk
constexpr int RBP = RB + 4;      // padded row stride of a staged chunk
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

// Stage rows [b0, b0+R) of drop(x) (x: (B, H), written in this launch, read
// through L2) for site st at time row t, compact, transposed: xs[kk*RP+bb].
// Structured sites gather their kept unit ids (into uid) and fold in the
// scale; dense ones multiply by mask * scale. Each warp owns R/8 rows and
// its lanes walk the compact columns, 16 loads in flight per thread and no
// integer division. Returns the compact width.
template <int R, int RP>
__device__ int stage_rows(float* xs, int* uid, const float* x, const SiteArg& st,
                          int t, int B, int H, int b0) {
  constexpr int NW = NT / 32;          // warps
  constexpr int RW = R / NW;           // rows per warp
  constexpr int KU = 16 / RW;          // columns per lane per batch
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mode = st.mode;
  const int KC = mode == 1 ? st.k : H;
  const int row = st.rows == 1 ? 0 : t;
  if (mode == 1)
    for (int kk = tid; kk < KC; kk += NT) uid[kk] = st.ids[(size_t)row * st.k + kk];
  __syncthreads();
  const float sc = mode == 0 ? 1.f : st.scale;
  const float* mrow = mode == 2 ? st.mask + (size_t)row * B * H : nullptr;
  for (int k0 = 0; k0 < KC; k0 += 32 * KU) {
    // all loads of a batch first, unconditional and branch-free (masked-off
    // lanes read x[0]), so that they are all in flight together
    float v[RW][KU];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int b = b0 + warp + i * NW;
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        const int kk = k0 + u * 32 + lane;
        const bool ok = b < B && kk < KC;
        const int col = ok ? (mode == 1 ? uid[kk] : kk) : 0;
        v[i][u] = __ldcg(x + (ok ? (size_t)b * H + col : 0));
      }
    }
    if (mode == 2) {
      float m[RW][KU];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const int b = b0 + warp + i * NW;
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          const int kk = k0 + u * 32 + lane;
          const bool ok = b < B && kk < KC;
          m[i][u] = __ldg(mrow + (ok ? (size_t)b * H + kk : 0));
        }
      }
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int u = 0; u < KU; ++u) v[i][u] *= m[i][u];
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const bool brow = b0 + warp + i * NW < B;
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        const int kk = k0 + u * 32 + lane;
        if (kk < KC) xs[(size_t)kk * RP + warp + i * NW] = brow ? v[i][u] * sc : 0.f;
      }
    }
  }
  __syncthreads();
  return KC;
}

// acc[bb] += sum over kk = s (mod S) of xs[kk*RP+bb] * w[row(kk)*ld + coff].
template <int R, int RP>
__device__ __forceinline__ void accum(float (&acc)[R], const float* xs, int KC,
                                      const int* uid, bool gath, const float* w,
                                      size_t ld, size_t coff, int s, int S) {
#pragma unroll 2
  for (int kk = s; kk < KC; kk += S) {
    const int row = gath ? uid[kk] : kk;
    const float wv = w[(size_t)row * ld + coff];
    const float4* xv = reinterpret_cast<const float4*>(xs + (size_t)kk * RP);
#pragma unroll
    for (int v = 0; v < R / 4; ++v) {
      const float4 x4 = xv[v];
      acc[4 * v] = fmaf(x4.x, wv, acc[4 * v]);
      acc[4 * v + 1] = fmaf(x4.y, wv, acc[4 * v + 1]);
      acc[4 * v + 2] = fmaf(x4.z, wv, acc[4 * v + 2]);
      acc[4 * v + 3] = fmaf(x4.w, wv, acc[4 * v + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// K7: forward
// ---------------------------------------------------------------------------

__host__ __device__ size_t fwd_stage(int H, int S) {
  size_t n = (size_t)H * RBP;
  if ((size_t)NT * RB > n) n = (size_t)NT * RB;
  if ((size_t)H + S > n) n = (size_t)H + S;
  return al4(n);
}

size_t fwd_smem(const FwdArgs& a, int J) {
  const size_t C4 = 4 * (size_t)J;
  const size_t n = 2 * (size_t)NL * a.H * C4 + al4(2 * (size_t)a.H * J) +
                   fwd_stage(a.H, a.S) + al4((size_t)NL * a.B * J);
  return sizeof(float) * n + sizeof(int) * (size_t)a.H;
}

// The CTA's columns of every in-scan weight and of w_comb stay resident.
__global__ void __launch_bounds__(NT) dec_fwd_kernel(FwdArgs a, int J) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = a.T, B = a.B, H = a.H, S = a.S, G = 4 * H;
  constexpr int nl = NL;
  const size_t HG = (size_t)H * G;
  const int j0 = blockIdx.x * J;
  const int Jc = min(J, H - j0);
  const int C4 = 4 * J;
  const int tid = threadIdx.x;
  float* Wsm = smem;                                          // 2nl x H x C4
  float* Wcs = Wsm + 2 * (size_t)nl * H * C4;                 // 2H x J
  float* xs = Wcs + al4(2 * (size_t)H * J);                   // staging / partials
  float* cst = xs + fwd_stage(H, S);                          // nl x B x J cell state
  int* uid = reinterpret_cast<int*>(cst + al4((size_t)nl * B * J));  // H

  for (int e = tid; e < nl * B * J; e += NT) {
    const int l = e / (B * J), b = (e / J) % B, q = e % J;
    if (q < Jc) cst[e] = a.c0[((size_t)l * B + b) * H + j0 + q];
  }
  for (int i = 0; i < 2 * nl; ++i) {
    const float* w = site_w(a.wf, a.us, a.ws, nl, i, HG);
    for (int e = tid; e < H * C4; e += NT) {
      const int row = e / C4, c = e % C4, q = c % J;
      Wsm[(size_t)i * H * C4 + e] = q < Jc ? w[(size_t)row * G + (c / J) * H + j0 + q] : 0.f;
    }
  }
  for (int e = tid; e < 2 * H * J; e += NT) {
    const int row = e / J, q = e % J;
    Wcs[e] = q < Jc ? a.wc[(size_t)row * H + j0 + q] : 0.f;
  }
  __syncthreads();

  // gate phases: column c = g*J + q of the owned 4J, K-split s
  const int cg_ = tid % C4, sg = tid / C4, SG = NT / C4;
  const bool wg = sg < SG && cg_ % J < Jc;
  // readout phase: column q of the owned J, K-split s
  const int cr = tid % J, sr = tid / J, SR = NT / J;
  const bool wr = sr < SR && cr < Jc;
  const SiteArg off{0, 0, 1, 1.f, nullptr, nullptr};
  const int warp = tid >> 5, lane = tid & 31;

  FPHASE_START();
  for (int t = 0; t < T; ++t) {
    const float* feed_prev = t == 0 ? a.f0 : a.htil + (size_t)(t - 1) * B * H;
    // ---- LSTM layers ----
    for (int l = 0; l < nl; ++l) {
      const float* hprev = t == 0 ? a.h0 + (size_t)l * B * H
                                  : a.hs + ((size_t)l * T + t - 1) * B * H;
      const int siteA = l == 0 ? 0 : nl + l, siteB = 1 + l;
      const float* xA = l == 0 ? feed_prev : a.hcur + (size_t)(l - 1) * B * H;
      for (int b0 = 0; b0 < B; b0 += RB) {
        float acc[RB];
#pragma unroll
        for (int bb = 0; bb < RB; ++bb) acc[bb] = 0.f;
        for (int p = 0; p < 2; ++p) {
          const int site = p == 0 ? siteA : siteB;
          const SiteArg& st = a.sites[site];
          const int KC = stage_rows<RB, RBP>(xs, uid, p == 0 ? xA : hprev, st, t, B, H, b0);
          FPHASE(4 * l);
          if (wg)
            accum<RB, RBP>(acc, xs, KC, uid, st.mode == 1, Wsm + (size_t)site * H * C4, C4,
                           cg_, sg, SG);
          __syncthreads();
          FPHASE(4 * l + 1);
        }
        if (sg < SG) {
#pragma unroll
          for (int bb = 0; bb < RB; ++bb) xs[((size_t)sg * RB + bb) * C4 + cg_] = acc[bb];
        }
        __syncthreads();
        for (int e = tid; e < RB * J; e += NT) {
          const int bb = e / J, q = e % J, b = b0 + bb;
          if (b >= B || q >= Jc) continue;
          const int j = j0 + q;
          float sum[4] = {0.f, 0.f, 0.f, 0.f};
          for (int s2 = 0; s2 < SG; ++s2) {
            const float* pr = xs + ((size_t)s2 * RB + bb) * C4 + q;
#pragma unroll
            for (int g2 = 0; g2 < 4; ++g2) sum[g2] += pr[g2 * J];
          }
          float gv[4];
#pragma unroll
          for (int g2 = 0; g2 < 4; ++g2) {
            const float base = l == 0 ? __ldg(a.gx0 + ((size_t)t * B + b) * G + (size_t)g2 * H + j)
                                      : __ldg(a.bs + (size_t)(l - 1) * G + (size_t)g2 * H + j);
            gv[g2] = base + sum[g2];
          }
          const float ig = sigm(gv[0]), fg = sigm(gv[1]), gt = tanhf(gv[2]), og = sigm(gv[3]);
          float* cp = cst + ((size_t)l * B + b) * J + q;
          const float c_prev = *cp;
          float c_new = fg * c_prev + ig * gt;
          float h_new = og * tanhf(c_new);
          const size_t gofs = (((size_t)l * T + t) * B + b) * G + j;
#pragma unroll
          for (int g2 = 0; g2 < 4; ++g2) a.gates[gofs + (size_t)g2 * H] = gv[g2];
          a.hcur[((size_t)l * B + b) * H + j] = h_new;       // in-step (unfrozen) value
          if (a.ragged && t >= a.lens[b]) {                  // frozen row: carry t-1
            h_new = __ldcg(hprev + (size_t)b * H + j);
            c_new = c_prev;
          }
          *cp = c_new;
          const size_t hofs = (((size_t)l * T + t) * B + b) * H + j;
          a.hs[hofs] = h_new;
          a.cs[hofs] = c_new;
        }
        __syncthreads();
        FPHASE(4 * l + 2);
      }
      __threadfence();
      grid.sync();
      FPHASE(4 * l + 3);
    }
    // ---- attention: one batch row per CTA ----
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      float* cur = xs;
      float* sc = xs + H;
      for (int h = tid; h < H; h += NT) cur[h] = __ldcg(a.hcur + ((size_t)(nl - 1) * B + b) * H + h);
      __syncthreads();
      for (int s = warp; s < S; s += NT / 32) {
        const float* e = a.ep + ((size_t)b * S + s) * H;
        float d = 0.f;
        for (int h = lane; h < H; h += 32) d = fmaf(cur[h], __ldg(e + h), d);
        d = warp_sum(d);
        if (lane == 0) sc[s] = d + __ldg(a.sb + (size_t)b * S + s);
      }
      __syncthreads();
      FPHASE(8);
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
      FPHASE(9);
      for (int h = tid; h < H; h += NT) {
        float v = 0.f;
        for (int s = 0; s < S; ++s) v = fmaf(sc[s], __ldg(a.eo + ((size_t)b * S + s) * H + h), v);
        a.ctx[(size_t)b * H + h] = v;
      }
      __syncthreads();
      FPHASE(10);
    }
    __threadfence();
    grid.sync();
    FPHASE(11);
    // ---- readout h~ = tanh([ctx ; h_top] @ w_comb), owned by columns ----
    for (int b0 = 0; b0 < B; b0 += RB) {
      float acc[RB];
#pragma unroll
      for (int bb = 0; bb < RB; ++bb) acc[bb] = 0.f;
      for (int p = 0; p < 2; ++p) {
        const float* x = p == 0 ? a.ctx : a.hcur + (size_t)(nl - 1) * B * H;
        const int KC = stage_rows<RB, RBP>(xs, uid, x, off, t, B, H, b0);
        FPHASE(12);
        if (wr) accum<RB, RBP>(acc, xs, KC, uid, false, Wcs + (size_t)p * H * J, J, cr, sr, SR);
        __syncthreads();
        FPHASE(13);
      }
      if (sr < SR) {
#pragma unroll
        for (int bb = 0; bb < RB; ++bb) xs[((size_t)sr * RB + bb) * J + cr] = acc[bb];
      }
      __syncthreads();
      for (int e = tid; e < RB * J; e += NT) {
        const int bb = e / J, q = e % J, b = b0 + bb;
        if (b >= B || q >= Jc) continue;
        const int j = j0 + q;
        float sum = 0.f;
        for (int s2 = 0; s2 < SR; ++s2) sum += xs[((size_t)s2 * RB + bb) * J + q];
        float v = tanhf(sum);
        if (a.ragged && t >= a.lens[b]) v = __ldcg(feed_prev + (size_t)b * H + j);
        a.htil[((size_t)t * B + b) * H + j] = v;
      }
      __syncthreads();
      FPHASE(13);
    }
    __threadfence();
    grid.sync();
    FPHASE(14);
  }
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

// Grid size and shared-memory opt-in; a CUDA error code (0 = launchable).
int plan_launch(const void* kernel, size_t smem, int H, int J, int* grid) {
  int dev = 0, sms = 0, coop = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
  if (err != cudaSuccess) return (int)err;
  *grid = (H + J - 1) / J;
  if (per_sm * sms < *grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  return 0;
}

int units_per_cta(int H) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (H + sms - 1) / sms;
}

}  // namespace

// Shapes (all float32, contiguous): gx0 (T, B, 4H); us (nl, H, 4H); ws
// (nl-1, H, 4H); bs (nl-1, 4H); wf (H, 4H); wc (2H, H); ep, eo (B, S, H);
// sb (B, S); h0, c0 (nl, B, H); f0 (B, H); lens (B,) int32 when ragged.
// Outputs htil (T, B, H), alpha (T, B, S), gates (nl, T, B, 4H), hs, cs
// (nl, T, B, H); hcur (nl, B, H) and ctx (B, H) are scratch.
extern "C" int decoder_scan_fwd_f32(const FwdArgs* in, void* stream) {
  cudaGetLastError();
  FwdArgs a = *in;
  if (a.T <= 0 || a.B <= 0) return 0;
  if (a.nl != NL || a.H <= 0 || a.S <= 0) return (int)cudaErrorInvalidValue;
  int J = units_per_cta(a.H);
  if (4 * J > NT) return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)dec_fwd_kernel;
  const size_t smem = fwd_smem(a, J);   // plan_launch refuses it past SMEM_MAX
  int grid = 0;
  int code = plan_launch(kernel, smem, a.H, J, &grid);
  if (code) return code;
  void* args[] = {&a, &J};
  cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(NT), args, smem,
                                                (cudaStream_t)stream);
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
  return "L0 stage,L0 product,L0 pointwise,L0 grid.sync,L1 stage,L1 product,L1 pointwise,"
         "L1 grid.sync,attention scores,softmax,ctx,attention grid.sync,readout stage,"
         "readout product + tanh,readout grid.sync";
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
