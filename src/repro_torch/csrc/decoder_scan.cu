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
// Backward (reverse time, nl + 3 barriers per step): the readout backward is
// owned by units (dctx/dcur columns, dW_comb rows), the attention backward
// by rows (d enc_proj[b], d enc_out[b] accumulated in global memory by their
// only writer), then per layer the pointwise backward by units, and after a
// barrier that makes every dgates column visible, each CTA computes BP and
// WG for its own rows only (as K4), so dU, dW and dW_feed need no atomics;
// dgates and the own weight rows are streamed through shared memory in
// column chunks with cp.async, WG keeps all 2 x J own rows of a column in
// registers and BP register-tiles (2 rows x J units) with 16-byte loads.
// A dropped unit's row gets x = 0 in WG and a factor 0 on its BP output,
// which keeps both branch-free; its CTA's rows of the four weight
// gradients accumulate in shared memory. The backward takes J <= 4 units
// per CTA (H <= 528 on 132 SMs), B <= 256 and H % 4 == 0, and both entry
// points refuse a shape whose shared-memory plan does not fit (the wrapper
// raises). Data written by other
// CTAs in the same launch is read through L2 only (__ldcg, cp.async.cg).
// No fast-math: score_bias is -1e30 and the softmax subtracts its max.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

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
  float *dgs, *dpre, *dctx, *dcur;   // scratch
};

namespace {

constexpr int NT = 256;          // threads per CTA
constexpr int RB = 32;           // forward rows per staged chunk
constexpr int RBP = RB + 4;      // padded row stride of a staged chunk
constexpr int RBA = 16;          // backward (readout) rows per staged chunk
constexpr int RBAP = RBA + 4;
constexpr int JP = 4;            // most hidden units a CTA owns (backward tiles)
constexpr int HPT = 4;           // most hidden units per thread (backward, H <= 4 NT)
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

__device__ __forceinline__ void cp_async16(float* smem_dst, const float* gmem_src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
          if (wg)
            accum<RB, RBP>(acc, xs, KC, uid, st.mode == 1, Wsm + (size_t)site * H * C4, C4,
                           cg_, sg, SG);
          __syncthreads();
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
      }
      __threadfence();
      grid.sync();
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
      for (int h = tid; h < H; h += NT) {
        float v = 0.f;
        for (int s = 0; s < S; ++s) v = fmaf(sc[s], __ldg(a.eo + ((size_t)b * S + s) * H + h), v);
        a.ctx[(size_t)b * H + h] = v;
      }
      __syncthreads();
    }
    __threadfence();
    grid.sync();
    // ---- readout h~ = tanh([ctx ; h_top] @ w_comb), owned by columns ----
    for (int b0 = 0; b0 < B; b0 += RB) {
      float acc[RB];
#pragma unroll
      for (int bb = 0; bb < RB; ++bb) acc[bb] = 0.f;
      for (int p = 0; p < 2; ++p) {
        const float* x = p == 0 ? a.ctx : a.hcur + (size_t)(nl - 1) * B * H;
        const int KC = stage_rows<RB, RBP>(xs, uid, x, off, t, B, H, b0);
        if (wr) accum<RB, RBP>(acc, xs, KC, uid, false, Wcs + (size_t)p * H * J, J, cr, sr, SR);
        __syncthreads();
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
    }
    __threadfence();
    grid.sync();
  }
}

// ---------------------------------------------------------------------------
// K8: backward
// ---------------------------------------------------------------------------

__host__ __device__ size_t bwd_region(const BwdArgs& a, int ch) {
  size_t n = 2 * (size_t)a.B * (ch + 4);     // two dgates chunk buffers
  const size_t cand[4] = {(size_t)a.H * RBAP, (size_t)NT * RBA, 2 * (size_t)a.H + 2 * a.S,
                          (size_t)NT * 2 * JP};
  for (size_t c : cand) n = c > n ? c : n;
  return al4(n);
}

size_t bwd_smem(const BwdArgs& a, int J, int ch) {
  const size_t BJ = (size_t)a.B * J, G = 4 * (size_t)a.H;
  size_t n = 2 * (size_t)NL * J * G;
  n += bwd_region(a, ch) + 4 * JP * (size_t)(ch + 4) + 2 * JP * (size_t)a.B;
  n += al4(3 * NL * BJ + 2 * BJ + 4 * BJ + 4 * (size_t)(NL - 1) * J + 2 * BJ);
  return sizeof(float) * n + sizeof(int) * 2 * (size_t)J;
}

// The CTA's rows of the 2nl weight gradients accumulate in shared memory
// (rows are owned, so no atomics) and are written out once at the end.
__global__ void __launch_bounds__(NT) dec_bwd_kernel(BwdArgs a, int J, int ch) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = a.T, B = a.B, H = a.H, S = a.S, G = 4 * H;
  constexpr int nl = NL;
  const size_t HG = (size_t)H * G;
  const int j0 = blockIdx.x * J;
  const int Jc = min(J, H - j0);
  const int BJ = B * J;
  const int chp = ch + 4;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  float* dWr = smem;                                              // 2nl x J x G
  float* R = dWr + 2 * (size_t)nl * J * G;                        // shared region
  float* wr = R + bwd_region(a, ch);                              // 2 x 2 x JP x chp
  float* xw = wr + 4 * JP * (size_t)chp;                          // 2 x B x JP
  float* dhc = xw + 2 * JP * (size_t)B;                           // nl x B x J
  float* dhin = dhc + nl * BJ;                                    // nl x B x J
  float* dcc = dhin + nl * BJ;                                    // nl x B x J
  float* dfo = dcc + nl * BJ;                                     // B x J
  float* pf = dfo + BJ;                                           // B x J
  float* dgo = pf + BJ;                                           // B x 4J
  float* dbo = dgo + 4 * BJ;                                      // (nl-1) x 4J
  float* catv = dbo + 4 * (nl - 1) * J;                           // B x 2J
  int* flag = reinterpret_cast<int*>(catv + 2 * BJ);             // 2 x J
  const SiteArg off{0, 0, 1, 1.f, nullptr, nullptr};

  auto drow = [&](int i, int q) -> float* { return dWr + ((size_t)i * J + q) * G; };
  auto act_of = [&](int r, int b) { return !a.ragged || r < a.lens[b]; };

  // ---- init: carries from the final cotangents, zeroed accumulators ----
  for (int e = tid; e < BJ; e += NT) {
    const int b = e / J, q = e % J;
    const bool ok = q < Jc;
    const int j = j0 + q;
    for (int l = 0; l < nl; ++l) {
      dhc[l * BJ + e] = ok ? a.dhT[((size_t)l * B + b) * H + j] : 0.f;
      dcc[l * BJ + e] = ok ? a.dcT[((size_t)l * B + b) * H + j] : 0.f;
      dhin[l * BJ + e] = 0.f;
    }
    dfo[e] = ok ? a.dfT[(size_t)b * H + j] : 0.f;
    if (ok) {
      const size_t o = ((size_t)(T - 1) * B + b) * H + j;
      const float ht = a.htil[o];
      a.dpre[(size_t)b * H + j] = act_of(T - 1, b) ? (a.dy[o] + dfo[e]) * (1.f - ht * ht) : 0.f;
    }
  }
  for (int e = tid; e < 4 * JP * chp; e += NT) wr[e] = 0.f;
  for (int e = tid; e < 2 * JP * B; e += NT) xw[e] = 0.f;
  for (int i = 0; i < 2 * nl; ++i)
    for (int e = tid; e < Jc * G; e += NT) drow(i, e / G)[e % G] = 0.f;
  for (int e = tid; e < 4 * (nl - 1) * J; e += NT) dbo[e] = 0.f;
  for (int e = tid; e < 2 * Jc * H; e += NT) {
    const int i = e / H, h = e % H, q = i % Jc;
    a.dwc[(size_t)((i < Jc ? 0 : H) + j0 + q) * H + h] = 0.f;
  }
  for (int b = blockIdx.x; b < B; b += gridDim.x)
    for (int e = tid; e < S * H; e += NT) {
      a.dep[(size_t)b * S * H + e] = 0.f;
      a.deo[(size_t)b * S * H + e] = 0.f;
    }
  __threadfence();
  grid.sync();

  const int NC = 2 * J, SA = NT / NC;
  const int ca = tid % NC, sa_ = tid / NC, qa = ca % J;
  const bool wa = sa_ < SA && qa < Jc;
  const size_t rowa = (ca < J ? 0 : H) + j0 + (qa < Jc ? qa : 0);
  // BP tiles of C.2: (site p, rows bp and bp + nbp) x all JP own units
  const int nbp = (B + 1) / 2, tiles = 2 * nbp, KS = NT / tiles;
  const int tile = tid % tiles, ks = tid / tiles;
  const bool bp_ok = ks < KS;
  const int tp = tile / nbp, tb0 = tile % nbp, tb1 = tb0 + nbp;

  for (int r = T - 1; r >= 0; --r) {
    // ---- phase A: readout backward, owned by units (dctx, dcur cols; dW_comb rows) ----
    // [ctx ; h_top] at the own units: ctx[b, j] = sum_s alpha[b, s] eo[b, s, j]
    // recomputed with (row, source slice) per thread, then summed over slices
    {
      const int SC = NT / B, b = tid % B, sc = tid / B;
      float part[JP] = {0.f, 0.f, 0.f, 0.f};
      if (sc < SC) {
        const float* al = a.alpha + ((size_t)r * B + b) * S;
        const float* eo = a.eo + (size_t)b * S * H + j0;
        int qo[JP];                  // in-range column offsets, no branches
#pragma unroll
        for (int q = 0; q < JP; ++q) qo[q] = min(q, Jc - 1);
#pragma unroll 4
        for (int s = sc; s < S; s += SC) {
          const float w = __ldg(al + s);
#pragma unroll
          for (int q = 0; q < JP; ++q)
            part[q] = fmaf(w, __ldg(eo + (size_t)s * H + qo[q]), part[q]);
        }
#pragma unroll
        for (int q = 0; q < JP; ++q) R[((size_t)sc * B + b) * JP + q] = part[q];
      }
      __syncthreads();
      for (int e = tid; e < B * NC; e += NT) {
        const int bb = e / NC, c = e % NC, q = c % J;
        float v = 0.f;
        if (q < Jc) {
          if (c < J) {
            for (int s2 = 0; s2 < SC; ++s2) v += R[((size_t)s2 * B + bb) * JP + q];
          } else {
            v = a.hs[(((size_t)(nl - 1) * T + r) * B + bb) * H + j0 + q];
          }
        }
        catv[e] = v;
      }
      __syncthreads();
    }
    // dW_comb[own rows i, h] accumulates in registers over the row chunks:
    // h = tid + k*NT (k < HPT), i < 2J
    float dwa[HPT][2 * JP];
#pragma unroll
    for (int k = 0; k < HPT; ++k)
#pragma unroll
      for (int i = 0; i < 2 * JP; ++i) dwa[k][i] = 0.f;
    for (int b0 = 0; b0 < B; b0 += RBA) {
      float acc[RBA];
#pragma unroll
      for (int bb = 0; bb < RBA; ++bb) acc[bb] = 0.f;
      stage_rows<RBA, RBAP>(R, flag, a.dpre, off, r, B, H, b0);
      if (wa) accum<RBA, RBAP>(acc, R, H, nullptr, false, a.wc, 1, rowa * H, sa_, SA);
      const int nb = min(RBA, B - b0);
#pragma unroll
      for (int k = 0; k < HPT; ++k) {
        const int h = tid + k * NT;
        if (h >= H) continue;
        for (int bb = 0; bb < nb; ++bb) {
          const float d = R[(size_t)h * RBAP + bb];
          const float* cv = catv + (b0 + bb) * NC;
#pragma unroll
          for (int i = 0; i < 2 * JP; ++i)
            if (i < NC) dwa[k][i] = fmaf(cv[i], d, dwa[k][i]);
        }
      }
      __syncthreads();
      if (sa_ < SA) {
#pragma unroll
        for (int bb = 0; bb < RBA; ++bb) R[((size_t)sa_ * RBA + bb) * NC + ca] = acc[bb];
      }
      __syncthreads();
      for (int e = tid; e < RBA * NC; e += NT) {
        const int bb = e / NC, c = e % NC, q = c % J, b = b0 + bb;
        if (b >= B || q >= Jc) continue;
        float v = 0.f;
        for (int s2 = 0; s2 < SA; ++s2) v += R[((size_t)s2 * RBA + bb) * NC + c];
        (c < J ? a.dctx : a.dcur)[(size_t)b * H + j0 + q] = v;
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < HPT; ++k) {
      const int h = tid + k * NT;
      if (h >= H) continue;
#pragma unroll
      for (int i = 0; i < 2 * JP; ++i) {
        const int qi = i % J;
        if (i < NC && qi < Jc) a.dwc[(size_t)((i < J ? 0 : H) + j0 + qi) * H + h] += dwa[k][i];
      }
    }
    __threadfence();
    grid.sync();

    // ---- phase B: attention backward, one batch row per CTA ----
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      float* dct = R;
      float* cur = R + H;
      float* al = R + 2 * H;
      float* ds = al + S;
      for (int h = tid; h < H; h += NT) {
        dct[h] = __ldcg(a.dctx + (size_t)b * H + h);
        cur[h] = a.hs[(((size_t)(nl - 1) * T + r) * B + b) * H + h];
      }
      for (int s = tid; s < S; s += NT) al[s] = a.alpha[((size_t)r * B + b) * S + s];
      __syncthreads();
      for (int s = warp; s < S; s += NT / 32) {
        const float* e = a.eo + ((size_t)b * S + s) * H;
        float d0 = 0.f, d1 = 0.f;
        int h = lane;
        for (; h + 32 < H; h += 64) {
          d0 = fmaf(dct[h], __ldg(e + h), d0);
          d1 = fmaf(dct[h + 32], __ldg(e + h + 32), d1);
        }
        if (h < H) d0 = fmaf(dct[h], __ldg(e + h), d0);
        const float d = warp_sum(d0 + d1);
        if (lane == 0) ds[s] = d;
      }
      __syncthreads();
      if (warp == 0) {
        float z = 0.f;
        for (int s = lane; s < S; s += 32) z += al[s] * ds[s];
        z = warp_sum(z);
        __syncwarp();
        for (int s = lane; s < S; s += 32) ds[s] = al[s] * (ds[s] - z);
      }
      __syncthreads();
      for (int h = tid; h < H; h += NT) {
        float v = __ldcg(a.dcur + (size_t)b * H + h);
        const float* ep = a.ep + (size_t)b * S * H + h;
#pragma unroll 10
        for (int s = 0; s < S; ++s) v = fmaf(ds[s], __ldg(ep + (size_t)s * H), v);
        a.dcur[(size_t)b * H + h] = v;
      }
      // d enc_out[b] += alpha (x) dctx, d enc_proj[b] += dscores (x) h (H % 4 == 0)
      float4* deo4 = reinterpret_cast<float4*>(a.deo + (size_t)b * S * H);
      float4* dep4 = reinterpret_cast<float4*>(a.dep + (size_t)b * S * H);
      const int H4 = H / 4;
#pragma unroll 4
      for (int e = tid; e < S * H4; e += NT) {
        const int s = e / H4, h = (e % H4) * 4;
        float4 o = __ldcg(deo4 + e), pp = __ldcg(dep4 + e);
        const float as = al[s], dss = ds[s];
        o.x = fmaf(as, dct[h], o.x);
        o.y = fmaf(as, dct[h + 1], o.y);
        o.z = fmaf(as, dct[h + 2], o.z);
        o.w = fmaf(as, dct[h + 3], o.w);
        pp.x = fmaf(dss, cur[h], pp.x);
        pp.y = fmaf(dss, cur[h + 1], pp.y);
        pp.z = fmaf(dss, cur[h + 2], pp.z);
        pp.w = fmaf(dss, cur[h + 3], pp.w);
        deo4[e] = o;
        dep4[e] = pp;
      }
      __syncthreads();
    }
    __threadfence();
    grid.sync();

    // ---- per layer, top down ----
    for (int l = nl - 1; l >= 0; --l) {
      const int sA = 1 + l, sB = l > 0 ? nl + l : 0;
      const SiteArg& stA = a.sites[sA];
      const SiteArg& stB = a.sites[sB];
      const int rowA = stA.rows == 1 ? 0 : r, rowB = stB.rows == 1 ? 0 : r;
      // C.1: pointwise backward of the own units, all rows
      for (int q = tid; q < 2 * J; q += NT) {
        const SiteArg& st = q < J ? stA : stB;
        flag[q] = st.mode == 1 ? 0 : (q % J < Jc);
      }
      __syncthreads();
      for (int p = 0; p < 2; ++p) {
        const SiteArg& st = p == 0 ? stA : stB;
        const int row = p == 0 ? rowA : rowB;
        if (st.mode == 1)
          for (int kk = tid; kk < st.k; kk += NT) {
            const int u = st.ids[(size_t)row * st.k + kk];
            if (u >= j0 && u < j0 + Jc) flag[p * J + u - j0] = 1;
          }
      }
      __syncthreads();
      float* dgdst = l == 0 ? a.dgx0 + (size_t)r * B * G : a.dgs + (size_t)(l - 1) * B * G;
      for (int e = tid; e < BJ; e += NT) {
        const int b = e / J, q = e % J;
        if (q >= Jc) {
          for (int g2 = 0; g2 < 4; ++g2) dgo[b * 4 * J + g2 * J + q] = 0.f;
          continue;
        }
        const int j = j0 + q;
        const bool act = act_of(r, b);
        const float dh = dhc[l * BJ + e] +
                         (l == nl - 1 ? __ldcg(a.dcur + (size_t)b * H + j) : dhin[l * BJ + e]);
        const float dc_in = dcc[l * BJ + e];
        const float dh_c = act ? dh : 0.f, dc_c = act ? dc_in : 0.f;
        const size_t gofs = (((size_t)l * T + r) * B + b) * G + j;
        const size_t hofs = (((size_t)l * T + r) * B + b) * H + j;
        const float ig = sigm(a.gates[gofs]), fg = sigm(a.gates[gofs + H]);
        const float gt = tanhf(a.gates[gofs + 2 * (size_t)H]), og = sigm(a.gates[gofs + 3 * (size_t)H]);
        const float cc = a.cs[hofs];
        const float c_prev = r > 0 ? a.cs[hofs - (size_t)B * H] : a.c0[((size_t)l * B + b) * H + j];
        const float tc = tanhf(cc);
        const float dc = dc_c + dh_c * og * (1.f - tc * tc);
        float dg[4];
        dg[0] = dc * gt * ig * (1.f - ig);
        dg[1] = dc * c_prev * fg * (1.f - fg);
        dg[2] = dc * ig * (1.f - gt * gt);
        dg[3] = dh_c * tc * og * (1.f - og);
        float* dd = dgdst + (size_t)b * G + j;
#pragma unroll
        for (int g2 = 0; g2 < 4; ++g2) {
          dd[(size_t)g2 * H] = dg[g2];
          dgo[b * 4 * J + g2 * J + q] = dg[g2];
        }
        dcc[l * BJ + e] = dc * fg + (act ? 0.f : dc_in);
        dhc[l * BJ + e] = act ? 0.f : dh;      // pass-through; BP is added in C.2
        // WG inputs of the two sites, dropout folded in: structured x*scale
        // on kept units and 0 elsewhere, dense x*mask*scale, off x
        float xa = r > 0 ? a.hs[hofs - (size_t)B * H] : a.h0[((size_t)l * B + b) * H + j];
        float xb;
        if (l > 0) xb = a.hs[(((size_t)(l - 1) * T + r) * B + b) * H + j];
        else xb = r > 0 ? a.htil[((size_t)(r - 1) * B + b) * H + j] : a.f0[(size_t)b * H + j];
        xa *= stA.mode == 1 ? (flag[q] ? stA.scale : 0.f)
            : stA.mode == 2 ? stA.mask[((size_t)rowA * B + b) * H + j] * stA.scale : 1.f;
        xb *= stB.mode == 1 ? (flag[J + q] ? stB.scale : 0.f)
            : stB.mode == 2 ? stB.mask[((size_t)rowB * B + b) * H + j] * stB.scale : 1.f;
        xw[(size_t)b * JP + q] = xa;
        xw[((size_t)B + b) * JP + q] = xb;
        if (l == 0) pf[e] = act ? 0.f : a.dy[((size_t)r * B + b) * H + j] + dfo[e];
      }
      __syncthreads();
      if (l > 0)
        for (int e = tid; e < 4 * J; e += NT) {
          float v = 0.f;
          for (int b = 0; b < B; ++b) v += dgo[b * 4 * J + e];
          dbo[(l - 1) * 4 * J + e] += v;
        }
      __threadfence();
      grid.sync();

      // C.2: BP into, and WG of, the own rows of both sites' weights over all
      // dgates columns (unkept rows: x = 0 in WG, factor 0 on BP)
      float bacc[2][JP];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < JP; ++q) bacc[i][q] = 0.f;
      const float* wpa = site_w(a.wf, a.us, a.ws, nl, sA, HG);
      const float* wpb = site_w(a.wf, a.us, a.ws, nl, sB, HG);
      // dgates and the own weight rows in column chunks, double-buffered:
      // chunk i+1's copies are in flight while chunk i is computed
      const int n4 = ch / 4, nch = (G + ch - 1) / ch;
      auto issue = [&](int i) {
        const int ch0 = i * ch, cw = min(ch, G - ch0);
        float* Rb = R + (size_t)(i & 1) * B * chp;
        float* wb = wr + (size_t)(i & 1) * 2 * JP * chp;
        for (int e = tid; e < B * n4; e += NT) {
          const int b = e / n4, c4 = (e % n4) * 4;
          float* dst = Rb + (size_t)b * chp + c4;
          if (c4 < cw) cp_async16(dst, dgdst + (size_t)b * G + ch0 + c4);
          else dst[0] = dst[1] = dst[2] = dst[3] = 0.f;
        }
        for (int e = tid; e < 2 * Jc * n4; e += NT) {
          const int p = e / (Jc * n4), q = (e / n4) % Jc, c4 = (e % n4) * 4;
          float* dst = wb + ((size_t)p * JP + q) * chp + c4;
          if (c4 < cw) cp_async16(dst, (p ? wpb : wpa) + (size_t)(j0 + q) * G + ch0 + c4);
          else dst[0] = dst[1] = dst[2] = dst[3] = 0.f;
        }
        cp_async_commit();
      };
      issue(0);
      for (int i = 0; i < nch; ++i) {
        if (i + 1 < nch) {
          issue(i + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const int ch0 = i * ch, cw = min(ch, G - ch0);
        const float* Rb = R + (size_t)(i & 1) * B * chp;
        const float* wb = wr + (size_t)(i & 1) * 2 * JP * chp;
        // WG: dW[j, c] += sum_b xw[b, j] * dg[b, c]; a thread takes one
        // (site, column) and all JP own rows of it
        const float4* xw4 = reinterpret_cast<const float4*>(xw);
        for (int e = tid; e < 2 * cw; e += NT) {
          const int p = e / cw, c = e % cw;
          float w0 = 0.f, w1 = 0.f, w2 = 0.f, w3 = 0.f;
#pragma unroll 4
          for (int b = 0; b < B; ++b) {
            const float g = Rb[(size_t)b * chp + c];
            const float4 xv = xw4[p * B + b];
            w0 = fmaf(xv.x, g, w0);
            w1 = fmaf(xv.y, g, w1);
            w2 = fmaf(xv.z, g, w2);
            w3 = fmaf(xv.w, g, w3);
          }
          const int site = p ? sB : sA;
          const float wq[JP] = {w0, w1, w2, w3};
#pragma unroll
          for (int q = 0; q < JP; ++q)
            if (q < Jc) drow(site, q)[ch0 + c] += wq[q];
        }
        // BP: this thread's tile (site tp, rows tb0 and tb1) over its
        // K-split of the chunk, 16-byte loads
        if (bp_ok) {
          const float4* g0 = reinterpret_cast<const float4*>(Rb + (size_t)tb0 * chp);
          const float4* g1 = reinterpret_cast<const float4*>(Rb + (size_t)min(tb1, B - 1) * chp);
          const float4* w4 = reinterpret_cast<const float4*>(wb + (size_t)tp * JP * chp);
          const int chp4 = chp / 4;
          for (int c4 = ks; c4 < cw / 4; c4 += KS) {
            const float4 x0 = g0[c4], x1 = g1[c4];
#pragma unroll
            for (int q = 0; q < JP; ++q) {
              const float4 w = w4[q * chp4 + c4];
              bacc[0][q] += x0.x * w.x + x0.y * w.y + x0.z * w.z + x0.w * w.w;
              bacc[1][q] += x1.x * w.x + x1.y * w.y + x1.z * w.z + x1.w * w.w;
            }
          }
        }
        __syncthreads();
      }
      // reduce the BP K-splits; dropout factor; into the carries
      if (bp_ok)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int q = 0; q < JP; ++q) R[((size_t)ks * tiles + tile) * 2 * JP + i * JP + q] = bacc[i][q];
      __syncthreads();
      for (int e = tid; e < 2 * BJ; e += NT) {
        const int p = e / BJ, b = (e % BJ) / J, q = e % J;
        if (q >= Jc) continue;
        const int tl = p * nbp + (b < nbp ? b : b - nbp), i = b < nbp ? 0 : 1;
        float v = 0.f;
        for (int k2 = 0; k2 < KS; ++k2) v += R[((size_t)k2 * tiles + tl) * 2 * JP + i * JP + q];
        const SiteArg& st = p == 0 ? stA : stB;
        v *= st.mode == 1 ? (flag[p * J + q] ? st.scale : 0.f)
           : st.mode == 2 ? st.mask[((size_t)(p == 0 ? rowA : rowB) * B + b) * H + j0 + q] * st.scale
                          : 1.f;
        if (p == 0) dhc[l * BJ + b * J + q] += v;
        else if (l > 0) dhin[(l - 1) * BJ + b * J + q] = v;
        else dfo[b * J + q] = v;
      }
      __syncthreads();
    }
    // dfeed carry (own units) and the next step's dpre
    for (int e = tid; e < BJ; e += NT) {
      const int b = e / J, q = e % J;
      if (q >= Jc) continue;
      const int j = j0 + q;
      dfo[e] += pf[e];
      if (r > 0) {
        const size_t o = ((size_t)(r - 1) * B + b) * H + j;
        const float ht = a.htil[o];
        a.dpre[(size_t)b * H + j] = act_of(r - 1, b) ? (a.dy[o] + dfo[e]) * (1.f - ht * ht) : 0.f;
      }
    }
    __syncthreads();
    __threadfence();
    grid.sync();
  }

  for (int e = tid; e < BJ; e += NT) {
    const int b = e / J, q = e % J;
    if (q >= Jc) continue;
    const int j = j0 + q;
    for (int l = 0; l < nl; ++l) {
      a.dh0[((size_t)l * B + b) * H + j] = dhc[l * BJ + e];
      a.dc0[((size_t)l * B + b) * H + j] = dcc[l * BJ + e];
    }
    a.df0[(size_t)b * H + j] = dfo[e];
  }
  for (int i = 0; i < 2 * nl; ++i) {
    float* dw = i == 0 ? a.dwf : (i <= nl ? a.dus + (size_t)(i - 1) * HG : a.dws + (size_t)(i - nl - 1) * HG);
    for (int e = tid; e < Jc * G; e += NT) dw[(size_t)(j0 + e / G) * G + e % G] = drow(i, e / G)[e % G];
  }
  for (int e = tid; e < 4 * (nl - 1) * J; e += NT) {
    const int l1 = e / (4 * J), g2 = (e / J) % 4, q = e % J;
    if (q < Jc) a.dbs[(size_t)l1 * G + (size_t)g2 * H + j0 + q] = dbo[e];
  }
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

// dy (T, B, H) = dL/dhtil; dhT, dcT (nl, B, H), dfT (B, H): the finals'
// cotangents; gates/hs/cs/htil/alpha from the forward. Outputs (written in
// full by the kernel): dgx0 (T, B, 4H), dus (nl, H, 4H), dws (nl-1, H, 4H),
// dbs (nl-1, 4H), dwf (H, 4H), dwc (2H, H), dep, deo (B, S, H), dh0, dc0
// (nl, B, H), df0 (B, H). dgs (max(nl-1,1), B, 4H), dpre, dctx, dcur (B, H)
// are scratch.
extern "C" int decoder_scan_bwd_f32(const BwdArgs* in, void* stream) {
  cudaGetLastError();
  BwdArgs a = *in;
  if (a.T <= 0 || a.B <= 0) return 0;
  if (a.nl != NL || a.H <= 0 || a.S <= 0) return (int)cudaErrorInvalidValue;
  int J = units_per_cta(a.H);
  if (J > JP || a.B > NT || a.H % 4 || a.H > HPT * NT) return (int)cudaErrorInvalidValue;
  // dgates chunks of 256 columns where the plan fits, else 128 (plan_launch
  // refuses a plan past SMEM_MAX)
  int ch = bwd_smem(a, J, 256) <= SMEM_MAX ? 256 : 128;
  const size_t smem = bwd_smem(a, J, ch);
  const void* kernel = (const void*)dec_bwd_kernel;
  int grid = 0;
  int code = plan_launch(kernel, smem, a.H, J, &grid);
  if (code) return code;
  void* args[] = {&a, &J, &ch};
  cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(NT), args, smem,
                                                (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
