// Fused persistent-scan LSTM recurrence on Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernels of repro/kernels/cell_scan.py in their
// LSTM instance (repro/kernels/lstm_scan.py, heads = 1):
//   K3  _fwd_kernel via _pallas_fwd  -> lstm_fwd_kernel
//   K4  _bwd_kernel via _pallas_bwd  -> lstm_bwd_kernel
// Forward: gates_t = gx_t + drop(h_{t-1}) @ U, then the pointwise update,
// for all T steps in one launch, saving hs, gates and the c sequence.
// Backward: reverse time; dgates into dgx, compact BP into dh_{t-1},
// dh0/dc0, and WG into dU (f32), zero at the dropped (step, unit) pairs;
// frozen (ragged) steps pass their cotangents straight through with zero
// dgates. RH dropout modes: 0 off, 1 structured (a (T|1, k) table of kept
// unit ids; compact gathers, the paper's (1-p) FLOPs in the forward and in
// BP; WG stays dense over the units, csrc/scan_exchange.cuh), 2 dense
// ((T|1, B, H) mask). A one-row table is the FIXED time pattern.
//
// What bounds it on the H100: the recurrence is serial in T, and one
// step's product is tiny (B=20 rows x k=325 x 2600 columns, ~34 MFLOP),
// far below what one launch per step could fill. The Pallas kernel keeps
// U resident on its one core and the carry in scratch; on Hopper U
// (6.8 MB at H=650) does not fit one SM's 227 KB, so latency per step
// (memory round trips and the grid-wide barrier), not FLOPs or HBM bytes,
// bounds it. Design: one persistent cooperative launch (grid <= one CTA
// per SM, all co-resident) in which each CTA owns a slice of J hidden units
// j and computes their four gate columns {j, H+j, 2H+j, 3H+j} for all B
// rows. Those columns of U stay in shared memory when they fit (H=650:
// 52 KB), else they are read through the 50 MB L2; the compact h_{t-1} is
// staged in shared memory with many loads in flight; the cell state of the
// owned units never leaves shared memory; one grid.sync() per step
// publishes h_t. Cross-CTA data is read through L2 only (__ldcg); the
// forward issues each batch of staging loads with no branch between them,
// so they are in flight together.
// The backward (csrc/scan_exchange.cuh) keeps the ownership of dgates: a
// grid of P clusters of Q CTAs (8 where they fit), CTA i owning J units.
// Per step, a CTA polls the BP partials of its kept units (tagged words,
// one from each cluster), runs the pointwise reverse on residuals that
// were prefetched during the step before, and after a cluster.sync()
// gathers its cluster's B x 4QJ dgates from the cluster's shared memory
// and publishes the partial BP of the kept units of its column S_q over
// those columns; U's block for that product (the rows of S_q x the
// cluster's columns) stays in shared memory when it fits (H=650: 64 KB),
// else it is read through L2 (zaremba-large, H=1500). The first design read
// all B x 4H dgates through L2 into every CTA behind a grid.sync(), a
// chain of dependent chunks that took 64-87% of its step (PERF.md). dU,
// which does not feed the recurrence, is one product over the T x B pairs
// after the scan, every output summed by one thread in pair order, so a
// second launch gives the same bits; it runs over all H units, the dropped
// ones times zero (1 / (1 - p) times the kept units' FLOPs).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "scan_exchange.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;   // threads per CTA
constexpr int RB = 32;    // batch rows per register chunk (forward)
constexpr int LD = 16;    // global loads in flight per thread when staging
constexpr int NF = 8;     // backward residual fields a (row, unit)
constexpr size_t SMEM_MAX = 227 * 1024;

// Built with -DLSTM_PHASES (launch/scan_bench.py --phases), the backward
// adds the SM cycles thread 0 of each CTA spends in each phase of a step to
// g_phase[CTA][phase]; otherwise the macros are empty.
#ifdef LSTM_PHASES
__device__ unsigned long long g_phase[1024][16];
#define PHASE_START() long long ph_t = clock64()
#define PHASE(i)                                                         \
  if (threadIdx.x == 0) {                                                \
    const long long ph_n = clock64();                                    \
    g_phase[blockIdx.x][i] += (unsigned long long)(ph_n - ph_t);         \
    ph_t = ph_n;                                                         \
  }
#else
#define PHASE_START()
#define PHASE(i)
#endif

struct ScanArgs {
  int T, B, H;
  int mode;        // 0 off, 1 structured, 2 dense
  int k;           // kept units per ids row (structured)
  int ids_rows;    // 1 (FIXED) or T
  int mask_rows;   // 1 (FIXED) or T
  int ragged;
  int J;           // hidden units per CTA
  float scale;
  float forget_bias;
  int Q, P;        // backward: clusters of Q CTAs, P clusters
};

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

// RES: the CTA's U columns (H x 4J) stay resident in shared memory.
template <bool RES>
__global__ void __launch_bounds__(NT)
lstm_fwd_kernel(const float* __restrict__ gx, const float* __restrict__ U,
                const float* __restrict__ h0, const float* __restrict__ c0,
                const int* __restrict__ ids, const float* __restrict__ mask,
                const int* __restrict__ lens, float* hs, float* gates,
                float* cs, ScanArgs p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int T = p.T, B = p.B, H = p.H, G = 4 * H, J = p.J;
  const int j0 = blockIdx.x * J;
  const int Jc = min(J, H - j0);
  const int KC = p.mode == 1 ? p.k : H;
  const int C4 = 4 * J;
  const int S = NT / C4;
  float* Us = smem;                       // RES: H x C4 own columns of U
  float* hsm = Us + (RES ? (size_t)H * C4 : 0);  // B x KC compact h_{t-1}
  float* part = hsm + (size_t)B * KC;     // S x RB x C4 partial sums
  float* cst = part + (size_t)S * RB * C4;  // B x J cell-state carry
  int* uid = reinterpret_cast<int*>(cst + (size_t)B * J);  // KC unit ids
  const int tid = threadIdx.x;

  for (int e = tid; e < B * J; e += NT) {
    const int b = e / J, jj = e % J;
    if (jj < Jc) cst[e] = c0[(size_t)b * H + j0 + jj];
  }
  if (RES) {
    for (int e = tid; e < H * C4; e += NT) {
      const int row = e / C4, cc = e % C4, q = cc % J;
      Us[e] = q < Jc ? U[(size_t)row * G + (cc / J) * H + j0 + q] : 0.f;
    }
  }

  const int c = tid % C4, s = tid / C4;
  const int g = c / J, jj = c % J;
  const bool worker = s < S && jj < Jc;
  const int ucol = g * H + j0 + jj;

  for (int t = 0; t < T; ++t) {
    const int row_i = p.ids_rows == 1 ? 0 : t;
    const int row_m = p.mask_rows == 1 ? 0 : t;
    const float* hprev = t == 0 ? h0 : hs + (size_t)(t - 1) * B * H;
    if (p.mode == 1)
      for (int kk = tid; kk < KC; kk += NT) uid[kk] = ids[(size_t)row_i * p.k + kk];
    __syncthreads();
    // LD loads in flight per thread (the loads are L2 round trips): all of a
    // batch are issued unconditionally, with no branch between them
    for (int e0 = tid; e0 < B * KC; e0 += LD * NT) {
      float v[LD];
#pragma unroll
      for (int u = 0; u < LD; ++u) {
        const int e = min(e0 + u * NT, B * KC - 1);
        const int b = e / KC, kk = e - b * KC;
        v[u] = __ldcg(hprev + (size_t)b * H + (p.mode == 1 ? uid[kk] : kk));
      }
      if (p.mode == 2) {
        float m[LD];
#pragma unroll
        for (int u = 0; u < LD; ++u) {
          const int e = min(e0 + u * NT, B * KC - 1);
          const int b = e / KC, kk = e - b * KC;
          m[u] = mask[((size_t)row_m * B + b) * H + kk];
        }
#pragma unroll
        for (int u = 0; u < LD; ++u) v[u] *= m[u] * p.scale;
      }
#pragma unroll
      for (int u = 0; u < LD; ++u)
        if (e0 + u * NT < B * KC) hsm[e0 + u * NT] = v[u];
    }
    __syncthreads();

    for (int b0 = 0; b0 < B; b0 += RB) {
      float acc[RB];
#pragma unroll
      for (int bb = 0; bb < RB; ++bb) acc[bb] = 0.f;
      if (worker) {
#pragma unroll 4
        for (int kk = s; kk < KC; kk += S) {
          const int urow = p.mode == 1 ? uid[kk] : kk;
          const float u = RES ? Us[(size_t)urow * C4 + c] : __ldg(U + (size_t)urow * G + ucol);
          const float* hcol = hsm + kk;
#pragma unroll
          for (int bb = 0; bb < RB; ++bb)
            if (b0 + bb < B) acc[bb] = fmaf(hcol[(size_t)(b0 + bb) * KC], u, acc[bb]);
        }
      }
      if (s < S) {
#pragma unroll
        for (int bb = 0; bb < RB; ++bb) part[((size_t)s * RB + bb) * C4 + c] = acc[bb];
      }
      __syncthreads();
      for (int e = tid; e < RB * J; e += NT) {
        const int bb = e / J, q = e % J, b = b0 + bb;
        if (b >= B || q >= Jc) continue;
        const int j = j0 + q;
        const size_t gofs = ((size_t)t * B + b) * G + j;
        float sum[4] = {0.f, 0.f, 0.f, 0.f};   // four independent chains
        for (int s2 = 0; s2 < S; ++s2) {
          const float* pr = part + ((size_t)s2 * RB + bb) * C4 + q;
#pragma unroll
          for (int g2 = 0; g2 < 4; ++g2) sum[g2] += pr[g2 * J];
        }
        float gv[4];
#pragma unroll
        for (int g2 = 0; g2 < 4; ++g2) {
          if (p.mode == 1) sum[g2] *= p.scale;
          gv[g2] = gx[gofs + (size_t)g2 * H] + sum[g2];
        }
        const float ig = sigm(gv[0]);
        const float fg = sigm(gv[1] + p.forget_bias);
        const float gg = tanhf(gv[2]);
        const float og = sigm(gv[3]);
        const float c_prev = cst[b * J + q];
        float c_new = fg * c_prev + ig * gg;
        float h_new = og * tanhf(c_new);
        if (p.ragged && t >= lens[b]) {       // frozen row: carry t-1 through
          h_new = __ldcg(hprev + (size_t)b * H + j);
          c_new = c_prev;
        }
        cst[b * J + q] = c_new;
        const size_t hofs = ((size_t)t * B + b) * H + j;
        hs[hofs] = h_new;
        cs[hofs] = c_new;
#pragma unroll
        for (int g2 = 0; g2 < 4; ++g2) gates[gofs + (size_t)g2 * H] = gv[g2];
      }
      __syncthreads();
    }
    __threadfence();
    grid.sync();
  }
}

// RES: the CTA's block of U (the rows of S_q x the cluster's columns) stays
// in shared memory; else BP reads U through L2.
template <bool RES>
__global__ void __launch_bounds__(NT, 1)
lstm_bwd_kernel(const float* __restrict__ dy, const float* __restrict__ dcT,
                const float* __restrict__ gates, const float* __restrict__ cs,
                const float* __restrict__ c0, const float* __restrict__ hs,
                const float* __restrict__ h0, const float* __restrict__ U,
                const int* __restrict__ ids, const float* __restrict__ mask,
                const int* __restrict__ lens, float* dgx, float* dU,
                float* dh0, float* dc0, u64* ring, ScanArgs p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = p.T, B = p.B, H = p.H, G = 4 * H, J = p.J, Q = p.Q, P = p.P;
  const Clu L(Q, J, P, H);
  const int j0 = L.j0, Jc = L.Jc, BJ = B * J, Bp = (B + 3) & ~3;
  const int ldc = clu_cols8(Q, J) + 4, PJ = P * J;
  const int KC = p.mode == 1 ? p.k : 0;
  float* Ws = smem;                                   // RES: PJ x ldc block of U
  float* dgc = Ws + (RES ? (size_t)PJ * ldc : 0);     // B16 x ldc: the cluster's dgates
  float* dgo = dgc + (size_t)((B + 15) & ~15) * ldc;  // 2 x 4J x Bp: own dgates
  float* resb = dgo + 8 * (size_t)J * Bp;             // 2 x NF x B x J residuals
  float* dhc = resb + 2 * NF * (size_t)BJ;            // B x J carries
  float* dcc = dhc + BJ;
  int* uidb = reinterpret_cast<int*>(dcc + BJ);       // mode 1: 2 x KC unit ids
  int* kl = uidb + 2 * KC;                            // PJ: kept units of S_q (indices)
  int* ku = kl + PJ;                                  // PJ: their unit ids
  int* nkl = ku + PJ;                                 // 1
  int* flg = nkl + 1;                                 // 2 x J: row an own unit was kept
  int* lns = flg + 2 * J;                             // B lengths
  int* wsum = lns + B;                                // 32: a warp's count of kept units
  const int tid = threadIdx.x;
  const size_t slot = (size_t)P * B * H;
  u64* sent = ring + 2 * slot;                        // 2 x PQ sentinels
  unsigned* bar = reinterpret_cast<unsigned*>(sent + 2 * (size_t)P * Q);
  float* keep = reinterpret_cast<float*>(sent + 2 * (size_t)P * Q + 2);  // ids_rows x H

  if (RES) {
    stage_block(Ws, ldc, U, L);
    cp_commit();
  }
#pragma unroll 1
  for (int e = tid; e < 8 * J * Bp; e += NT) dgo[e] = 0.f;
#pragma unroll 1
  for (int e = tid; e < BJ; e += NT) {
    const int b = e / J, q = e % J;
    dhc[e] = 0.f;
    dcc[e] = q < Jc ? dcT[(size_t)b * H + j0 + q] : 0.f;
  }
#pragma unroll 1
  for (int e = tid; e < 2 * J; e += NT) flg[e] = -1;
#pragma unroll 1
  for (int b = tid; b < B; b += NT) lns[b] = p.ragged ? lens[b] : T;
  // the units of S_q, all kept when there is no ids table (an ascending
  // prefix of the indices)
  int nk_all = 0;
  while (nk_all < PJ && L.unit(nk_all) < H) ++nk_all;
  if (p.mode != 1)
#pragma unroll 1
    for (int s = tid; s < nk_all; s += NT) {
      kl[s] = s;
      ku[s] = L.unit(s);
    }
  const Div dB(B), dJc(Jc), dBJc(B * Jc);

  // step r's ids row and residuals of the own units (gates, dy, c_r,
  // c_{r-1}, the mask of row r + 1), into buffer r & 1
  auto prefetch = [&](int r) {
    const int buf = r & 1;
    if (p.mode == 1) {
      const int* src = ids + (size_t)(p.ids_rows == 1 ? 0 : r) * p.k;
#pragma unroll 1
      for (int kk = tid; kk < KC; kk += NT) cp4(uidb + buf * KC + kk, src + kk, true);
    }
    float* dst = resb + (size_t)buf * NF * BJ;
    const int nf = p.mode == 2 && r + 1 < T ? NF : NF - 1;
    const int mrow = p.mask_rows == 1 ? 0 : r + 1;
#pragma unroll 1
    for (int e = tid; e < nf * B * Jc; e += NT) {
      const int f = dBJc.q(e), bq = e - f * B * Jc, b = dJc.q(bq), q = bq - b * Jc;
      const int j = j0 + q;
      const size_t h = ((size_t)r * B + b) * H + j;
      const float* src;
      if (f < 4) src = gates + ((size_t)r * B + b) * G + (size_t)f * H + j;
      else if (f == 4) src = dy + h;
      else if (f == 5) src = cs + h;
      else if (f == 6) src = r > 0 ? cs + h - (size_t)B * H : c0 + (size_t)b * H + j;
      else src = mask + ((size_t)mrow * B + b) * H + j;
      cp4(dst + (size_t)f * BJ + b * J + q, src, true);
    }
    cp_commit();
  };
  prefetch(T - 1);

  const float sc = p.mode == 1 ? p.scale : 1.f;
  auto kept_own = [&](int r, int q) {
    return q < Jc && (p.mode != 1 || flg[(r & 1) * J + q] == r);
  };
  PHASE_START();
  for (int r = T - 1; r >= 0; --r) {
    const int buf = r & 1;
    cp_wait<0>();
    __syncthreads();
    PHASE(0);
    if (r > 0) prefetch(r - 1);
    if (p.mode == 1) {   // kept units of S_q at row r, in ids order; own ones flagged
      const int* uid = uidb + buf * KC;
      const int row = p.ids_rows == 1 ? 0 : r;
      kept_lists<1>(
          KC, [&](int, int kk) { return uid[kk]; },
          [&](int, int u) {
            flg[buf * J + u - j0] = r;
            keep[(size_t)row * H + u] = 1.f;
          },
          [&](int) { return true; }, L, kl, ku, PJ, nkl, wsum);
    }
    // whether this CTA reads a partial of step r + 1 from every CTA of its
    // column; if not, it polls their sentinels
    const bool any = __syncthreads_or(r + 1 < T && tid < J && kept_own(r + 1, tid));
    const int nk = p.mode == 1 ? *nkl : nk_all;
    if (r + 1 < T && !any)
      poll_all(P, r + 2, [&](int e) -> const u64* {
        return sent + (size_t)((r + 1) & 1) * P * Q + (size_t)e * Q + L.q;
      });
    PHASE(1);
    // pointwise reverse of the own units, dh with the incoming partials
    const float* rs = resb + (size_t)buf * NF * BJ;
    const u64* in_slot = ring + (size_t)((r + 1) & 1) * slot;
    float* own = dgo + (size_t)buf * 4 * J * Bp;
#pragma unroll 1
    for (int e = tid; e < B * Jc; e += NT) {   // b fastest: neighbouring words polled
      const int q = dB.q(e), b = e - q * B, o = b * J + q, j = j0 + q;
      float in = 0.f;
      if (r + 1 < T && kept_own(r + 1, q)) {
        in = poll_sum(P, r + 2, [&](int c) { return in_slot + ((size_t)c * H + j) * B + b; });
        in *= p.mode == 2 ? rs[7 * BJ + o] * p.scale : sc;
      }
      const float dh = rs[4 * BJ + o] + dhc[o] + in;
      const float dc_in = dcc[o];
      const bool act = r < lns[b];
      const float dh_c = act ? dh : 0.f;
      const float dc_c = act ? dc_in : 0.f;
      const float ig = sigm(rs[o]);
      const float fg = sigm(rs[BJ + o] + p.forget_bias);
      const float gg = tanhf(rs[2 * BJ + o]);
      const float og = sigm(rs[3 * BJ + o]);
      const float tc = tanhf(rs[5 * BJ + o]);
      const float c_prev = rs[6 * BJ + o];
      const float dc = dc_c + dh_c * og * (1.f - tc * tc);
      const float dg[4] = {dc * gg * ig * (1.f - ig), dc * c_prev * fg * (1.f - fg),
                           dc * ig * (1.f - gg * gg), dh_c * tc * og * (1.f - og)};
      const size_t gofs = ((size_t)r * B + b) * G + j;
#pragma unroll
      for (int g2 = 0; g2 < 4; ++g2) {
        __stcs(dgx + gofs + (size_t)g2 * H, dg[g2]);   // read again only after the scan
        own[(size_t)(g2 * J + q) * Bp + b] = dg[g2];
      }
      dcc[o] = dc * fg + (act ? 0.f : dc_in);
      dhc[o] = act ? 0.f : dh;         // pass-through; BP arrives next step
    }
    PHASE(2);
    // own dgates visible to the cluster; slot (r + 1) & 1 read by all threads
    cg::this_cluster().sync();
    if (tid == 0) st_word(sent + (size_t)buf * P * Q + L.i, pack(0.f, r + 1));
    PHASE(3);
    gather_cluster(dgc, ldc, own, Bp, L, 0, B);
    __syncthreads();
    PHASE(4);
    bp_partials<RES>(dgc, ldc, Ws, ldc, U, kl, nk, B, L,
                     Publish{ring + (size_t)buf * slot + (size_t)L.c * B * H, ku, B, 0,
                             (unsigned)(r + 1)});
    PHASE(5);
  }

  // dh0 with step 0's partials, dc0
#pragma unroll 1
  for (int e = tid; e < B * Jc; e += NT) {
    const int b = e / Jc, q = e - b * Jc, o = b * J + q, j = j0 + q;
    float in = 0.f;
    if (kept_own(0, q)) {
      in = poll_sum(P, 1, [&](int c) { return ring + ((size_t)c * H + j) * B + b; });
      in *= p.mode == 2 ? mask[(size_t)b * H + j] * p.scale : sc;
    }
    dh0[(size_t)b * H + j] = dhc[o] + in;
    dc0[(size_t)b * H + j] = dcc[o];
  }
  // WG after every CTA's dgates (and keep table) are out
  grid_barrier(bar, 1);
  PHASE(6);
  const float* fac = p.mode == 1 ? keep : p.mode == 2 ? mask : nullptr;
  const WgJob jb = wg_job(hs, h0, 1, dgx, fac, p.mode, p.mode == 1 ? p.ids_rows : p.mask_rows,
                          p.mode == 0 ? 1.f : p.scale, dU, T, B, H, G);
  wg_pass(smem, &jb, 1);
  PHASE(7);
}

size_t fwd_smem(const ScanArgs& p, bool res) {
  const int KC = p.mode == 1 ? p.k : p.H;
  const int C4 = 4 * p.J;
  const int S = NT / C4;
  return sizeof(float) * ((res ? (size_t)p.H * C4 : 0) + (size_t)p.B * KC +
                          (size_t)S * RB * C4 + (size_t)p.B * p.J) +
         sizeof(int) * (size_t)KC;
}

size_t bwd_smem(const ScanArgs& p, bool res) {
  const size_t J = p.J, B = p.B, PJ = (size_t)p.P * J, ldc = clu_cols8(p.Q, p.J) + 4;
  const size_t f = (res ? PJ * ldc : 0) + ((B + 15) & ~size_t(15)) * ldc +
                   8 * J * ((B + 3) & ~size_t(3)) + 2 * NF * B * J + 2 * B * J;
  const size_t ints = (p.mode == 1 ? 2 * (size_t)p.k : 0) + 2 * PJ + 1 + 2 * J + B + 32;
  return std::max(4 * f + 4 * ints, WG_SMEM);
}

// Fills p.J and the grid size; returns a CUDA error code (0 = launchable).
int plan_launch(ScanArgs* p, const void* kernel, size_t smem, int* grid) {
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
  *grid = (p->H + p->J - 1) / p->J;
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

// gx (T, B, 4H) with the bias folded in; U (H, 4H); h0, c0 (B, H);
// ids (ids_rows, k) int32 unit ids (mode 1); mask (mask_rows, B, H) (mode 2);
// lens (B,) int32 when ragged. Outputs hs, cs (T, B, H) and gates (T, B, 4H).
extern "C" int lstm_scan_fwd_f32(const float* gx, const float* U, const float* h0,
                                 const float* c0, const int* ids, const float* mask,
                                 const int* lens, float* hs, float* gates, float* cs,
                                 int T, int B, int H, int mode, int k, int ids_rows,
                                 int mask_rows, int ragged, float scale,
                                 float forget_bias, void* stream) {
  cudaGetLastError();
  if (T <= 0 || B <= 0) return 0;
  ScanArgs p{T, B, H, mode, k, ids_rows, mask_rows, ragged, units_per_cta(H), scale,
             forget_bias, 0};
  if (4 * p.J > NT) return (int)cudaErrorInvalidValue;
  // U resident in shared memory when it fits, else read through L2.
  const bool res = fwd_smem(p, true) <= SMEM_MAX;
  const void* kernel = res ? (const void*)lstm_fwd_kernel<true>
                           : (const void*)lstm_fwd_kernel<false>;
  const size_t smem = fwd_smem(p, res);
  int grid = 0;
  int code = plan_launch(&p, kernel, smem, &grid);
  if (code) return code;
  void* args[] = {&gx, &U, &h0, &c0, &ids, &mask, &lens, &hs, &gates, &cs, &p};
  cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(grid),
                                                dim3(NT), args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K4's plan for clusters of Q CTAs of J units: into *max_clu the clusters
// that can be resident at once (0 when the shared-memory plan does not
// fit), *res whether U's block stays in shared memory, *smem its bytes.
extern "C" int lstm_scan_bwd_clusters(int B, int H, int mode, int k, int Q, int J,
                                      int* max_clu, int* res, int* smem) {
  cudaGetLastError();
  ScanArgs p{1, B, H, mode, k, 1, 1, 0, J, 1.f, 0.f, Q, ((H + J - 1) / J + Q - 1) / Q};
  *res = bwd_smem(p, true) <= SMEM_MAX;
  const size_t bytes = bwd_smem(p, *res);
  *smem = (int)bytes;
  *max_clu = 0;
  if (bytes > SMEM_MAX || J > NT) return 0;
  const void* kernel = *res ? (const void*)lstm_bwd_kernel<true>
                            : (const void*)lstm_bwd_kernel<false>;
  return max_clusters(kernel, Q, NT, bytes, max_clu);
}

// dy (T, B, H): dL/dhs with dL/dh_T already added at T-1; dcT (B, H);
// gates/cs/hs from the forward; ring: the zeroed words of the exchange
// (kernels/lstm_scan.py ring_words); a plan of P clusters of Q CTAs of J
// units that lstm_scan_bwd_clusters found resident (the wrapper's cached
// plan: the launch checks only its sizes). Outputs dgx (T, B, 4H), dU
// (H, 4H), dh0, dc0 (B, H), every element written.
extern "C" int lstm_scan_bwd_f32(const float* dy, const float* dcT, const float* gates,
                                 const float* cs, const float* c0, const float* hs,
                                 const float* h0, const float* U, const int* ids,
                                 const float* mask, const int* lens, float* dgx,
                                 float* dU, float* dh0, float* dc0, u64* ring, int T, int B,
                                 int H, int mode, int k, int ids_rows, int mask_rows,
                                 int ragged, int Q, int J, float scale, float forget_bias,
                                 void* stream) {
  cudaGetLastError();
  if (T <= 0 || B <= 0) return 0;
  if (Q < 1 || Q > 8 || J < 1 || J > NT) return (int)cudaErrorInvalidValue;
  ScanArgs p{T, B, H, mode, k, ids_rows, mask_rows, ragged, J, scale, forget_bias, Q,
             ((H + J - 1) / J + Q - 1) / Q};
  const bool res = bwd_smem(p, true) <= SMEM_MAX;
  const size_t smem = bwd_smem(p, res);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const void* kernel = res ? (const void*)lstm_bwd_kernel<true>
                           : (const void*)lstm_bwd_kernel<false>;
  void* args[] = {&dy, &dcT, &gates, &cs, &c0, &hs, &h0, &U, &ids, &mask, &lens,
                  &dgx, &dU, &dh0, &dc0, &ring, &p};
  cudaError_t err = launch_clusters(kernel, p.P, Q, NT, smem, args, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef LSTM_PHASES
// Copies g_phase (1024 x 16 cycle counts) to host memory `out` and zeroes it.
extern "C" int lstm_scan_phases(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  if (err == cudaSuccess) {
    static unsigned long long zero[1024][16];
    err = cudaMemcpyToSymbol(g_phase, zero, sizeof(g_phase));
  }
  return (int)err;
}

extern "C" const char* lstm_scan_phase_names() {
  return "wait + barrier,kept list + sentinels,poll partials + pointwise,cluster.sync,"
         "gather cluster dgates,BP partials + publish,dh0 + barrier after the scan,"
         "WG after the scan";
}
#endif

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
