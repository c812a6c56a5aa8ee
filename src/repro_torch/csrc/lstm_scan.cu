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
// bounds it. Both directions run on one grid of P clusters of Q CTAs (8
// where they fit; kernels/lstm_scan.py cluster_plan), CTA i owning J units,
// and pass their state between SMs as tagged words with no grid-wide
// barrier. The forward (csrc/scan_exchange.cuh, "The forward exchange")
// splits a step's product by column: CTA (c, q) polls the h_{t-1} words of
// the kept units of its column S_q (B x k / Q words), sums their part of the
// gates for its cluster's 4QJ columns (U's block, the rows of S_q x the
// cluster's columns, resident in shared memory when it fits: H=650, 66 KB),
// and pushes each CTA's columns into that CTA's shared memory; after a
// cluster barrier the owners add the Q partials in rank order, update c
// and h, and publish h_t. The first design had every CTA read all B x k
// inputs through L2 behind a grid.sync() a step (PERF.md, section 6).
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
constexpr int NF = 8;     // backward residual fields a (row, unit)
constexpr size_t SMEM_MAX = 227 * 1024;

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
  int Q, P;        // clusters of Q CTAs, P clusters
  int RC;          // forward: batch rows a chunk
};

// Floats of the forward's input buffer (PJ x RC), which also holds the
// k-group sums of push_tiles for an RC x C block.
__host__ __device__ inline size_t fwd_xs(int PJ, int RC, int C) {
  const size_t x = (size_t)PJ * RC, r = red_floats(RC, C, NT);
  return x > r ? x : r;
}

__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }

// Forward (csrc/scan_exchange.cuh, "The forward exchange"): P clusters of Q
// CTAs, CTA i owning the J units [i J, i J + J). Per step t and chunk of RC
// rows: a poll of the h_{t-1} words of the kept units of S_q at row t (h0
// at t = 0), the partial gates over them for the cluster's 4QJ columns
// (FFMA, 4 x 4 tiles a thread), a push of each CTA's columns into its
// shared memory and a cluster barrier, then the owner's sums in rank order
// + gx_t (prefetched), the pointwise update, and h_t out as tagged words
// (slot t & 1, tag t + 1); h and c of the own units stay in shared memory,
// frozen rows carrying t - 1. Between the barrier's arrive and its wait the
// CTA lists the kept units of row t + 1 (their ids prefetched a step ahead,
// two list buffers). No grid-wide barrier.
// RES: U's block (the rows of S_q x the cluster's columns) stays in shared
// memory; else the product reads U through L2 (zaremba-large, H = 1500).
template <bool RES>
__global__ void __launch_bounds__(NT, 1)
lstm_fwd_kernel(const float* __restrict__ gx, const float* __restrict__ U,
                const float* __restrict__ h0, const float* __restrict__ c0,
                const int* __restrict__ ids, const float* __restrict__ mask,
                const int* __restrict__ lens, float* hs, float* gates, float* cs, u64* ring,
                ScanArgs p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = p.T, B = p.B, H = p.H, G = 4 * H, J = p.J, Q = p.Q, P = p.P, RC = p.RC;
  const Clu L(Q, J, P, H);
  const int j0 = L.j0, Jc = L.Jc, PJ = P * J, C = clu_cols8(Q, J), N = P * Q, W = 4 * J;
  const int KI = p.mode == 1 ? p.k : 0;
  float* Ws = smem;                                         // RES: PJ x C block of U
  float* xs = Ws + (RES ? (size_t)PJ * C : 0);              // PJ x RC inputs; k-group sums
  const int BR = RC + 4;                                    // buf's row stride (banks)
  float* buf = xs + fwd_xs(PJ, RC, C);                      // Q x 4J x BR pushed partials
  float* gxs = buf + (size_t)Q * BR * W;                    // B x 4J: gx_t of the own units
  float* cst = gxs + (size_t)B * W;                         // B x J carries
  float* hcar = cst + (size_t)B * J;
  int* kl = reinterpret_cast<int*>(hcar + (size_t)B * J);   // 2 x PJ: kept units of S_q
  int* mk = kl + 2 * PJ;                                    // PJ stamps
  int* idsb = mk + PJ;                                      // mode 1: an ids row
  int* wsum = idsb + KI;                                    // 32
  int* lns = wsum + 32;                                     // B lengths
  const int tid = threadIdx.x;
  const size_t slot = (size_t)B * H;
  u64* sent = ring + 2 * slot;                              // N sentinels
  const bool per_step = KI && p.ids_rows > 1;
  // ids row r into idsb
  auto fetch_ids = [&](int r) {
#pragma unroll 1
    for (int kk = tid; kk < KI; kk += NT) cp4(idsb + kk, ids + (size_t)r * KI + kk, true);
  };

  if (RES) stage_block(Ws, C, U, L);
  fetch_ids(0);
  cp_commit();
#pragma unroll 1
  for (int e = tid; e < B * J; e += NT) {
    const int b = e / J, q = e - b * J;
    cst[e] = q < Jc ? c0[(size_t)b * H + j0 + q] : 0.f;
    hcar[e] = q < Jc ? h0[(size_t)b * H + j0 + q] : 0.f;
  }
#pragma unroll 1
  for (int s = tid; s < PJ; s += NT) mk[s] = -1;
#pragma unroll 1
  for (int b = tid; b < B; b += NT) lns[b] = p.ragged ? lens[b] : T;
  cp_wait<0>();
  __syncthreads();
  // row 0's list (every unit of S_q in modes 0 and 2), row 1's ids
  int nk = kept_of_column(KI ? idsb : nullptr, KI, 0, L, mk, kl, wsum);
  if (per_step && T > 1) fetch_ids(1);
  cp_commit();
  const Div dJc(Jc > 0 ? Jc : 1);
  const Tiles tt(RC, C);
  const float sc = p.mode == 0 ? 1.f : p.scale;
  cl_arrive();   // the first push waits for it
  FPHASE_START();
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const int* klt = kl + (per_step ? (t & 1) * PJ : 0);
    __syncthreads();   // the last step's pointwise is done with gxs
    // gx_t of the own units, read at the pointwise
#pragma unroll 1
    for (int e = tid; e < B * 4 * Jc; e += NT) {
      const int b = e / (4 * Jc), r = e - b * 4 * Jc, g = dJc.q(r), q = r - g * Jc;
      cp4(gxs + (size_t)b * W + g * J + q, gx + ((size_t)t * B + b) * G + (size_t)g * H + j0 + q,
          true);
    }
    cp_commit();
    FPHASE(0);
    const float* mrow = p.mode == 2 ? mask + (size_t)(p.mask_rows == 1 ? 0 : t) * B * H : nullptr;
#pragma unroll 1
    for (int b0 = 0; b0 < B; b0 += RC) {
      const int nr = min(RC, B - b0);
      const bool last = b0 + RC >= B;
      poll_rows(xs, RC, klt, nk, L, b0, nr, B, ring + (size_t)((t - 1) & 1) * slot,
                (unsigned)t, t == 0 ? h0 : nullptr, [&](int b, int u) {
                  return mrow ? mrow[(size_t)b * H + u] * sc : sc;
                });
      __syncthreads();
      if (last && tid == 0) st_word(sent + L.i, (u64)(t + 1));
      FPHASE(1);
      float acc[FMT][16];
#pragma unroll
      for (int i = 0; i < FMT; ++i)
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[i][e] = 0.f;
      tile_dot<RES>(acc, tt, xs, RC, klt, nk, Ws, C, U, L);
      FPHASE(2);
      cl_wait();   // the owners are done with buf
      push_tiles(acc, tt, xs, buf, BR, W, clu_cols(Q, J), L, GateOwner{J, Q * J});
      cp_wait<0>();
      cl_arrive();
      FPHASE(3);
      // while the cluster arrives: every reader done with the slot this step
      // overwrites (before its first publication), and row t + 1's list
      if (b0 == 0 && t >= 2) wait_sentinels(sent, N, (unsigned)t);
      __syncthreads();                        // and row t + 1's ids have landed
      if (last && per_step && t + 1 < T) {
        nk = kept_of_column(idsb, KI, t + 1, L, mk, kl + ((t + 1) & 1) * PJ, wsum);
        if (t + 2 < T) fetch_ids(t + 2);
        cp_commit();
      }
      cl_wait();
      FPHASE(4);
      // the own units (neighbouring threads along the units: the stores of
      // a row are neighbours): sums in rank order, the pointwise update, h_t out
#pragma unroll 1
      for (int e = tid; e < nr * Jc; e += NT) {
        const int r = dJc.q(e), q = e - r * Jc, b = b0 + r, j = j0 + q, o = b * J + q;
        float gv[4];
#pragma unroll
        for (int g2 = 0; g2 < 4; ++g2) {
          float v[8];
#pragma unroll
          for (int p2 = 0; p2 < 8; ++p2)
            v[p2] = p2 < Q ? buf[((size_t)p2 * W + g2 * J + q) * BR + r] : 0.f;
          float sum = 0.f;
#pragma unroll
          for (int p2 = 0; p2 < 8; ++p2) sum += v[p2];
          gv[g2] = gxs[(size_t)b * W + g2 * J + q] + sum;
        }
        const float ig = sigm(gv[0]);
        const float fg = sigm(gv[1] + p.forget_bias);
        const float gg = tanhf(gv[2]);
        const float og = sigm(gv[3]);
        const float c_prev = cst[o];
        float c_new = fg * c_prev + ig * gg;
        float h_new = og * tanhf(c_new);
        if (t >= lns[b]) {     // frozen row: carry t-1 through
          h_new = hcar[o];
          c_new = c_prev;
        }
        cst[o] = c_new;
        hcar[o] = h_new;
        st_word(ring + (size_t)(t & 1) * slot + (size_t)j * B + b, pack(h_new, t + 1));
        const size_t hofs = ((size_t)t * B + b) * H + j, gofs = ((size_t)t * B + b) * G + j;
        hs[hofs] = h_new;
        cs[hofs] = c_new;
#pragma unroll
        for (int g2 = 0; g2 < 4; ++g2) gates[gofs + (size_t)g2 * H] = gv[g2];
      }
      cl_arrive();   // done with buf
      FPHASE(5);
    }
  }
  FPHASE_END();
  cl_wait();   // no CTA leaves while a peer may still push into it
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

// The forward's shared memory in bytes at chunks of RC rows.
size_t fwd_smem(const ScanArgs& p, bool res, int RC) {
  const size_t PJ = (size_t)p.P * p.J, C = clu_cols8(p.Q, p.J), W = 4 * (size_t)p.J;
  const size_t f = (res ? PJ * C : 0) + fwd_xs((int)PJ, RC, (int)C) + (size_t)p.Q * (RC + 4) * W +
                   (size_t)p.B * W + 2 * (size_t)p.B * p.J;
  const size_t ints = 3 * PJ + (p.mode == 1 ? p.k : 0) + 32 + p.B;
  return 4 * (f + ints);
}

// The forward's plan at p's grid: into *res whether U's block stays in
// shared memory (when it fits at all), into *RC the most rows a chunk
// (a multiple of 4, at most B rounded up, its tiles at most FMT a thread)
// whose shared memory fits; 0 when none does.
void fwd_plan(const ScanArgs& p, bool* res, int* RC) {
  *res = fwd_smem(p, true, 4) <= SMEM_MAX;
  *RC = 0;
  for (int rc = 4; rc <= ((p.B + 3) & ~3); rc += 4)
    if (fwd_smem(p, *res, rc) <= SMEM_MAX && fits_tiles(rc, clu_cols8(p.Q, p.J))) *RC = rc;
}

size_t bwd_smem(const ScanArgs& p, bool res) {
  const size_t J = p.J, B = p.B, PJ = (size_t)p.P * J, ldc = clu_cols8(p.Q, p.J) + 4;
  const size_t f = (res ? PJ * ldc : 0) + ((B + 15) & ~size_t(15)) * ldc +
                   8 * J * ((B + 3) & ~size_t(3)) + 2 * NF * B * J + 2 * B * J;
  const size_t ints = (p.mode == 1 ? 2 * (size_t)p.k : 0) + 2 * PJ + 1 + 2 * J + B + 32;
  return std::max(4 * f + 4 * ints, WG_SMEM);
}

}  // namespace

// K3's plan for clusters of Q CTAs of J units: into *max_clu the clusters
// that can be resident at once (0 when no shared-memory plan fits), *res
// whether U's block stays in shared memory, *smem its bytes, *rows the rows
// of a chunk (fwd_plan).
extern "C" int lstm_scan_fwd_clusters(int B, int H, int mode, int k, int Q, int J, int* max_clu,
                                      int* res, int* smem, int* rows) {
  cudaGetLastError();
  ScanArgs p{1, B, H, mode, k, 1, 1, 0, J, 1.f, 0.f, Q, ((H + J - 1) / J + Q - 1) / Q, 0};
  bool r = false;
  fwd_plan(p, &r, rows);
  *res = r;
  *smem = *rows ? (int)fwd_smem(p, r, *rows) : 0;
  *max_clu = 0;
  if (!*rows || p.P * Q > NT) return 0;
  const void* kernel = r ? (const void*)lstm_fwd_kernel<true> : (const void*)lstm_fwd_kernel<false>;
  return max_clusters(kernel, Q, NT, *smem, max_clu);
}

// gx (T, B, 4H) with the bias folded in; U (H, 4H); h0, c0 (B, H);
// ids (ids_rows, k) int32 unit ids (mode 1); mask (mask_rows, B, H) (mode 2);
// lens (B,) int32 when ragged; ring: the zeroed words of the exchange
// (kernels/lstm_scan.py fwd_ring_words); a plan of P clusters of Q CTAs of J
// units that lstm_scan_fwd_clusters found resident (the wrapper's cached
// plan: the launch checks only its sizes). Outputs hs, cs (T, B, H) and
// gates (T, B, 4H), every element written.
extern "C" int lstm_scan_fwd_f32(const float* gx, const float* U, const float* h0,
                                 const float* c0, const int* ids, const float* mask,
                                 const int* lens, float* hs, float* gates, float* cs, u64* ring,
                                 int T, int B, int H, int mode, int k, int ids_rows,
                                 int mask_rows, int ragged, int Q, int J, float scale,
                                 float forget_bias, void* stream) {
  cudaGetLastError();
  if (T <= 0 || B <= 0) return 0;
  if (Q < 1 || Q > 8 || J < 1) return (int)cudaErrorInvalidValue;
  ScanArgs p{T, B, H, mode, k, ids_rows, mask_rows, ragged, J, scale, forget_bias, Q,
             ((H + J - 1) / J + Q - 1) / Q, 0};
  bool res = false;
  fwd_plan(p, &res, &p.RC);
  if (!p.RC || p.P * Q > NT) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(p, res, p.RC);
  const void* kernel = res ? (const void*)lstm_fwd_kernel<true>
                           : (const void*)lstm_fwd_kernel<false>;
  void* args[] = {&gx, &U, &h0, &c0, &ids, &mask, &lens, &hs, &gates, &cs, &ring, &p};
  cudaError_t err = launch_clusters(kernel, p.P, Q, NT, smem, args, stream);
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

extern "C" const char* lstm_scan_fwd_phase_names() {
  return "gx prefetch,poll h_{t-1} (+ sentinels),product,wait + push + arrive,"
         "next kept list + cluster wait,sums + pointwise + publish";
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
