// The machinery that the LSTM scans K3/K4 (csrc/lstm_scan.cu) and the
// decoder scan's backward K8 (csrc/decoder_scan.cu) share on Hopper
// (sm_90a): the backwards' per-step exchange of BP partial sums across a
// grid of thread-block clusters, the weight-gradient (WG) product they run
// after the scan, and K3's exchange of partial gates on the same grid (see
// "The forward exchange" below); and the phase counters of both files.
//
// Layout. The grid is P clusters of Q CTAs; CTA i = c Q + q (cluster c,
// rank q) owns the J hidden units [i J, i J + J) and computes their four
// gate columns of dgates, for all B rows, each step. A cluster owns the QJ
// units of its CTAs and their 4QJ gate columns. Column q (the CTAs of rank
// q in every cluster) owns the P J units S_q = {u : (u / J) % Q == q}.
//
// BP, dh_{r-1}[b, u] = sum over the 4H columns of dgates[b, col] W[u, col]
// for each unit u kept at row r: after a cluster.sync(), each CTA gathers
// its cluster's B x 4QJ dgates from the Q CTAs' shared memory (distributed
// shared memory, no L2 round trip), computes the partial sums over those
// columns for the kept units of S_q, and publishes them as 64-bit words that
// carry the value and the step together (tagged) into a two-slot ring in
// global memory; the owner of a unit polls the P partials of its kept units
// (one from each cluster) until the tags match, and sums them in cluster
// order. So a step moves B x 4J x Q floats through distributed shared memory
// and B x k / Q words out and B x J x P in through L2 a CTA, where the
// first design read all B x 4H dgates through L2 into every CTA in a chain
// of dependent chunks behind a grid.sync(). A CTA also publishes a sentinel
// word a step once it has read the previous slot, and one that reads no
// partial of a step (none of its units kept) polls its column's sentinels
// instead, so a slot is rewritten only after all its readers are done with
// it. A poll traps after 2^26 reads of one word, so a lost word fails the
// launch instead of hanging the card.
//
// WG, dW[u, col] = scale x sum over (t, b) of f(t, b, u) x_t[b, u]
// dgates_t[b, col], does not feed the recurrence: it runs after the scan
// (and a barrier of all CTAs on an L2 counter) as one product over the
// T x B pairs on the TF32 tensor cores in split precision, in 64-unit x
// 128-column tiles that the grid strides over. Each output is summed in
// one fixed order, so a second launch gives the same bits; a unit dropped
// at a step has f = 0 there, so a unit never kept gets exact zeros. WG is
// dense over the units: it multiplies dropped units by f = 0 instead of
// skipping them, so under a structured rate p it does 1 / (1 - p) times
// the kept units' FLOPs (2x at zaremba-medium's p = 0.5). Skipping needs
// all units of a tile to be dropped at a step together, which unit-level
// masks (block size 1, the LSTM models' plans) almost never give (a
// 64-unit tile is dropped whole at a step with probability p^64); a
// compact product over the kept units alone would run on FFMA, whose rate
// is below the dense product's on the tensor cores (PERF.md, section 6).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"   // cp16, cp4, cp_commit, cp_wait

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

// Phase counters. Built with -DLSTM_PHASES or -DDEC_PHASES
// (launch/scan_bench.py --phases), each kernel adds the SM cycles thread 0
// of each CTA spends in each phase of a step to g_phase[CTA][phase]: the
// backwards at each phase's end (PHASE), the forwards in registers (FPHASE),
// written out once at the end (FPHASE_END), so that the counting puts no L2
// round trip on a step. Otherwise the macros are empty.
#if defined(LSTM_PHASES) || defined(DEC_PHASES)
__device__ unsigned long long g_phase[1024][16];
#define PHASE_START() long long ph_t = clock64()
#define PHASE(i)                                                         \
  if (threadIdx.x == 0) {                                                \
    const long long ph_n = clock64();                                    \
    g_phase[blockIdx.x][i] += (unsigned long long)(ph_n - ph_t);         \
    ph_t = ph_n;                                                         \
  }
#define FPHASE_START()                    \
  long long ph_t = clock64();             \
  unsigned long long ph_a[16];            \
  for (int i = 0; i < 16; ++i) ph_a[i] = 0
#define FPHASE(i)                                   \
  if (threadIdx.x == 0) {                           \
    const long long ph_n = clock64();               \
    ph_a[i] += (unsigned long long)(ph_n - ph_t);   \
    ph_t = ph_n;                                    \
  }
#define FPHASE_END()                                                   \
  if (threadIdx.x == 0)                                                \
    for (int i = 0; i < 16; ++i) g_phase[blockIdx.x][i] += ph_a[i]
#else
#define PHASE_START()
#define PHASE(i)
#define FPHASE_START()
#define FPHASE(i)
#define FPHASE_END()
#endif

constexpr unsigned SPIN_MAX = 1u << 26;   // polls of one word before the launch fails
constexpr int XPW = 16;                   // tagged words a thread polls at once

__device__ __forceinline__ u64 pack(float v, unsigned tag) {
  return ((u64)tag << 32) | __float_as_uint(v);
}

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

// Waits until word *a carries tag `want`; returns its value. A poll that
// misses sleeps a little before the next (32 ns, doubling to 256 ns), so
// the waiting CTAs do not flood L2 with loads while the others compute.
__device__ __forceinline__ float wait_word(const u64* a, u64 w, unsigned want) {
  unsigned ns = 32;
  for (unsigned spin = 0; (unsigned)(w >> 32) != want; ++spin) {
    if (spin == SPIN_MAX) __trap();   // a lost word: fail the launch, do not hang
    __nanosleep(ns);
    ns = min(2 * ns, 256u);
    w = ld_word(a);
  }
  return __uint_as_float((unsigned)w);
}

// Sum over n = 0..cnt-1 of the tagged words addr(n), in that order, the loads
// XPW at a time in flight.
template <class Addr>
__device__ __forceinline__ float poll_sum(int cnt, unsigned want, Addr addr) {
  float s = 0.f;
#pragma unroll 1
  for (int n0 = 0; n0 < cnt; n0 += XPW) {
    u64 w[XPW];
#pragma unroll
    for (int i = 0; i < XPW; ++i) w[i] = n0 + i < cnt ? ld_word(addr(n0 + i)) : 0;
#pragma unroll
    for (int i = 0; i < XPW; ++i)
      if (n0 + i < cnt) s += wait_word(addr(n0 + i), w[i], want);
  }
  return s;
}

// poll_sum for N channels at once (channel c counted when on[c], its words
// addr(c, 0 .. cnt-1) with tag want[c]), 8 words of each in flight.
template <int N, class Addr>
__device__ __forceinline__ void poll_sums(int cnt, const unsigned (&want)[N],
                                          const bool (&on)[N], Addr addr, float (&out)[N]) {
#pragma unroll
  for (int c = 0; c < N; ++c) out[c] = 0.f;
#pragma unroll 1
  for (int n0 = 0; n0 < cnt; n0 += 8) {
    u64 w[N][8];
#pragma unroll
    for (int c = 0; c < N; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) w[c][i] = on[c] && n0 + i < cnt ? ld_word(addr(c, n0 + i)) : 0;
#pragma unroll
    for (int c = 0; c < N; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (on[c] && n0 + i < cnt) out[c] += wait_word(addr(c, n0 + i), w[c][i], want[c]);
  }
}

// Polls words addr(0..n-1) (nullptr: skip) until each carries tag `want`,
// XPW loads in flight a thread.
template <class Addr>
__device__ __forceinline__ void poll_all(int n, unsigned want, Addr addr) {
#pragma unroll 1
  for (int e0 = threadIdx.x; e0 < n; e0 += XPW * blockDim.x) {
    const u64* a[XPW];
    u64 w[XPW];
#pragma unroll
    for (int i = 0; i < XPW; ++i) {
      const int e = e0 + i * blockDim.x;
      a[i] = e < n ? addr(e) : nullptr;
      w[i] = a[i] ? ld_word(a[i]) : 0;
    }
#pragma unroll
    for (int i = 0; i < XPW; ++i)
      if (a[i]) wait_word(a[i], w[i], want);
  }
}

// A barrier of every CTA of the grid on the zeroed L2 counter *cnt:
// arrival `n` (1, 2, ...) of the launch waits for n x gridDim.x arrivals.
// What a CTA wrote before it is visible to every CTA after it.
__device__ __forceinline__ void grid_barrier(unsigned* cnt, unsigned n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(cnt) : "memory");
    const unsigned want = n * gridDim.x;
    unsigned v = 0;
    unsigned ns = 32;
    for (unsigned spin = 0;; ++spin) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(cnt) : "memory");
      if (v >= want) break;
      if (spin == SPIN_MAX) __trap();
      __nanosleep(ns);
      ns = min(2 * ns, 256u);
    }
  }
  __syncthreads();
}

// n / d by a multiply-high, exact for n d < 2^32; the reciprocal is set
// once a launch, so the index splits of a step cost no division (the
// loops of a step run every step, and a division is some 20 instructions).
struct Div {
  u64 m;
  __device__ explicit Div(int d) : m(d > 0 ? ((1ull << 32) + d - 1) / d : 0) {}
  __device__ __forceinline__ int q(int n) const { return (int)(((u64)(unsigned)n * m) >> 32); }
};

// The cluster layout of one launch (see the top of this file).
struct Clu {
  int Q, J, P, H;
  int i, c, q, j0, Jc;
  Div dJ, dQ, dQJ;
  __device__ Clu(int Q_, int J_, int P_, int H_)
      : Q(Q_), J(J_), P(P_), H(H_), dJ(J_), dQ(Q_), dQJ(Q_ * J_) {
    i = blockIdx.x;
    c = i / Q;
    q = i % Q;
    j0 = i * J;
    Jc = max(0, min(J, H - j0));
  }
  // unit of index s in S_q, and the index in S_q of a unit of S_q
  __device__ __forceinline__ int unit(int s) const {
    const int a = dJ.q(s);
    return (a * Q + q) * J + s - a * J;
  }
  __device__ __forceinline__ int sidx(int u) const {
    const int a = dJ.q(u);
    return dQ.q(a) * J + u - a * J;
  }
  // the CTA that owns unit u
  __device__ __forceinline__ int owner(int u) const { return dJ.q(u); }
  // global gate column of local cluster column lc (g QJ + unit offset)
  __device__ __forceinline__ int col(int lc) const {
    const int g = dQJ.q(lc);
    return g * H + c * Q * J + lc - g * Q * J;
  }
  __device__ __forceinline__ bool col_ok(int lc) const {
    return c * Q * J + lc - dQJ.q(lc) * Q * J < H;
  }
};

// Columns of the cluster's dgates and of a weight block (4QJ), and the
// same rounded up to the 8 of an mma k-step (the pad is zero).
__host__ __device__ inline int clu_cols(int Q, int J) { return 4 * Q * J; }
__host__ __device__ inline int clu_cols8(int Q, int J) { return (4 * Q * J + 7) & ~7; }

// The kept units of S_q of NS sites at a step, in the order of their ids
// rows (ascending: a warp's B fragments then read neighbouring weight rows,
// mostly in distinct banks): get(i, kk) is unit id kk of site i's row (-1
// past its end or for a site without a table), own(i, u) is called for the
// own units. Site i's list goes to kl[i PJ ..] (S_q indices), ku[i PJ ..]
// (units) and its length to nkl[i] where active(i). A block-wide prefix
// count (a ballot a warp, the warps' counts through wsum, NS x 32 ints).
template <int NS, class Get, class Own, class Active>
__device__ __forceinline__ void kept_lists(int kmax, Get get, Own own, Active active,
                                           const Clu& L, int* kl, int* ku, int PJ, int* nkl,
                                           int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int base[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) base[i] = 0;
#pragma unroll 1
  for (int k0 = 0; k0 < kmax; k0 += blockDim.x) {
    const int kk = k0 + threadIdx.x;
    int u[NS];
    unsigned m[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) u[i] = kk < kmax ? get(i, kk) : -1;   // loads in flight together
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int ow = u[i] >= 0 ? L.owner(u[i]) : 0;
      m[i] = __ballot_sync(0xffffffffu, u[i] >= 0 && ow - L.dQ.q(ow) * L.Q == L.q);
      if (lane == 0) wsum[i * 32 + warp] = __popc(m[i]);
      if (u[i] >= 0 && ow == L.i) own(i, u[i]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      int off = base[i], tot = 0;
      for (int w = 0; w < nw; ++w) {
        const int c = wsum[i * 32 + w];
        off += w < warp ? c : 0;
        tot += c;
      }
      if ((m[i] >> lane) & 1u) {
        const int n = off + __popc(m[i] & ((1u << lane) - 1u));
        kl[i * PJ + n] = L.sidx(u[i]);
        ku[i * PJ + n] = u[i];
      }
      base[i] += tot;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < NS; ++i)
    if (threadIdx.x == i && active(i)) nkl[i] = base[i];
}

// Gathers rows b0 .. b0 + nb (b0 % 4 == 0) of the cluster's dgates:
// dst[(b - b0) * ld + g QJ + p J + jj] = (CTA p's own[(g J + jj) * Bp + b])
// for every CTA p of the cluster (own: 4J columns of Bp = B rounded up to
// 4 rows, zero past B; 16-byte loads from distributed shared memory along
// b, 8 a thread in flight), and zeroes the pad columns up to the k-step.
// Rows past nb (up to the next multiple of 4) get values of no use.
__device__ __forceinline__ void gather_cluster(float* dst, int ld, float* own, int Bp,
                                               const Clu& L, int b0, int nb) {
  cg::cluster_group cl = cg::this_cluster();
  const int J = L.J, W = 4 * J, QJ = L.Q * J, nb4 = (nb + 3) / 4, n4 = W * nb4, n = L.Q * n4;
  const Div dn4(n4), dnb4(nb4);
#pragma unroll 1
  for (int e0 = threadIdx.x; e0 < n; e0 += 8 * blockDim.x) {
    float4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = min(e0 + i * (int)blockDim.x, n - 1), p = dn4.q(e), r = e - p * n4;
      const int w = dnb4.q(r), b4 = r - w * nb4;
      const float4* src = reinterpret_cast<const float4*>(cl.map_shared_rank(own, p) + w * Bp + b0);
      v[i] = src[b4];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = e0 + i * (int)blockDim.x;
      if (e >= n) break;
      const int p = dn4.q(e), r = e - p * n4, w = dnb4.q(r), b = 4 * (r - w * nb4);
      const int g = L.dJ.q(w), lc = g * QJ + p * J + w - g * J;
      float* col = dst + b * ld + lc;
      col[0] = v[i].x;
      col[ld] = v[i].y;
      col[2 * ld] = v[i].z;
      col[3 * ld] = v[i].w;
    }
  }
  const int K = clu_cols(L.Q, J), pad = clu_cols8(L.Q, J) - K;
  for (int e = threadIdx.x; e < nb * pad; e += blockDim.x) dst[(e / pad) * ld + K + e % pad] = 0.f;
}

// Stages the block of weight W (H x 4H) that a CTA's BP reads: dst[s * ldw
// + lc] = W[unit(s), col(lc)] for s < P J, lc < clu_cols8 (0 outside H and
// in the pad), by cp.async (16-byte copies where QJ and H are multiples of
// 4); the caller commits and waits.
__device__ __forceinline__ void stage_block(float* dst, int ldw, const float* __restrict__ W,
                                            const Clu& L) {
  const int PJ = L.P * L.J, K = clu_cols(L.Q, L.J), K8 = clu_cols8(L.Q, L.J), G = 4 * L.H;
  if ((L.Q * L.J) % 4 == 0 && L.H % 4 == 0) {
    const int n4 = K / 4;
    const Div dn4(n4);
#pragma unroll 1
    for (int e = threadIdx.x; e < PJ * n4; e += blockDim.x) {
      const int s = dn4.q(e), lc = 4 * (e - s * n4), u = L.unit(s);
      const bool ok = u < L.H && L.col_ok(lc);
      cp16(dst + (size_t)s * ldw + lc, ok ? W + (size_t)u * G + L.col(lc) : W, ok);
    }
  } else {
#pragma unroll 1
    for (int e = threadIdx.x; e < PJ * K8; e += blockDim.x) {
      const int s = e / K8, lc = e - s * K8, u = L.unit(s);
      const bool ok = u < L.H && lc < K && L.col_ok(lc);
      cp4(dst + (size_t)s * ldw + lc, ok ? W + (size_t)u * G + L.col(lc) : W, ok);
    }
  }
}

// Partial BP of a step over the cluster's columns: for each kept unit s =
// kl[n] (n < nk) of S_q and row b < nb, sink(n, b, sum over lc of dgc[b *
// ldg + lc] w(s, lc)) (the callers publish it as a tagged word of the ring),
// on the TF32 tensor cores in split precision (3xTF32, csrc/tf32x3.cuh, hi
// rounded to the nearest: a contraction here can be a few kept columns
// long). A warp takes 16 rows x 3 groups of 8 kept units at a time (one A
// fragment feeds them all) over the k-steps of 8 columns; the products of 4
// k-steps are summed on the cores from zero and added to the float32 sums
// by an FADD. dgc holds rows up to the next multiple of 16 (their sums are
// not handed out) and zeroes in the pad columns. RES: w(s, lc) = Ws[s * ldw
// + lc] in shared memory; else W[unit(s) * 4H + col(lc)] through L2.
template <bool RES, class Sink>
__device__ __forceinline__ void bp_partials(const float* dgc, int ldg, const float* Ws, int ldw,
                                            const float* __restrict__ Wg, const int* kl, int nk,
                                            int nb, const Clu& L, Sink sink) {
  constexpr int NG = 3, KG = 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt = (nb + 15) / 16, ntg = (nk + 8 * NG - 1) / (8 * NG);
  const int K = clu_cols(L.Q, L.J), K8 = clu_cols8(L.Q, L.J), G = 4 * L.H;
#pragma unroll 1
  for (int tl = warp; tl < mt * ntg; tl += nw) {
    const int mi = tl % mt, m0 = mi * 16, n0 = (tl - mi) / mt * 8 * NG;
    const float* wr[NG];
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int s = kl[min(n0 + 8 * j + g, nk - 1)];
      wr[j] = RES ? Ws + (size_t)s * ldw : Wg + (size_t)L.unit(s) * G;
    }
    const float* ar = dgc + (size_t)(m0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ldg + (lane >> 4) * 4;
    float acc[NG][4];
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
#pragma unroll 1
    for (int kg = 0; kg < K8; kg += 8 * KG) {
      float p[NG][4];
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) p[j][q] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KG; ++kk) {
        const int k0 = kg + 8 * kk;
        if (k0 >= K8) break;
        uint32_t raw[4], ah[4], al[4], bh[NG][2], bl[NG][2];
        ldsm4(raw, ar + k0);
#pragma unroll
        for (int q = 0; q < 4; ++q) split_rn(__uint_as_float(raw[q]), ah[q], al[q]);
#pragma unroll
        for (int j = 0; j < NG; ++j) {
          float w0, w1;
          if (RES) {
            w0 = wr[j][k0 + t];
            w1 = wr[j][k0 + t + 4];
          } else {
            const int c0 = k0 + t, c1 = c0 + 4;
            w0 = c0 < K && L.col_ok(c0) ? __ldg(wr[j] + L.col(c0)) : 0.f;
            w1 = c1 < K && L.col_ok(c1) ? __ldg(wr[j] + L.col(c1)) : 0.f;
          }
          split_rn(w0, bh[j][0], bl[j][0]);
          split_rn(w1, bh[j][1], bl[j][1]);
        }
        passes<true, true, NG>(p, ah, al, bh, bl);
      }
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] += p[j][q];
    }
    // accumulator q of group j: row m0 + g + 8 (q / 2), kept unit n0 + 8 j + 2t + q % 2
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int b = m0 + g + 8 * (q >> 1), n = n0 + 8 * j + 2 * t + (q & 1);
        if (b < nb && n < nk) sink(n, b, acc[j][q]);
      }
  }
}

// bp_partials' sink on the exchange: the partial of kept unit ku[n] at row
// b0 + b goes out as the tagged word ring_c[ku[n] * B + b0 + b] (a
// cluster's block of a slot is unit-major, so the rows a warp publishes and
// an owner polls are neighbouring words).
struct Publish {
  u64* ring_c;
  const int* ku;
  int B, b0;
  unsigned tag;
  __device__ __forceinline__ void operator()(int n, int b, float v) const {
    st_word(ring_c + (size_t)ku[n] * B + b0 + b, pack(v, tag));
  }
};

// ---------------------------------------------------------------------------
// The forward exchange (K3 lstm_fwd_kernel)
// ---------------------------------------------------------------------------
//
// The forward runs on the backward's grid and splits a step's product the
// other way round. gates[b, col] = sum over the kept units u of x[b, u]
// W[u, col]: CTA (c, q) sums over the kept units of S_q alone, for all 4QJ
// columns of its cluster (W's block: the rows of S_q x the cluster's
// columns, as BP's), and pushes the partial sums of each CTA's own columns
// into that CTA's shared memory (distributed shared memory), where the
// owner adds the Q partials of a column in rank order after a barrier of
// the cluster. x arrives as tagged words that the owners of the units
// published (h_t, in a two-slot ring, unit-major: word u B + b),
// so a CTA polls B x k / Q words a step and pushes B x 4QJ floats, where the
// first design read all B x k inputs through L2 into every CTA behind a
// grid.sync(). The cluster barrier runs in split phases (arrive, then wait
// just before the shared buffer is written again), so the only barrier on
// a step's path is the one that makes the pushed sums visible. A CTA
// publishes a sentinel (the steps whose inputs it has read) after its last
// poll of a step; before a CTA first overwrites a slot in step t it waits
// for every CTA's sentinel to reach t, so no slot is rewritten while one
// of its readers may still poll it.

constexpr int FMT = 3;   // most 4 x 4 tiles of partial sums a thread

__device__ __forceinline__ void cl_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cl_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Waits until every CTA's sentinel sent[i] (i < n <= blockDim.x) has
// reached `want`; the caller's next barrier makes it hold for the block.
__device__ __forceinline__ void wait_sentinels(const u64* sent, int n, unsigned want) {
  if (threadIdx.x >= n) return;
  unsigned ns = 32;
  for (unsigned spin = 0; (unsigned)ld_word(sent + threadIdx.x) < want; ++spin) {
    if (spin == SPIN_MAX) __trap();
    __nanosleep(ns);
    ns = min(2 * ns, 256u);
  }
}

// The units of S_q that an ids row keeps (ids: its k unit ids in shared
// memory; nullptr: every unit of S_q in H), as S_q indices in ascending
// order into kl; returns their count. mk: P J ints that start at -1, stamp:
// a value no earlier call wrote into mk. Ends with a __syncthreads().
__device__ int kept_of_column(const int* ids, int k, int stamp, const Clu& L, int* mk, int* kl,
                              int* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int PJ = L.P * L.J;
  if (ids) {
#pragma unroll 1
    for (int kk = tid; kk < k; kk += blockDim.x) {
      const int u = ids[kk], ow = L.owner(u);
      if (ow - L.dQ.q(ow) * L.Q == L.q) mk[L.sidx(u)] = stamp;
    }
    __syncthreads();
  }
  int base = 0;
#pragma unroll 1
  for (int s0 = 0; s0 < PJ; s0 += blockDim.x) {
    const int s = s0 + tid;
    const bool kept = s < PJ && L.unit(s) < L.H && (!ids || mk[s] == stamp);
    const unsigned m = __ballot_sync(0xffffffffu, kept);
    if (lane == 0) wsum[warp] = __popc(m);
    __syncthreads();
    int off = base, tot = 0;
    for (int w = 0; w < nw; ++w) {
      const int c = wsum[w];
      off += w < warp ? c : 0;
      tot += c;
    }
    if (kept) kl[off + __popc(m & ((1u << lane) - 1u))] = s;
    base += tot;
    __syncthreads();
  }
  return base;
}

// Stages rows b0 .. b0 + nr of one input at the units of S_q listed in kl
// (nk of them): xs[n ldx + r] = x[b0 + r, u] f(b0 + r, u), u = unit(kl[n]),
// x the tagged word src[u B + b] of tag `want` or, with init (the launch's
// initial state, B x H), init[b H + u]; rows nr .. ldx are zero. XPW loads
// in flight a thread.
template <class F>
__device__ __forceinline__ void poll_rows(float* xs, int ldx, const int* kl, int nk, const Clu& L,
                                          int b0, int nr, int B, const u64* src, unsigned want,
                                          const float* init, F f) {
  const int n = nk * ldx;
  const Div dl(ldx);
#pragma unroll 1
  for (int e0 = threadIdx.x; e0 < n; e0 += XPW * blockDim.x) {
    u64 w[XPW];
#pragma unroll
    for (int i = 0; i < XPW; ++i) {
      const int e = e0 + i * (int)blockDim.x, nn = dl.q(e), r = e - nn * ldx;
      const bool ok = e < n && r < nr;
      const int u = ok ? L.unit(kl[nn]) : 0;
      w[i] = !ok ? 0
             : init ? (u64)__float_as_uint(__ldg(init + (size_t)(b0 + r) * L.H + u))
                    : ld_word(src + (size_t)u * B + b0 + r);
    }
#pragma unroll
    for (int i = 0; i < XPW; ++i) {
      const int e = e0 + i * (int)blockDim.x, nn = dl.q(e), r = e - nn * ldx;
      if (e >= n) break;
      float v = 0.f;
      if (r < nr) {
        const int u = L.unit(kl[nn]);
        v = init ? __uint_as_float((unsigned)w[i])
                 : wait_word(src + (size_t)u * B + b0 + r, w[i], want);
        v *= f(b0 + r, u);
      }
      xs[e] = v;
    }
  }
}

// The 4 x 4 tiles of a rows4 x cols4 block of partial sums (both multiples
// of 4) that a thread computes: one column quad cq0 (4 cq0 .. 4 cq0 + 3) and
// the row quads rq(i) = rq0 + i rs, i < FMT (-1 past the block), so that a
// thread reads one quad of weights and FMT quads of inputs a listed unit.
// With fewer tiles than threads the sums are also split over the listed
// units into ks groups (k-group kg).
struct Tiles {
  int nrq, ncq, rs, cq0, rq0, ks, kg, nt, ntl;   // ntl: most tiles a thread (block-uniform)
  __device__ Tiles(int rows4, int cols4) {
    const int n = blockDim.x, tid = threadIdx.x;
    nrq = rows4 / 4;
    ncq = cols4 / 4;
    nt = nrq * ncq;
    ks = 1;
    while (ks < 8 && 2 * ks * nt <= n) ks *= 2;
    const int per = ks > 1 ? nt : n;          // threads a k-group
    kg = ks > 1 ? tid / nt : 0;
    const int t = ks > 1 ? tid % nt : tid;
    rs = max(1, per / ncq);
    cq0 = t % ncq;
    rq0 = t / ncq;
    if (ks > 1 && tid >= ks * nt) rq0 = nrq;  // idle
    if (rq0 >= rs) rq0 = nrq;                 // threads past rs x ncq idle
    ntl = ks > 1 ? 1 : (nrq + rs - 1) / rs;
  }
  __device__ __forceinline__ int rq(int i) const {
    const int r = rq0 + i * rs;
    return r < nrq ? r : -1;
  }
};

// acc[i] += tile (rq(i), cq0) of the partial sums over the listed units n =
// kg, kg + ks, .. < nk: xs[n ldx + r] w(kl[n], c), for i < NTL (the most
// tiles a thread has). The loop has no branch: a tile the thread lacks
// reads row quad 0 and its sums are not sent (push_tiles). RES: w(s, c) =
// Ws[s ldw + c]; else W (H x 4H) through L2, W[unit(s) 4H + col(c)] (0
// outside H).
template <bool RES, int NTL>
__device__ __forceinline__ void tile_dot_n(float (&acc)[FMT][16], const Tiles& tt, const float* xs,
                                           int ldx, const int* kl, int nk, const float* Ws,
                                           int ldw, const float* __restrict__ Wg, const Clu& L) {
  const int c0 = 4 * tt.cq0, K = clu_cols(L.Q, L.J), G = 4 * L.H, step = tt.ks;
  const float* xr[NTL];
#pragma unroll
  for (int i = 0; i < NTL; ++i) xr[i] = xs + 4 * max(tt.rq(i), 0) + (size_t)tt.kg * ldx;
  const int* kp = kl + tt.kg;
  const int cnt = nk > tt.kg ? (nk - tt.kg + step - 1) / step : 0;
  const size_t xstep = (size_t)step * ldx;
#pragma unroll 4
  for (int m = 0; m < cnt; ++m) {
    const int s = kp[m * step];
    float4 w4;
    if (RES) {
      w4 = *reinterpret_cast<const float4*>(Ws + (size_t)s * ldw + c0);
    } else {
      const float* wr = Wg + (size_t)L.unit(s) * G;
      float w[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int lc = c0 + cc;
        w[cc] = lc < K && L.col_ok(lc) ? __ldg(wr + L.col(lc)) : 0.f;
      }
      w4 = make_float4(w[0], w[1], w[2], w[3]);
    }
    const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int i = 0; i < NTL; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(xr[i] + m * xstep);
      const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          acc[i][rr * 4 + cc] = fmaf(xv[rr], wv[cc], acc[i][rr * 4 + cc]);
    }
  }
}

template <bool RES>
__device__ __forceinline__ void tile_dot(float (&acc)[FMT][16], const Tiles& tt, const float* xs,
                                         int ldx, const int* kl, int nk, const float* Ws, int ldw,
                                         const float* __restrict__ Wg, const Clu& L) {
  if (tt.rq0 >= tt.nrq) return;
  static_assert(FMT == 3, "tile_dot dispatches 1 to 3 tiles a thread");
  if (tt.ntl == 1) tile_dot_n<RES, 1>(acc, tt, xs, ldx, kl, nk, Ws, ldw, Wg, L);
  else if (tt.ntl == 2) tile_dot_n<RES, 2>(acc, tt, xs, ldx, kl, nk, Ws, ldw, Wg, L);
  else tile_dot_n<RES, 3>(acc, tt, xs, ldx, kl, nk, Ws, ldw, Wg, L);
}

// Sends the thread's tiles to the owners of their columns: the partial
// sums of rows r0 .. r0 + 3, cluster column c < ncol go to CTA p's
// buf[(L.q W + w) ldr + r0 ..] (16 bytes; an owner finds the Q partials of
// its column w by source rank, rows along; ldr a multiple of 4, at least
// the rows), (p, w) = own(c). k-groups are
// first summed (red: ks x tiles x 16 floats of shared memory no thread still
// reads) in group order. The caller has waited for the owners to be done
// with buf.
template <class Own>
__device__ __forceinline__ void push_tiles(float (&acc)[FMT][16], const Tiles& tt, float* red,
                                           float* buf, int ldr, int W, int ncol, const Clu& L,
                                           Own own) {
  cg::cluster_group cl = cg::this_cluster();
  const bool on = tt.rq0 < tt.nrq;
  if (tt.ks > 1) {
    const int tl = tt.rq0 * tt.ncq + tt.cq0;
    __syncthreads();
    if (on)
#pragma unroll
      for (int e = 0; e < 16; ++e) red[((size_t)tt.kg * tt.nt + tl) * 16 + e] = acc[0][e];
    __syncthreads();
    if (tt.kg != 0 || !on) return;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      float v = red[(size_t)tl * 16 + e];
      for (int g = 1; g < tt.ks; ++g) v += red[((size_t)g * tt.nt + tl) * 16 + e];
      acc[0][e] = v;
    }
  }
  if (!on) return;
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    const int c = 4 * tt.cq0 + cc;
    if (c >= ncol) continue;
    int p, w;
    own(c, p, w);
    float* dst = cl.map_shared_rank(buf, p) + ((size_t)L.q * W + w) * ldr;
#pragma unroll
    for (int i = 0; i < FMT; ++i) {
      const int r = tt.rq(i);
      if (r >= 0)
        *reinterpret_cast<float4*>(dst + 4 * r) =
            make_float4(acc[i][cc], acc[i][4 + cc], acc[i][8 + cc], acc[i][12 + cc]);
    }
  }
}

// Whether Tiles covers a rows4 x cols4 block with n threads (at most FMT
// tiles a thread).
__host__ __device__ inline bool fits_tiles(int rows4, int cols4, int n = 256) {
  const int ncq = cols4 / 4;
  return ncq <= n && rows4 / 4 <= FMT * (n / ncq);
}

// Floats of k-group sums push_tiles needs for a rows4 x cols4 block (0
// without k-groups), as Tiles splits it for n threads.
__host__ __device__ inline int red_floats(int rows4, int cols4, int n) {
  const int nt = rows4 / 4 * (cols4 / 4);
  int ks = 1;
  while (ks < 8 && 2 * ks * nt <= n) ks *= 2;
  return ks > 1 ? ks * nt * 16 : 0;
}

// own() of a gate block's cluster column lc = g QJ + p J + jj: CTA p, its
// column g J + jj.
struct GateOwner {
  int J, QJ;
  __device__ __forceinline__ void operator()(int lc, int& p, int& w) const {
    const int g = lc / QJ, m = lc - g * QJ;
    p = m / J;
    w = g * J + m - p * J;
  }
};

// ---------------------------------------------------------------------------
// WG after the scan
// ---------------------------------------------------------------------------

// One weight gradient, or a batch of nb of them: out[u, col] (R x C,
// written in full) = scale x sum over the np pairs (t, b), t = pair / bp,
// b = pair % bp, of f(t, b, u) x_t[b, u] dg_t[b, col], where x_t = x + t ldx
// (lag 0) or x_{t-1} (lag 1; x0 at t = 0) and dg_t = dg + t ldd, rows of R
// and C floats; f = 1 (fmode 0), fac[row(t) R + u] (1: a 0/1 keep table)
// or fac[(row(t) bp + b) R + u] (2: a dense mask), row(t) = frows == 1 ? 0
// : t. Batch n offsets x, dg and out by n xb, n db and n ob floats.
struct WgJob {
  const float* x;
  const float* x0;
  const float* dg;
  const float* fac;
  float* out;
  int lag, fmode, frows;
  float scale;
  int R, C, np, bp;
  long long ldx, ldd;
  int nb;
  long long xb, db, ob;
};

// A job of the plain layout: x (T, B, R), dg (T, B, C), out (R, C).
__host__ __device__ inline WgJob wg_job(const float* x, const float* x0, int lag,
                                        const float* dg, const float* fac, int fmode, int frows,
                                        float scale, float* out, int T, int B, int R, int C) {
  return WgJob{x, x0, dg, fac, out, lag, fmode, frows, scale, R, C, T * B, B,
               (long long)B * R, (long long)B * C, 1, 0, 0, 0};
}

constexpr int WTU = 64, WTC = 128, WKP = 32, WSTG = 3, WTHR = 256;
constexpr int WLX = WTU + 8, WLD = WTC + 8;     // staged row strides: fragments hit 32 banks
constexpr int W_XF = WKP * WLX;                 // floats of a stage's x (and f) rows
constexpr int W_STAGE = 2 * W_XF + WKP * WLD;   // floats: x, f, dg rows of WKP pairs
constexpr size_t WG_SMEM = (size_t)WSTG * W_STAGE * sizeof(float);

// One 64 x 128 tile (units u0.., columns c0..) of batch n of job jb on the
// TF32 tensor cores in split precision (3xTF32, hi rounded to the nearest,
// as K6's WG kernel): 256 threads, a warp 32 units x 32 columns (2 x 4
// m16n8 tiles); x (times f), f and dg rows of WKP pairs arrive k-outer by
// cp.async in a WSTG-deep ring; each chunk of WKP pairs is summed on the
// cores from zero and added to the float32 sums by an FADD. VEC: 16-byte
// copies of x and f (R, ldx % 4 == 0, aligned), else 4-byte ones; dg
// always by 16 bytes (C, ldd % 4 == 0, aligned).
template <bool VEC>
__device__ void wg_tile(float* sm, const WgJob& jb, int n, int u0, int c0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  const int R = jb.R, C = jb.C, np = jb.np, bp = jb.bp, nk = (np + WKP - 1) / WKP;
  const Div dbp(bp);
  const bool fac = jb.fmode != 0;
  const float* X = jb.x + n * jb.xb;
  const float* X0 = jb.x0 ? jb.x0 + n * jb.xb : nullptr;
  const float* D = jb.dg + n * jb.db;
  float* out = jb.out + n * jb.ob;
  auto xrow = [&](int t_, int b) -> const float* {
    if (jb.lag) return t_ == 0 ? X0 + (size_t)b * R : X + (t_ - 1) * jb.ldx + (size_t)b * R;
    return X + t_ * jb.ldx + (size_t)b * R;
  };
  auto frow = [&](int t_, int b) -> const float* {
    const int row = jb.frows == 1 ? 0 : t_;
    return jb.fmode == 1 ? jb.fac + (size_t)row * R : jb.fac + ((size_t)row * bp + b) * R;
  };
  auto issue = [&](int kc) {
    float* st = sm + (kc % WSTG) * W_STAGE;
    if (VEC) {
#pragma unroll
      for (int m = 0; m < WKP / 16; ++m) {
        const int e = tid + m * WTHR, i = e >> 4, j = e & 15, pr = kc * WKP + i, u = u0 + 4 * j;
        const bool ok = pr < np && u < R;
        const int t_ = ok ? dbp.q(pr) : 0, b = ok ? pr - t_ * bp : 0;
        cp16(st + i * WLX + 4 * j, ok ? xrow(t_, b) + u : D, ok);
        if (fac) cp16(st + W_XF + i * WLX + 4 * j, ok ? frow(t_, b) + u : D, ok);
      }
    } else {
#pragma unroll
      for (int m = 0; m < WKP / 4; ++m) {
        const int e = tid + m * WTHR, i = e >> 6, j = e & 63, pr = kc * WKP + i, u = u0 + j;
        const bool ok = pr < np && u < R;
        const int t_ = ok ? dbp.q(pr) : 0, b = ok ? pr - t_ * bp : 0;
        cp4(st + i * WLX + j, ok ? xrow(t_, b) + u : D, ok);
        if (fac) cp4(st + W_XF + i * WLX + j, ok ? frow(t_, b) + u : D, ok);
      }
    }
#pragma unroll
    for (int m = 0; m < WKP / 8; ++m) {
      const int e = tid + m * WTHR, i = e >> 5, j = e & 31, pr = kc * WKP + i, c = c0 + 4 * j;
      const bool ok = pr < np && c < C;
      const int t_ = ok ? dbp.q(pr) : 0, b = ok ? pr - t_ * bp : 0;
      cp16(st + 2 * W_XF + i * WLD + 4 * j, ok ? D + t_ * jb.ldd + (size_t)b * C + c : D, ok);
    }
  };
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  __syncthreads();   // the stages are free (a tile before may still read them)
#pragma unroll
  for (int s = 0; s < WSTG - 1; ++s) {
    if (s < nk) issue(s);
    cp_commit();
  }
#pragma unroll 1
  for (int kc = 0; kc < nk; ++kc) {
    cp_wait<WSTG - 2>();
    __syncthreads();
    if (kc + WSTG - 1 < nk) issue(kc + WSTG - 1);
    cp_commit();
    const float* Xs = sm + (kc % WSTG) * W_STAGE;
    const float* Fs = Xs + W_XF;
    const float* Ds = Xs + 2 * W_XF;
    float p[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) p[i][j][q] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < WKP; k0 += 8) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
      // A[m][k] = x_pair k0 + k [unit m] (times f): a0 (g, t), a1 (g + 8, t),
      // a2 (g, t + 4), a3 (g + 8, t + 4)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = wm + 16 * i + g;
        const int o[4] = {(k0 + t) * WLX + m, (k0 + t) * WLX + m + 8, (k0 + t + 4) * WLX + m,
                          (k0 + t + 4) * WLX + m + 8};
#pragma unroll
        for (int q = 0; q < 4; ++q) split_rn(fac ? Xs[o[q]] * Fs[o[q]] : Xs[o[q]], ah[i][q], al[i][q]);
      }
      // B[k][n] = dg_pair k0 + k [column n]: b0 (t, g), b1 (t + 4, g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + 8 * j + g;
        split_rn(Ds[(k0 + t) * WLD + c], bh[j][0], bl[j][0]);
        split_rn(Ds[(k0 + t + 4) * WLD + c], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) passes<true, true, 4>(p[i], ah[i], al[i], bh, bl);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += p[i][j][q];
  }
  cp_wait<0>();
  // accumulator q of tile (i, j): unit u0 + wm + 16 i + g + 8 (q / 2),
  // column c0 + wn + 8 j + 2t + q % 2
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = u0 + wm + 16 * i + g + 8 * h;
      if (u >= R) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + wn + 8 * j + 2 * t;
        if (c < C) store2(out + (size_t)u * C + c, acc[i][j][2 * h] * jb.scale,
                          acc[i][j][2 * h + 1] * jb.scale);
      }
    }
}

__device__ __forceinline__ bool wg_vec(const WgJob& jb) {
  const uintptr_t a = (uintptr_t)jb.x | (uintptr_t)jb.x0 | (uintptr_t)jb.fac;
  return jb.R % 4 == 0 && jb.ldx % 4 == 0 && jb.xb % 4 == 0 && (a & 15) == 0;
}

// Every job's outputs, the grid striding over the 64 x 128 tiles of all
// jobs (and batches). Needs blockDim.x == WTHR and WG_SMEM bytes at sm.
__device__ void wg_pass(float* sm, const WgJob* jobs, int njobs) {
  int total = 0;
  for (int j = 0; j < njobs; ++j)
    total += jobs[j].nb * ((jobs[j].R + WTU - 1) / WTU) * ((jobs[j].C + WTC - 1) / WTC);
#pragma unroll 1
  for (int tl = blockIdx.x; tl < total; tl += gridDim.x) {
    int j = 0, r = tl;
    for (;;) {
      const int per = jobs[j].nb * ((jobs[j].R + WTU - 1) / WTU) * ((jobs[j].C + WTC - 1) / WTC);
      if (r < per) break;
      r -= per;
      ++j;
    }
    const WgJob& jb = jobs[j];
    const int nu = (jb.R + WTU - 1) / WTU, nc = (jb.C + WTC - 1) / WTC;
    const int n = r / (nu * nc), rr = r - n * nu * nc, ut = rr % nu, ct = rr / nu;
    if (wg_vec(jb)) wg_tile<true>(sm, jb, n, ut * WTU, ct * WTC);
    else wg_tile<false>(sm, jb, n, ut * WTU, ct * WTC);
  }
}

// ---------------------------------------------------------------------------
// Host: cluster launches
// ---------------------------------------------------------------------------

// Lets `kernel` take as much dynamic shared memory as a CTA of the device
// can, set once a kernel and device: one fixed value, so that the plan of
// one shape never lowers what a launch of another needs, and a launch makes
// no CUDA call for it after the first.
inline cudaError_t opt_in_smem(const void* kernel) {
  constexpr int ND = 16, NK = 4;
  static const void* done[ND][NK] = {};
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < ND)
    for (int i = 0; i < NK; ++i)
      if (done[dev][i] == kernel) return cudaSuccess;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess && dev < ND)
    for (int i = 0; i < NK; ++i)
      if (!done[dev][i]) {
        done[dev][i] = kernel;
        break;
      }
  return err;
}

// A cooperative launch (every CTA co-resident) of P clusters of Q CTAs, a
// plan that max_clusters has found resident (a launch past that fails as
// too large; it is not queried again here).
inline cudaError_t launch_clusters(const void* kernel, int P, int Q, int threads, size_t smem,
                                   void** args, void* stream) {
  cudaError_t err = opt_in_smem(kernel);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P * Q);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = Q;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = 1;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  return cudaLaunchKernelExC(&cfg, kernel, args);
}

// Clusters of Q CTAs of `kernel` (with `smem` bytes each) that can be
// resident at once, into *out; a CUDA error code. The plan's query: the
// launch (launch_clusters) trusts the plan it is given.
inline int max_clusters(const void* kernel, int Q, int threads, size_t smem, int* out) {
  *out = 0;
  cudaError_t err = opt_in_smem(kernel);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Q);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute at;
  at.id = cudaLaunchAttributeClusterDimension;
  at.val.clusterDim.x = Q;
  at.val.clusterDim.y = 1;
  at.val.clusterDim.z = 1;
  cfg.attrs = &at;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

}  // namespace
