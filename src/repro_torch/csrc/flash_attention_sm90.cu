// bfloat16 flash attention on Hopper's wgmma and TMA (sm_90a): the forward,
// the dq pass and the dk/dv pass at head_dim 64, 128 and 256.
//
// Replaces, for bfloat16 inputs at those head dims, the Pallas TPU kernels
// of repro/kernels/flash_attention.py:
//   K9  _fwd_kernel via _flash_fwd (pallas_call :107)  -> flash_fwd_sm90
//   K10 _dq_kernel  via _flash_bwd (pallas_call :218)  -> flash_dq_sm90
//   K11 _dkv_kernel via _flash_bwd (pallas_call :243)  -> flash_dkv_sm90
// (kernels/flash_attention.py route() sends every other dtype and head_dim
// to csrc/flash_attention.cu). They compute what that file's K9, K10 and
// K11 compute, on the same layouts, masks and launch
// orders: q (B, Sq, Hq, D), k / v (B, Sk, Hkv, D) read through their strides,
// query head h on kv head h / (Hq / Hkv), hidden pairs and keys past Sk p =
// 0; o and lse (B, Hq, Sq) out of K9, dq (B, Sq, Hq, D) out of K10, dk and dv
// summed over each kv head's group of query heads out of K11, in a fixed
// order (no atomics: the same bits launch to launch). Every query row sees at
// least one key: the entry point refuses a window that leaves rows with none
// (Sq > Sk + window - 1), as the wrapper does, since such a row's lse is -inf
// and K10's and K11's p = 2^(s - lse) would be NaN where the reference gives
// 1 / Sk.
//
// What the reference computes, and so what may run at the bfloat16 rate.
// s = q . k and dp = do . v are products of bfloat16 values (exact in
// float32) with float32 sums; K9 rounds p to v's dtype before p v. Those
// are wgmma.f32.bf16.bf16 products as they stand. K10's and K11's p and ds
// stay float32 in the reference, so dq = ds k, dv = p^T do and dk = ds^T q
// take each of p and ds as two bfloat16 terms, hi = bf16(x) and lo = bf16(x
// - hi), which carry x to ~2^-17 of |x| (below the 2^-9 of the bfloat16 dq,
// dk, dv; a third term is not needed: on the card dq's, dk's and dv's
// float64 distance is the bfloat16 plain version's, PERF.md): 4 bfloat16
// products a tile in K10, 6 in K11.
//
// What bounds them on the H100: operations. At qwen3-8b's training shape
// (B 1, S 4096, 32 query heads over 16, d 128, causal) one product over the
// causal half is 68.7e9 FLOP: K9's two at 989 TFLOP/s take 0.139 ms, K10's
// three 0.209 ms (its own route's four 0.278 ms), K11's four 0.278 ms (its
// own route's six 0.417 ms); the operands are ~70 MB (0.02 ms). At
// gemma-2b's (B 1, S 4096, 8 query heads over 8 kv heads after kv_repeat, d
// 256, causal) one product is 34.4e9 FLOP: K9's two 0.0695 ms, K10's three
// 0.104 ms (its own route's four 0.139 ms), K11's four 0.139 ms (its own
// route's six 0.209 ms).
//
// Design (csrc/sm90.cuh holds the PTX):
//   * Tiles land by TMA in 64-column boxes with the 128-byte swizzle, rows
//     past the tensor zero-filled (the ragged last tiles: the serving
//     prefill has S 511), into a ring of stages, each with a full mbarrier
//     and either an empty mbarrier, on which each consumer warpgroup's
//     thread 0 arrives when its wgmma that read the stage have completed,
//     or a count of those releases in shared memory, whose second releaser
//     refills the stage (release_and_refill). wgmma reads them
//     K-major (contraction over head_dim) or, with the transpose bit,
//     MN-major (contraction over a sequence axis: v in p v, k in ds k, do in
//     p^T do, q in ds^T q), so no tile is transposed or copied and one copy
//     of a tile serves both its products.
//   * K9 at D 64, 128: a CTA of 384 threads, two consumer warpgroups and a
//     producer warpgroup whose one thread issues the loads (setmaxnreg:
//     consumers 232 registers, producer 40), ring of two stages. 128 query
//     rows of one
//     (batch, head), 64 a consumer warpgroup, q resident; kv tiles of 128
//     keys. s = q k^T is wgmma m64n128k16 from shared memory (D / 16
//     k-steps); the online softmax runs in base 2 on the accumulator layout
//     as csrc/flash_attention.cu's K9 (a row's max over the quad by two
//     shfl_xor, l per lane until the end; on a wholly visible tile one FFMA
//     and one MUFU.EX2 a score, masks only on the diagonal and a window's
//     edge); p is rounded to bfloat16 into the A registers of o += p v (the
//     accumulator's columns are the A fragment's k, no shuffle), and o
//     accumulates in the wgmma's own registers over the whole kv loop. The
//     tensor cores truncate as they add: at S 4096 that is at most 4096 / 16
//     = 256 truncations of 2^-23, ~3e-5 of |o|, far below the output's 2^-9,
//     so the from-zero partial sums and the FADD of the TF32 design are not
//     needed here.
//   * K10: a CTA of 256 threads, two consumer warpgroups whose thread 0 also
//     produces (as K11, below). 128 query rows of one (batch, head), 64 a
//     warpgroup, q and do resident; kv tiles of kv head h / G. s = q k^T and
//     dp = do v^T are wgmma m64nBKk16 from shared memory; p = 2^(s scale
//     log2(e) - lse log2(e)) and ds = p (dp scale - delta scale) (one FFMA
//     and one MUFU.EX2 a score; lse and delta of the thread's two rows read
//     once) are formed on the accumulator layout and split into the A
//     registers of dq += ds k (hi then lo), k read MN-major. dq stays in
//     registers for the whole loop (at most 2 x 4096 / 16 accumulating
//     k-steps: ~6e-5 of |dq| in truncation, under the output's 2^-9) and is
//     written in q's dtype. Thread 0 loads q, do and the first tiles; the
//     second warpgroup to release a stage loads the tile ST on into it, as
//     K9's at D 256. At D 64, 128: kv tiles of 64 keys in a ring of four
//     stages; dq (D / 2), s, dp (32 each) and the split terms (32) take
//     ~170-190 registers a thread: the register budget of K11, not K9's
//     168. At D 256 q and do alone are 128 KB, and four stages of 64 keys
//     would be 256 KB more: kv tiles of 32 keys in a ring of three stages
//     (3 x 32 KB, 226 KB in all). dq is 128 registers a thread, s and dp
//     (m64n32) 16 each, the split terms 16. The terms and their order are
//     the same at every D: a k-step of 16 keys, hi then lo, in key order.
//   * K11 at D 64, 128: a CTA of 256 threads, two consumer warpgroups whose
//     thread 0 also produces (below), ring of three stages. 128 keys of one
//     (batch, kv
//     head), 64 a warpgroup, k and v resident; q and do in tiles of 64
//     queries, walked over the group's query heads as
//     csrc/flash_attention.cu's K11, each tile in parts of 32 queries. s^T =
//     k q^T and dp^T = v do^T are wgmma m64n32k16 from shared memory; p^T =
//     exp(s^T scale - lse) and ds^T = p^T (dp^T - delta) scale are formed in
//     registers (lse and delta read from global memory) and split into the
//     A registers of dv += p^T do and dk += ds^T q (hi then lo). dk and dv
//     stay in registers for the whole loop (at most 2 x 4096 / 16
//     accumulating k-steps of 2 products: ~1.2e-4 of |dk| in truncation,
//     under the output's 2^-9). dk, dv (2 D), s^T, dp^T and the split terms
//     (32 each) take ~200 registers a thread. A producer warp would make the
//     CTA 288 or 384 threads, which start at 168 registers a thread, and
//     ptxas kept the consumers' code near that whatever setmaxnreg granted:
//     it spilled dk and serialized every wgmma. With 256 threads ptxas may
//     give a thread 255, and none spills. So thread 0 loads k and v, the
//     first three tiles, and at each tile the stage of the tile before,
//     once both warpgroups have released it.
//   * K9 at D 256: q alone is 64 KB, so a producer warpgroup and kv tiles
//     of 128 keys (320 KB) do not fit. A CTA of 256 threads; 128 query
//     rows, 64 a warpgroup, q resident; kv tiles of 64 keys in a ring of two
//     stages (64 + 2 x 64 KB). Thread 0 loads q and the first two tiles;
//     then the second warpgroup to release a stage (a shared counter of
//     releases) loads the tile two on into it, so neither waits for the
//     other (a thread 0 that waits for both, as K11's at D 64, 128, holds
//     its warpgroup in lockstep with the other). s = q k^T is wgmma m64n64k16 (16
//     k-steps), o += p v m64n256k16 with p in registers (4 k-steps a
//     tile). o takes D / 2 = 128 registers a thread, s 32, p's A fragments
//     16: ptxas gives 204 registers and no spill.
//   * K11 at D 256: dk and dv of 64 keys would take 256 registers a thread.
//     The CTA's 64 keys are shared by its two warpgroups by role: warpgroup 0
//     forms s^T = k q^T and p^T, hands p^T to warpgroup 1 in float32 through
//     shared memory (two buffers of 64 x 64, named barriers 1-4) and
//     accumulates dv += p^T do; warpgroup 1 forms dp^T = v do^T, ds^T = p^T
//     (dp^T scale - delta scale) from the p^T it was handed, and accumulates
//     dk += ds^T q. Each holds one 64 x 256 accumulator, and the two run the
//     same instructions on other operands: a part of 64 queries is 16 wgmma
//     m64n64k16 from shared memory and 8 m64n256k16 with A in registers (two
//     terms, four k-steps) a warpgroup, the route's six products with none
//     computed twice. The accumulator (128), s^T or dp^T (32) and the split
//     terms (32) take 255 registers a thread, no spill (parts of 64 queries,
//     not D 64 / 128's 32, halve the reads of k or v, the A of the first
//     product, from shared memory). k and v resident (2 x 32 KB), q and do in
//     tiles of 64 queries in a ring of two stages (2 x 64 KB), the p^T
//     buffers 2 x 16 KB; the stages refilled as K9's at D 256. The hand-off
//     is exact, so the terms and sums are those of the D 64 / 128 layout.
//   * Masks: a warpgroup skips the tiles (K11: parts) none of its rows can
//     see (it still waits for and releases the stage) and masks only tiles
//     on the diagonal or a window's edge or past Sq / Sk.
//   * Launch order as csrc/flash_attention.cu: heads fastest; K9 and K10 the
//     last q tiles first, K11 the first kv tiles first.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mask.cuh"
#include "sm90.cuh"

namespace {

constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;   // K9 at D 64, 128
constexpr int NT_DKV = 256;     // K10, K11: two warpgroups, thread 0 the producer
constexpr float NEG = -1e30f;                // masked score, as the reference
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

struct Args {
  const float *lse_in, *delta;
  __nv_bfloat16 *o, *dq, *dk, *dv;
  float* lse;
  int B, Sq, Sk, Hq, Hkv;
  int causal, window;   // window <= 0: none
  float scale;
};

__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x, y);
}

// wgmma with A in registers, N = head_dim
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 256) wgmma_rs_n256(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n64(d, a, db);
}

// wgmma with both operands in shared memory, N keys (K9, K10) or queries (K11)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 128) wgmma_ss_n128(d, da, db, scale_d);
  else if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n32(d, da, db, scale_d);
}

// A warpgroup's release of a stage, by its thread 0, once the wgmma that
// read the stage have completed: ``count`` (a shared word, zero at the
// start) counts the stage's releases, and the second of the two warpgroups
// to release it loads tile ``next`` into it (``load(next)``) if there is
// one, so neither warpgroup waits for the other
template <typename Load>
__device__ __forceinline__ void release_and_refill(uint32_t count, int next, int n,
                                                   const Load& load) {
  __threadfence_block();
  if ((atom_add_shared(count, 1) & 1) && next < n) {
    __threadfence_block();
    load(next);
  }
}

// ---------------------------------------------------------------------------
// K9: forward
// ---------------------------------------------------------------------------

template <int D> struct FwdSm90 {
  // D 64, 128: a producer warpgroup, kv tiles of 128 keys; D 256: no
  // producer warpgroup (NT 256; the second warpgroup to release a stage
  // refills it), kv tiles of 64 keys (shared memory: q 64 KB + two stages
  // of k and v at 32 KB each)
  static constexpr bool PWG = D <= 128;
  static constexpr int NT = PWG ? 384 : 256;
  static constexpr int BQ = 128, BK = PWG ? 128 : 64, ST = 2, NB = D / 64;
  static constexpr uint32_t Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  static constexpr uint32_t BAR = Q_BYTES + ST * 2 * KV_BYTES;   // q, full[ST], empty[ST]
  static constexpr uint32_t SMEM = BAR + 1024 + 1024;            // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(FwdSm90<D>::NT, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Args a) {
  using TL = FwdSm90<D>;
  constexpr int BQ = TL::BQ, BK = TL::BK, ST = TL::ST, NB = TL::NB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t skv = sq + TL::Q_BYTES;     // stage s: k at skv + 2 s KV_BYTES, v after it
  const uint32_t qbar = sq + TL::BAR;
  const uint32_t full0 = qbar + 8, empty0 = full0 + 8 * ST;
  const uint32_t rel0 = empty0 + 8 * ST;     // D 256: each stage's releases so far
  const int qt = gridDim.y - 1 - blockIdx.y, h = blockIdx.x % a.Hq, b = blockIdx.x / a.Hq;
  const int hk = h / (a.Hq / a.Hkv), q0 = qt * BQ;
  // kv tiles that rows [q0, q0 + BQ) can see
  int lo, hi;
  kv_range(a, q0, min(q0 + BQ, a.Sq) - 1, lo, hi);
  const int kt0 = lo / BK, n = max(0, (hi + BK - 1) / BK - kt0);
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      if constexpr (TL::PWG) mbar_init(empty0 + 8 * s, 2);
      else sts_u32(rel0 + 4 * s, 0);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // q once, then k and v of tile i into stage i % ST
  const auto load_q = [&]() {
    mbar_expect_tx(qbar, TL::Q_BYTES);
#pragma unroll
    for (int c = 0; c < NB; ++c) tma_load_4d(sq + c * BQ * 128, &tq, qbar, 64 * c, q0, h, b);
  };
  const auto load_kv = [&](int i) {
    const int s = i % ST;
    const uint32_t kd = skv + s * 2 * TL::KV_BYTES, vd = kd + TL::KV_BYTES;
    const int k0 = (kt0 + i) * BK;
    mbar_expect_tx(full0 + 8 * s, 2 * TL::KV_BYTES);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      tma_load_4d(kd + c * BK * 128, &tk, full0 + 8 * s, 64 * c, k0, hk, b);
      tma_load_4d(vd + c * BK * 128, &tv, full0 + 8 * s, 64 * c, k0, hk, b);
    }
  };
  const int wg = threadIdx.x / 128;
  if (TL::PWG && wg == 2) {
    if constexpr (TL::PWG) {
      // the producer warpgroup: its thread 0 keeps the ring full
      reg_dealloc<PRODUCER_REGS>();
      if (threadIdx.x == 256) {
        load_q();
        for (int it = 0; it < n; ++it) {
          if (it >= ST) mbar_wait(empty0 + 8 * (it % ST), (it / ST - 1) & 1);
          load_kv(it);
        }
      }
    }
  } else {
    if constexpr (TL::PWG) {
      reg_alloc<CONSUMER_REGS>();
    } else if (threadIdx.x == 0) {
      load_q();
      for (int i = 0; i < min(ST, n); ++i) load_kv(i);
    }
    const int tid = threadIdx.x & 127, w = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int qa = q0 + 64 * wg, qz = min(qa + 63, a.Sq - 1);
    const int r0 = qa + 16 * w + g;          // this thread's rows: r0 and r0 + 8
    const uint32_t qrow = sq + 64 * wg * 128;  // this warpgroup's 64 rows of q
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // running max (base-2 units) and sum of this lane's columns of each row
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
    const float c = a.scale * LOG2E;
    mbar_wait(qbar, 0);
    for (int it = 0; it < n; ++it) {
      const int s = it % ST;
      mbar_wait(full0 + 8 * s, (it / ST) & 1);
      const int k0 = (kt0 + it) * BK, kz = min(k0 + BK, a.Sk) - 1;
      if (block_live(a, qa, qz, k0, kz)) {
        const uint32_t kd = skv + s * 2 * TL::KV_BYTES, vd = kd + TL::KV_BYTES;
        // s = q k^T over head_dim
        float sc[BK / 2];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BK>(sc, kmajor_desc(qrow + (kk >> 2) * BQ * 128 + (kk & 3) * 32),
                       kmajor_desc(kd + (kk >> 2) * BK * 128 + (kk & 3) * 32), kk > 0);
        wg_commit();
        wg_wait<0>();
        fence_regs(sc);

        // online softmax on the accumulator layout, in base 2: sc[4 j + e]
        // is (row r0 + 8 (e / 2), key k0 + 8 j + 2 t + e % 2). On a tile that
        // some of the warpgroup's rows see in part, masked scores and keys
        // past Sk become -inf (p = 0). The reference gives a masked score
        // -1e30 instead, which takes part in the max: m starts at -1e30, so
        // the max is the same, and p differs only in a row that has seen no
        // key yet, whose terms the first visible key wipes (alpha = 0) in
        // both; rows that never see a key are refused by the wrapper.
        if (kz != k0 + BK - 1 || !block_full(a, qa, qz, k0, kz)) {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kpos = k0 + 8 * j + 2 * t + (e & 1);
              if (kpos >= a.Sk || !visible(a, r0 + 8 * (e >> 1), kpos))
                sc[4 * j + e] = __int_as_float(0xff800000);
            }
        }
        // the row max of the raw scores (the scale is positive), in base-2
        // units, then p = 2^(s c - m): one FFMA and one MUFU a score
        float mx[2] = {sc[0], sc[2]};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          mx[r] = fmaxf(m[r], mx[r] * c);
          alpha[r] = ex2(m[r] - mx[r]);
          m[r] = mx[r];
          l[r] *= alpha[r];
        }
        // p, rounded to bfloat16, as the A registers of o += p v: columns
        // 16 kk .. 16 kk + 15 of the accumulator are k-step kk
        uint32_t pf[BK / 16][4];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = ex2(fmaf(sc[4 * j + e], c, -m[e >> 1]));   // 2^-inf = 0
            l[e >> 1] += p[e];
          }
          pf[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
          pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
        // o += p v over the tile's keys, v read MN-major
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<D>(o, pf[kk], mnmajor_desc(vd + kk * 2048, BK * 128));
        wg_commit();
        wg_wait<0>();
        fence_regs(o);
        fence_regs(pf);
      }
      if (tid == 0) {
        if constexpr (TL::PWG) {
          mbar_arrive(empty0 + 8 * s);
        } else {
          release_and_refill(rel0 + 4 * s, it + ST, n, load_kv);   // D 256
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int qpos = r0 + 8 * r;
      if (qpos >= a.Sq) continue;
      const float lc = fmaxf(l[r], 1e-30f), inv = 1.f / lc;
      __nv_bfloat16* row = a.o + (((long long)b * a.Sq + qpos) * a.Hq + h) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store_bf16x2(row + 8 * j, o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      if (t == 0) a.lse[((long long)b * a.Hq + h) * a.Sq + qpos] = m[r] * LN2 + logf(lc);
    }
  }
}

// ---------------------------------------------------------------------------
// K10: dq
// ---------------------------------------------------------------------------

template <int D> struct DqSm90 {
  // D 64, 128: kv tiles of 64 keys in four stages; D 256: tiles of 32 keys
  // in three stages (q and do 128 KB + 3 x 32 KB)
  static constexpr int BQ = 128, BK = D == 256 ? 32 : 64, ST = D == 256 ? 3 : 4, NB = D / 64;
  static constexpr uint32_t Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  // q, do; ST x (k, v); qbar, full[ST], each stage's releases so far
  static constexpr uint32_t BAR = 2 * Q_BYTES + ST * 2 * KV_BYTES;
  static constexpr uint32_t SMEM = BAR + 1024 + 1024;
  static_assert(SMEM <= 232448, "a block's shared memory on the H100");
};

template <int D>
__global__ void __launch_bounds__(NT_DKV, 1)
    flash_dq_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                  const Args a) {
  using TL = DqSm90<D>;
  constexpr int BQ = TL::BQ, BK = TL::BK, ST = TL::ST, NB = TL::NB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sd = sq + TL::Q_BYTES;
  const uint32_t skv = sd + TL::Q_BYTES;     // stage s: k at skv + 2 s KV_BYTES, v after it
  const uint32_t qbar = sq + TL::BAR;
  const uint32_t full0 = qbar + 8, rel0 = full0 + 8 * ST;
  const int qt = gridDim.y - 1 - blockIdx.y, h = blockIdx.x % a.Hq, b = blockIdx.x / a.Hq;
  const int hk = h / (a.Hq / a.Hkv), q0 = qt * BQ;
  // kv tiles that rows [q0, q0 + BQ) can see
  int lo, hi;
  kv_range(a, q0, min(q0 + BQ, a.Sq) - 1, lo, hi);
  const int kt0 = lo / BK, n = max(0, (hi + BK - 1) / BK - kt0);
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      sts_u32(rel0 + 4 * s, 0);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // Thread 0 issues q and do once and the first ST tiles; then the second
  // warpgroup to release a stage loads k and v of the tile ST on into it.
  const auto load_kv = [&](int i) {
    const int s = i % ST, k0 = (kt0 + i) * BK;
    const uint32_t kd = skv + s * 2 * TL::KV_BYTES, vd = kd + TL::KV_BYTES;
    mbar_expect_tx(full0 + 8 * s, 2 * TL::KV_BYTES);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      tma_load_4d(kd + c * BK * 128, &tk, full0 + 8 * s, 64 * c, k0, hk, b);
      tma_load_4d(vd + c * BK * 128, &tv, full0 + 8 * s, 64 * c, k0, hk, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(qbar, 2 * TL::Q_BYTES);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      tma_load_4d(sq + c * BQ * 128, &tq, qbar, 64 * c, q0, h, b);
      tma_load_4d(sd + c * BQ * 128, &tdo, qbar, 64 * c, q0, h, b);
    }
    for (int i = 0; i < min(ST, n); ++i) load_kv(i);
  }

  const int wg = threadIdx.x / 128, tid = threadIdx.x & 127, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qa = q0 + 64 * wg, qz = min(qa + 63, a.Sq - 1);
  const int r0 = qa + 16 * w + g;          // this thread's rows: r0 and r0 + 8
  // this warpgroup's 64 rows of q and do as wgmma A operands
  const uint32_t qrow = sq + 64 * wg * 128, drow = sd + 64 * wg * 128;
  // the rows' lse log2(e) and delta scale (a row past Sq reads the last
  // row; its p is masked to 0)
  float lq[2], dl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const long long i = ((long long)b * a.Hq + h) * a.Sq + min(r0 + 8 * e, a.Sq - 1);
    lq[e] = __ldg(a.lse_in + i) * LOG2E;
    dl[e] = __ldg(a.delta + i) * a.scale;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  const float c = a.scale * LOG2E;
  mbar_wait(qbar, 0);
  for (int it = 0; it < n; ++it) {
    const int s = it % ST;
    const int k0 = (kt0 + it) * BK, kz = min(k0 + BK, a.Sk) - 1;
    mbar_wait(full0 + 8 * s, (it / ST) & 1);
    if (block_live(a, qa, qz, k0, kz)) {
      const uint32_t kd = skv + s * 2 * TL::KV_BYTES, vd = kd + TL::KV_BYTES;
      // s = q k^T and dp = do v^T over head_dim
      float sc[BK / 2], dp[BK / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(sc, kmajor_desc(qrow + (kk >> 2) * BQ * 128 + (kk & 3) * 32),
                     kmajor_desc(kd + (kk >> 2) * BK * 128 + (kk & 3) * 32), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BK>(dp, kmajor_desc(drow + (kk >> 2) * BQ * 128 + (kk & 3) * 32),
                     kmajor_desc(vd + (kk >> 2) * BK * 128 + (kk & 3) * 32), kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // sc[4 j + e] is (row r0 + 8 (e / 2), key k0 + 8 j + 2 t + e % 2).
      // Where the tile is not wholly visible to the warpgroup's rows, hidden
      // pairs, keys past Sk and rows past Sq get s = -inf, p = 0 (the
      // reference: exp(-1e30 - lse) = 0).
      if (kz != k0 + BK - 1 || qz != qa + 63 || !block_full(a, qa, qz, k0, kz)) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qpos = r0 + 8 * (e >> 1), kpos = k0 + 8 * j + 2 * t + (e & 1);
            if (kpos >= a.Sk || qpos >= a.Sq || !visible(a, qpos, kpos))
              sc[4 * j + e] = __int_as_float(0xff800000);
          }
      }
      // ds = p (dp scale - delta scale), split into the hi and lo A
      // registers of dq += ds k: columns 16 kk .. 16 kk + 15 of the
      // accumulator are k-step kk
      uint32_t sh[BK / 16][4], sl[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(sc[4 * j + e], c, -lq[e >> 1]));   // 2^-inf = 0
          d[e] = p * fmaf(dp[4 * j + e], a.scale, -dl[e >> 1]);
        }
        const int f = (j & 1) * 2;
        split_bf16x2(d[0], d[1], sh[j >> 1][f], sl[j >> 1][f]);
        split_bf16x2(d[2], d[3], sh[j >> 1][f + 1], sl[j >> 1][f + 1]);
      }
      // dq += ds k over the tile's keys, k read MN-major
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t bk = mnmajor_desc(kd + kk * 2048, BK * 128);
        wgmma_rs<D>(dq, sh[kk], bk);
        wgmma_rs<D>(dq, sl[kk], bk);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(dq);
      fence_regs(sh);
      fence_regs(sl);
    }
    if (tid == 0) release_and_refill(rel0 + 4 * s, it + ST, n, load_kv);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = r0 + 8 * r;
    if (qpos >= a.Sq) continue;
    __nv_bfloat16* row = a.dq + (((long long)b * a.Sq + qpos) * a.Hq + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store_bf16x2(row + 8 * j, dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------------------
// K11: dk, dv
// ---------------------------------------------------------------------------

template <int D> struct DkvSm90 {
  // D 64, 128: 128 keys a CTA, 64 a warpgroup, each with its dk and dv, q
  // and do in parts of 32 queries; D 256: 64 keys a CTA, shared by the two
  // warpgroups by role (dv and dk), parts of 64 queries, and two buffers
  // of p^T between them (226 KB of shared memory in all)
  static constexpr bool ROLES = D == 256;
  static constexpr int BK = ROLES ? 64 : 128, BQ = 64, QH = ROLES ? 64 : 32;
  static constexpr int ST = ROLES ? 2 : 3, NB = D / 64;
  static constexpr uint32_t KV_BYTES = BK * D * 2, Q_BYTES = BQ * D * 2;
  static constexpr uint32_t X_BYTES = ROLES ? 2 * 64 * QH * 4 : 0;
  // k, v; ST x (q, do); the p^T buffers; kv, full[ST], empty[ST]
  static constexpr uint32_t BAR = 2 * KV_BYTES + ST * 2 * Q_BYTES + X_BYTES;
  static constexpr uint32_t SMEM = BAR + 1024 + 1024;
};

// K11 at D 64 and 128: each warpgroup 64 of the CTA's 128 keys, dk and dv
// in its registers.
template <int D>
__device__ __forceinline__ void dkv_pairs(const CUtensorMap& tq, const CUtensorMap& tk,
                                          const CUtensorMap& tv, const CUtensorMap& tdo,
                                          const Args& a) {
  using TL = DkvSm90<D>;
  constexpr int BK = TL::BK, BQ = TL::BQ, QH = TL::QH, ST = TL::ST, NB = TL::NB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sk = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sv = sk + TL::KV_BYTES;
  const uint32_t sqd = sv + TL::KV_BYTES;    // stage s: q at sqd + 2 s Q_BYTES, do after it
  const uint32_t kvbar = sk + TL::BAR;
  const uint32_t full0 = kvbar + 8, empty0 = full0 + 8 * ST;
  const int kt = blockIdx.y, hk = blockIdx.x % a.Hkv, b = blockIdx.x / a.Hkv;
  const int G = a.Hq / a.Hkv;
  const int k0 = kt * BK, k1 = min(k0 + BK, a.Sk) - 1;
  // q rows that can see keys [k0, k1]: tiles [qt0, qt0 + nq) of every query
  // head of the group, walked as one sequence it = gq * nq + (qt - qt0)
  const int qlo = a.causal ? k0 : 0;
  const int qhi = a.window > 0 ? min(a.Sq, k1 + a.window) : a.Sq;
  const int qt0 = qlo / BQ, nq = qhi > qlo ? (qhi + BQ - 1) / BQ - qt0 : 0;
  const int n_it = G * nq;
  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // The producer: thread 0 issues every TMA load, k and v once, then q and
  // do of tile i into stage i % ST once both warpgroups have released tile
  // i - ST.
  const auto load_qdo = [&](int i) {
    const int s = i % ST, h = hk * G + i / nq, q0 = (qt0 + i % nq) * BQ;
    const uint32_t qd = sqd + s * 2 * TL::Q_BYTES, dd = qd + TL::Q_BYTES;
    mbar_expect_tx(full0 + 8 * s, 2 * TL::Q_BYTES);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      tma_load_4d(qd + c * BQ * 128, &tq, full0 + 8 * s, 64 * c, q0, h, b);
      tma_load_4d(dd + c * BQ * 128, &tdo, full0 + 8 * s, 64 * c, q0, h, b);
    }
  };
  if (threadIdx.x == 0 && n_it > 0) {
    mbar_expect_tx(kvbar, 2 * TL::KV_BYTES);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      tma_load_4d(sk + c * BK * 128, &tk, kvbar, 64 * c, k0, hk, b);
      tma_load_4d(sv + c * BK * 128, &tv, kvbar, 64 * c, k0, hk, b);
    }
    for (int i = 0; i < min(ST, n_it); ++i) load_qdo(i);
  }

  const int wg = threadIdx.x / 128, tid = threadIdx.x & 127, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ka = k0 + 64 * wg, kz = min(ka + 63, a.Sk - 1);
  const int r0 = ka + 16 * w + g;          // this thread's keys: r0 and r0 + 8
  // this warpgroup's 64 rows of k and v as wgmma A operands
  const uint64_t desc_k = kmajor_desc(sk + 64 * wg * 128);
  const uint64_t desc_v = kmajor_desc(sv + 64 * wg * 128);
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  const float c = a.scale * LOG2E;
  if (n_it > 0) mbar_wait(kvbar, 0);
  for (int it = 0; it < n_it; ++it) {
    // refill the stage of tile it - 1, which this warpgroup has released,
    // once the other one has too: the ring runs ST - 1 tiles ahead
    if (threadIdx.x == 0 && it >= 1 && it - 1 + ST < n_it) {
      mbar_wait(empty0 + 8 * ((it - 1) % ST), ((it - 1) / ST) & 1);
      load_qdo(it - 1 + ST);
    }
    const int s = it % ST;
    const int q0 = (qt0 + it % nq) * BQ;
    const long long row = ((long long)b * a.Hq + hk * G + it / nq) * a.Sq;
    const uint32_t qd = sqd + s * 2 * TL::Q_BYTES, dd = qd + TL::Q_BYTES;
    mbar_wait(full0 + 8 * s, (it / ST) & 1);
    // the tile's queries in parts of QH: per part, 2 x D / 16 wgmma
    // m64nQHk16 from shared memory and 4 x QH / 16 m64nDk16 with A in
    // registers
#pragma unroll 1
    for (int hq = 0; hq < BQ; hq += QH) {
      const int qa = q0 + hq, qz = min(qa + QH, a.Sq) - 1;
      if (!block_live(a, qa, qz, ka, kz)) continue;
      // this thread's queries' lse log2(e) and delta scale (a query past Sq
      // reads the last row; its p is 0)
      float lq[QH / 8][2], dl[QH / 8][2];
#pragma unroll
      for (int j = 0; j < QH / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long i = row + min(qa + 8 * j + 2 * t + e, a.Sq - 1);
          lq[j][e] = __ldg(a.lse_in + i) * LOG2E;
          dl[j][e] = __ldg(a.delta + i) * a.scale;
        }
      // s^T = k q^T and dp^T = v do^T over head_dim; a descriptor's start
      // address field moves by 16-byte units
      float sc[QH / 2], dp[QH / 2];
      const uint64_t dq0 = kmajor_desc(qd + hq * 128), dd0 = kmajor_desc(dd + hq * 128);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = ((kk >> 2) * BK * 128 + (kk & 3) * 32) >> 4;
        const uint32_t offq = ((kk >> 2) * BQ * 128 + (kk & 3) * 32) >> 4;
        wgmma_ss_n32(sc, desc_k + off, dq0 + offq, kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = ((kk >> 2) * BK * 128 + (kk & 3) * 32) >> 4;
        const uint32_t offq = ((kk >> 2) * BQ * 128 + (kk & 3) * 32) >> 4;
        wgmma_ss_n32(dp, desc_v + off, dd0 + offq, kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // sc[4 j + e] is (key r0 + 8 (e / 2), query qa + 8 j + 2 t + e % 2).
      // Where the part is not wholly visible, hidden pairs and keys past Sk
      // or queries past Sq get s = -inf, p = 0 (the reference: exp(-1e30 -
      // lse) = 0).
      if (kz != ka + 63 || qz != qa + QH - 1 || !block_full(a, qa, qz, ka, kz)) {
#pragma unroll
        for (int j = 0; j < QH / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = r0 + 8 * (e >> 1), qpos = qa + 8 * j + 2 * t + (e & 1);
            if (kpos >= a.Sk || qpos >= a.Sq || !visible(a, qpos, kpos))
              sc[4 * j + e] = __int_as_float(0xff800000);
          }
      }
      // p^T = 2^(s^T scale log2(e) - lse log2(e)), ds^T = p^T (dp^T scale -
      // delta scale), each split into the hi and lo A registers of dv +=
      // p^T do and dk += ds^T q
      uint32_t ph[QH / 16][4], pl[QH / 16][4], sh[QH / 16][4], sl[QH / 16][4];
#pragma unroll
      for (int j = 0; j < QH / 8; ++j) {
        float p[4], d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = ex2(fmaf(sc[4 * j + e], c, -lq[j][e & 1]));
          d[e] = p[e] * fmaf(dp[4 * j + e], a.scale, -dl[j][e & 1]);
        }
        const int f = (j & 1) * 2;
        split_bf16x2(p[0], p[1], ph[j >> 1][f], pl[j >> 1][f]);
        split_bf16x2(p[2], p[3], ph[j >> 1][f + 1], pl[j >> 1][f + 1]);
        split_bf16x2(d[0], d[1], sh[j >> 1][f], sl[j >> 1][f]);
        split_bf16x2(d[2], d[3], sh[j >> 1][f + 1], sl[j >> 1][f + 1]);
      }

      // dv += p^T do, dk += ds^T q over the part's queries, do and q read
      // MN-major
      const uint64_t bd0 = mnmajor_desc(dd + hq * 128, BQ * 128);
      const uint64_t bq0 = mnmajor_desc(qd + hq * 128, BQ * 128);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < QH / 16; ++kk) {
        const uint32_t off = (16 * kk * 128) >> 4;
        wgmma_rs<D>(dv, ph[kk], bd0 + off);
        wgmma_rs<D>(dv, pl[kk], bd0 + off);
        wgmma_rs<D>(dk, sh[kk], bq0 + off);
        wgmma_rs<D>(dk, sl[kk], bq0 + off);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(ph);
      fence_regs(pl);
      fence_regs(sh);
      fence_regs(sl);
    }
    if (tid == 0) mbar_arrive(empty0 + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = r0 + 8 * r;
    if (kpos >= a.Sk) continue;
    const long long off = (((long long)b * a.Sk + kpos) * a.Hkv + hk) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store_bf16x2(a.dk + off + 8 * j, dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      store_bf16x2(a.dv + off + 8 * j, dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// K11 at D 256: the CTA's 64 keys shared by the two warpgroups by role.
// Warpgroup 0 forms s^T = k q^T and p^T, hands p^T to warpgroup 1 through
// shared memory and accumulates dv += p^T do; warpgroup 1 forms dp^T = v
// do^T, ds^T from the p^T it was handed, and accumulates dk += ds^T q. Each
// holds one 64 x D accumulator. The two products of a part are the same
// instructions in both warpgroups on other operands.
template <int D>
__device__ __forceinline__ void dkv_roles(const CUtensorMap& tq, const CUtensorMap& tk,
                                          const CUtensorMap& tv, const CUtensorMap& tdo,
                                          const Args& a) {
  using TL = DkvSm90<D>;
  constexpr int BK = TL::BK, BQ = TL::BQ, QH = TL::QH, ST = TL::ST, NB = TL::NB;
  constexpr int XFULL = 1, XEMPTY = 3;   // named barriers of p^T buffers 0 and 1
  constexpr uint32_t XBUF = QH / 2 * 128 * 4;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sk = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sv = sk + TL::KV_BYTES;
  const uint32_t sqd = sv + TL::KV_BYTES;    // stage s: q at sqd + 2 s Q_BYTES, do after it
  const uint32_t sx = sqd + ST * 2 * TL::Q_BYTES;   // buffer i: word e of thread t at 512 e + 4 t
  const uint32_t kvbar = sk + TL::BAR;
  const uint32_t full0 = kvbar + 8, rel0 = full0 + 8 * ST;   // rel: a stage's releases
  const int kt = blockIdx.y, hk = blockIdx.x % a.Hkv, b = blockIdx.x / a.Hkv;
  const int G = a.Hq / a.Hkv;
  const int k0 = kt * BK, k1 = min(k0 + BK, a.Sk) - 1;
  // q rows that can see keys [k0, k1]: tiles [qt0, qt0 + nq) of every query
  // head of the group, walked as one sequence it = gq * nq + (qt - qt0)
  const int qlo = a.causal ? k0 : 0;
  const int qhi = a.window > 0 ? min(a.Sq, k1 + a.window) : a.Sq;
  const int qt0 = qlo / BQ, nq = qhi > qlo ? (qhi + BQ - 1) / BQ - qt0 : 0;
  const int n_it = G * nq;
  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      sts_u32(rel0 + 4 * s, 0);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // Thread 0 loads k and v once and the first ST tiles of q and do; the
  // second warpgroup to release a stage loads tile i + ST into it.
  const auto load_qdo = [&](int i) {
    const int s = i % ST, h = hk * G + i / nq, q0 = (qt0 + i % nq) * BQ;
    const uint32_t qd = sqd + s * 2 * TL::Q_BYTES, dd = qd + TL::Q_BYTES;
    mbar_expect_tx(full0 + 8 * s, 2 * TL::Q_BYTES);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      tma_load_4d(qd + c * BQ * 128, &tq, full0 + 8 * s, 64 * c, q0, h, b);
      tma_load_4d(dd + c * BQ * 128, &tdo, full0 + 8 * s, 64 * c, q0, h, b);
    }
  };
  if (threadIdx.x == 0 && n_it > 0) {
    mbar_expect_tx(kvbar, 2 * TL::KV_BYTES);
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      tma_load_4d(sk + c * BK * 128, &tk, kvbar, 64 * c, k0, hk, b);
      tma_load_4d(sv + c * BK * 128, &tv, kvbar, 64 * c, k0, hk, b);
    }
    for (int i = 0; i < min(ST, n_it); ++i) load_qdo(i);
  }

  const int wg = threadIdx.x / 128, tid = threadIdx.x & 127, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = k0 + 16 * w + g;          // this thread's keys: r0 and r0 + 8
  const bool pside = wg == 0;              // warpgroup 0: p^T and dv; 1: ds^T and dk
  // A of the first product: k (s^T = k q^T) or v (dp^T = v do^T)
  const uint64_t desc_a = kmajor_desc(pside ? sk : sv);
  float acc[D / 2];                        // dv or dk of the CTA's 64 keys
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const float c = a.scale * LOG2E;
  int live = 0;                            // parts formed (the same in both warpgroups)
  if (n_it > 0) mbar_wait(kvbar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % ST;
    const int q0 = (qt0 + it % nq) * BQ;
    const long long row = ((long long)b * a.Hq + hk * G + it / nq) * a.Sq;
    const uint32_t qd = sqd + s * 2 * TL::Q_BYTES, dd = qd + TL::Q_BYTES;
    // B of the first product (q or do, K-major) and of the second (do or q,
    // MN-major)
    const uint32_t b1 = pside ? qd : dd, b2 = pside ? dd : qd;
    mbar_wait(full0 + 8 * s, (it / ST) & 1);
#pragma unroll 1
    for (int hq = 0; hq < BQ; hq += QH) {
      const int qa = q0 + hq, qz = min(qa + QH, a.Sq) - 1;
      if (!block_live(a, qa, qz, k0, k1)) continue;
      // this thread's queries' lse log2(e) (warpgroup 0) or delta scale
      // (warpgroup 1); a query past Sq reads the last row, its p is 0
      float rs[QH / 8][2];
#pragma unroll
      for (int j = 0; j < QH / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long i = row + min(qa + 8 * j + 2 * t + e, a.Sq - 1);
          rs[j][e] = pside ? __ldg(a.lse_in + i) * LOG2E : __ldg(a.delta + i) * a.scale;
        }
      // s^T = k q^T or dp^T = v do^T over head_dim
      float sc[QH / 2];
      const uint64_t d1 = kmajor_desc(b1 + hq * 128);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = ((kk >> 2) * BK * 128 + (kk & 3) * 32) >> 4;
        const uint32_t offq = ((kk >> 2) * BQ * 128 + (kk & 3) * 32) >> 4;
        wgmma_ss<QH>(sc, desc_a + off, d1 + offq, kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);

      // sc[4 j + e] is (key r0 + 8 (e / 2), query qa + 8 j + 2 t + e % 2).
      // p^T and ds^T, each split into the hi and lo A registers of the
      // second product
      const uint32_t xb = sx + (live & 1) * XBUF + 4 * tid;
      uint32_t th[QH / 16][4], tl[QH / 16][4];
      if (pside) {
        // where the part is not wholly visible, hidden pairs and keys past
        // Sk or queries past Sq get s = -inf, p = 0
        if (k1 != k0 + BK - 1 || qz != qa + QH - 1 || !block_full(a, qa, qz, k0, k1)) {
#pragma unroll
          for (int j = 0; j < QH / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kpos = r0 + 8 * (e >> 1), qpos = qa + 8 * j + 2 * t + (e & 1);
              if (kpos >= a.Sk || qpos >= a.Sq || !visible(a, qpos, kpos))
                sc[4 * j + e] = __int_as_float(0xff800000);
            }
        }
        // the buffer is free once warpgroup 1 has read the part before last
        if (live >= 2) bar_sync(XEMPTY + (live & 1), 2 * 128);
#pragma unroll
        for (int j = 0; j < QH / 8; ++j) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = ex2(fmaf(sc[4 * j + e], c, -rs[j][e & 1]));
            sts_f32(xb + 512 * (4 * j + e), p[e]);
          }
          const int f = (j & 1) * 2;
          split_bf16x2(p[0], p[1], th[j >> 1][f], tl[j >> 1][f]);
          split_bf16x2(p[2], p[3], th[j >> 1][f + 1], tl[j >> 1][f + 1]);
        }
        bar_arrive(XFULL + (live & 1), 2 * 128);
      } else {
        bar_sync(XFULL + (live & 1), 2 * 128);
#pragma unroll
        for (int j = 0; j < QH / 8; ++j) {
          float d[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            d[e] = lds_f32(xb + 512 * (4 * j + e)) * fmaf(sc[4 * j + e], a.scale, -rs[j][e & 1]);
          const int f = (j & 1) * 2;
          split_bf16x2(d[0], d[1], th[j >> 1][f], tl[j >> 1][f]);
          split_bf16x2(d[2], d[3], th[j >> 1][f + 1], tl[j >> 1][f + 1]);
        }
        bar_arrive(XEMPTY + (live & 1), 2 * 128);
      }
      ++live;

      // dv += p^T do or dk += ds^T q over the part's queries, do or q read
      // MN-major
      const uint64_t d2 = mnmajor_desc(b2 + hq * 128, BQ * 128);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < QH / 16; ++kk) {
        const uint32_t off = (16 * kk * 128) >> 4;
        wgmma_rs<D>(acc, th[kk], d2 + off);
        wgmma_rs<D>(acc, tl[kk], d2 + off);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
      fence_regs(th);
      fence_regs(tl);
    }
    if (tid == 0) release_and_refill(rel0 + 4 * s, it + ST, n_it, load_qdo);
  }
  // every arrival on a named barrier is waited for: warpgroup 0 waits out
  // warpgroup 1's release of the last two buffers
  if (pside)
    for (int j = max(0, live - 2); j < live; ++j) bar_sync(XEMPTY + (j & 1), 2 * 128);

  __nv_bfloat16* out = pside ? a.dv : a.dk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = r0 + 8 * r;
    if (kpos >= a.Sk) continue;
    const long long off = (((long long)b * a.Sk + kpos) * a.Hkv + hk) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store_bf16x2(out + off + 8 * j, acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(NT_DKV, 1)
    flash_dkv_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const Args a) {
  if constexpr (DkvSm90<D>::ROLES) dkv_roles<D>(tq, tk, tv, tdo, a);
  else dkv_pairs<D>(tq, tk, tv, tdo, a);
}

enum Pass { FWD = 0, DQ = 1, DKV = 2 };

struct Strides {
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, d_sb, d_ss, d_sh;
};

template <typename Kernel>
int set_smem(Kernel kernel, uint32_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
int launch(int pass, const Args& a, const void* q, const void* k, const void* v, const void* dout,
           const Strides& st, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  // the tensor maps of the pass's tiles: q and do in boxes of qrows, k and v
  // of krows
  const auto maps = [&](int qrows, int krows) {
    return bf16_map(&tq, q, D, a.Sq, a.Hq, a.B, st.q_ss, st.q_sh, st.q_sb, qrows) &&
           bf16_map(&tk, k, D, a.Sk, a.Hkv, a.B, st.k_ss, st.k_sh, st.k_sb, krows) &&
           bf16_map(&tv, v, D, a.Sk, a.Hkv, a.B, st.v_ss, st.v_sh, st.v_sb, krows) &&
           (pass == FWD ||
            bf16_map(&tdo, dout, D, a.Sq, a.Hq, a.B, st.d_ss, st.d_sh, st.d_sb, qrows));
  };
  if (pass == FWD) {
    using TL = FwdSm90<D>;
    if (!maps(TL::BQ, TL::BK)) return (int)cudaErrorInvalidPitchValue;
    int err = set_smem(flash_fwd_sm90<D>, TL::SMEM);
    if (err) return err;
    const dim3 grid(a.Hq * a.B, (a.Sq + TL::BQ - 1) / TL::BQ);
    flash_fwd_sm90<D><<<grid, TL::NT, TL::SMEM, stream>>>(tq, tk, tv, a);
  } else if (pass == DQ) {
    using TL = DqSm90<D>;
    if (!maps(TL::BQ, TL::BK)) return (int)cudaErrorInvalidPitchValue;
    int err = set_smem(flash_dq_sm90<D>, TL::SMEM);
    if (err) return err;
    const dim3 grid(a.Hq * a.B, (a.Sq + TL::BQ - 1) / TL::BQ);
    flash_dq_sm90<D><<<grid, NT_DKV, TL::SMEM, stream>>>(tq, tk, tv, tdo, a);
  } else {
    using TL = DkvSm90<D>;
    if (!maps(TL::BQ, TL::BK)) return (int)cudaErrorInvalidPitchValue;
    int err = set_smem(flash_dkv_sm90<D>, TL::SMEM);
    if (err) return err;
    const dim3 grid(a.Hkv * a.B, (a.Sk + TL::BK - 1) / TL::BK);
    flash_dkv_sm90<D><<<grid, NT_DKV, TL::SMEM, stream>>>(tq, tk, tv, tdo, a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface of csrc/flash_attention.cu's flash_attention_launch, for
// the passes and types this file covers: dtype 1 (bfloat16), passes 0 (K9),
// 1 (K10) and 2 (K11) at D 64, 128 and 256; dq is written contiguous (B,
// Sq, Hq, D). Strides are in elements and
// must be multiples of 8 (16 bytes) with 16-byte aligned bases, as TMA
// reads them (the wrapper copies other views); a tensor map the driver
// refuses returns cudaErrorInvalidPitchValue. Returns cudaGetLastError()
// after the launch.
extern "C" int flash_attention_sm90_launch(
    int pass, int dtype, int D, const void* q, const void* k, const void* v, const void* dout,
    const float* lse_in, const float* delta, void* o, float* lse, void* dq, void* dk, void* dv,
    int B, int Sq, int Sk, int Hq, int Hkv, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long d_sb, long long d_ss, long long d_sh, int causal, int window,
    float scale, void* stream) {
  cudaGetLastError();  // clear any stale error from an earlier call
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || dtype != 1 ||
      (pass != FWD && pass != DQ && pass != DKV) || (window > 0 && Sq > Sk + window - 1))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.lse_in = lse_in; a.delta = delta;
  a.o = static_cast<__nv_bfloat16*>(o); a.lse = lse; a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk); a.dv = static_cast<__nv_bfloat16*>(dv);
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv;
  a.causal = causal; a.window = window; a.scale = scale;
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, d_sb, d_ss, d_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(pass, a, q, k, v, dout, st, s);
    case 128: return launch<128>(pass, a, q, k, v, dout, st, s);
    case 256: return launch<256>(pass, a, q, k, v, dout, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
