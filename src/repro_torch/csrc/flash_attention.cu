// Flash attention on Hopper (sm_90a): forward, dq pass and dk/dv pass.
//
// Replaces the Pallas TPU kernels of repro/kernels/flash_attention.py:
//   K9  _fwd_kernel via _flash_fwd (pallas_call :107)  -> flash_fwd_kernel
//   K10 _dq_kernel  via _flash_bwd (pallas_call :218)  -> flash_dq_kernel
//   K11 _dkv_kernel via _flash_bwd (pallas_call :243)  -> flash_dkv_kernel
// q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) are read in that layout through
// their batch / sequence / head strides (head_dim contiguous), so no
// transpose copies are made; query head h reads kv head h / (Hq / Hkv).
// Scores are s = (q . k) * scale, masked to -1e30 (float32) where the causal
// (qpos >= kpos) or window (qpos - kpos < window) mask drops them, positions
// counted from 0 in both sequences, as the reference.
//   K9:  running (m, l, acc) online softmax; o = acc / max(l, 1e-30) in q's
//        type, lse = m + log(max(l, 1e-30)) in float32.
//   K10: p = exp(s - lse), dp = do . v, ds = p (dp - delta) scale,
//        dq = sum ds k, delta = rowsum(do * o) from the caller.
//   K11: dv = sum_q p do, dk = sum_q ds q, summed over the group's query
//        heads inside the kernel (the reference sums per-head float32
//        results outside it), written in k's type.
// Inputs are float32 or bfloat16. All three run their products on the TF32
// tensor cores in split precision, which keeps float32's accuracy (below).
// Tiles are staged in shared memory as float32.
//
// Masked tiles: a kv tile that no row of a warp's 16 query rows can see
// (causal: above the diagonal; window: before it) is skipped by that warp.
// The reference visits every tile and lets masked scores add exp(0) terms
// to (l, acc) until the first visible score wipes them with alpha =
// exp(m_prev - m_new) = 0, so skipping gives the same function wherever a
// row sees at least one key. Rows that see none (a window with Sq > Sk +
// window - 1) are refused by the wrapper. Keys past Sk (the ragged last
// tile) get p = 0 exactly; query rows past Sq are computed on zeros and
// never written.
//
// What bounds them on the H100: operations. At qwen3-8b's training shape
// (B=1, S=4096, 32 query heads, D=128, causal) a product over the causal
// half is 68.7e9 multiply-adds against at most ~200 MB of operands.
//
//   * Split precision ("3xTF32", csrc/tf32x3.cuh, as csrc/grouped_matmul.cu):
//     each float32 operand of an mma.sync.m16n8k8 TF32 fragment is split
//     into hi and a remainder lo (an AND and an FADD), and each product
//     issues lo*hi, hi*lo, hi*hi. A bfloat16 input widened to float32 is
//     already a TF32 value, so the products of two inputs (s = q k^T, dp =
//     do v^T) take hi*hi alone and those with p or ds (float32) take two
//     passes.
//   * The tensor cores truncate as they add into a float32 accumulator, and
//     o and dq sum over up to Sk keys, dk and dv over up to Sq x G queries.
//     So every product is summed on the tensor cores from zero over one
//     tile of its contraction (32 of head_dim for s and dp, one kv tile for
//     o and dq, one q tile for dk and dv) and that partial tile is added to
//     the running float32 sums by an FADD, which rounds to nearest (K9 folds
//     its rescale into it: o = o alpha + partial, one FFMA).
//   * mma.sync, not wgmma: TF32 wgmma reads both operands K-major from
//     shared memory, and four of the seven products contract over a
//     sequence axis whose operand lies d-contiguous (p v, ds k, p^T do,
//     ds^T q). mma.sync fragments load from shared memory in any
//     orientation.
//   * Bank conflicts: one float32 copy of each tile, rows of D + 4 floats,
//     serves both orientations. Where a product contracts over a sequence
//     axis the 8-wide k-step is paired (k = t is row 2t, k = t + 4 is row
//     2t + 1; the order of a contraction's terms is free), which is exactly
//     the column order of the score accumulator, so p, ds and p^T go from
//     the accumulators to the next product's A fragments without a shuffle,
//     and the B fragment rows 2t, 2t + 1 land on banks 8t + g: conflict-free
//     at D + 4. The d-contracting fragments (q, do, k, v as rows) load by
//     ldmatrix, four 8 x 4 float32 matrices an instruction, whose 8 rows
//     of D + 4 floats fall on 8 distinct 16-byte bank groups. No swizzle
//     and no second copy are needed. p^T and ds^T (K11) pass through shared
//     memory in rows of BQ + 8 floats, read as 8-byte pairs, also
//     conflict-free. K11 splits its resident k and v tiles once into a
//     plane of remainders beside them (up to D = 128), so their fragments
//     take no arithmetic in the q loop.
//   * Staging: float32 tiles arrive by 16-byte cp.async, double-buffered:
//     the next kv tile (K9, K10) or q / do tile (K11) is copied while the
//     current one computes, one barrier a tile (K11: two, around the p^T /
//     ds^T exchange). bfloat16 is widened through registers into the same
//     ring (synchronously).
//   * K9 and K10: a CTA of 8 warps owns 128 query rows (64 at D = 256) of
//     one (batch, head), 16 rows a warp, and walks kv tiles of 32 keys (K10
//     at D = 256: 16): each warp computes its rows' scores on the tensor
//     cores (K10 also dp), then in registers on the accumulator layout K9's
//     online softmax (a row's values sit in the 4 lanes of a quad: its max
//     takes two shfl_xor a tile, its sum stays per lane until the end) or
//     K10's ds, and adds p v to its o rows or ds k to its dq rows (all of
//     head_dim; at D = 256 two warps share 16 rows, 128 columns each, and
//     both compute the rows' scores). A warp skips a tile none of its rows
//     can see, and masks only a tile that some of its rows see in part.
//   * K11: a CTA of 8 warps owns 64 keys (32 at D = 256) of one (batch, kv
//     head) and walks the group's query heads and the q tiles of 32 rows (64
//     at D <= 64) the masks leave. Warps split s^T and dp^T as 16 keys x
//     the tile's queries / (8 / (keys / 16)), write p^T and ds^T to shared
//     memory, then split dk and dv as 16 keys x head_dim / (8 / (keys /
//     16)), each held in registers for the whole loop.
//   * Launch order: the grid is (heads x B) x tiles with the head fastest,
//     so CTAs start in order of their work over all heads (K9, K10: the last
//     q tiles first; K11: the first kv tiles, which the most q rows see) and
//     the smallest end the run. With the tile fastest, one head's largest
//     CTA starts only after the heads before it, and under a causal mask
//     the run waits on it.
//   * Deterministic: no atomics; every sum has a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace {

constexpr int NT = 256;          // 8 warps
constexpr float NEG = -1e30f;    // masked score, as the reference

struct FlashArgs {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  void *o, *dq, *dk, *dv;
  float* lse;
  int B, Sq, Sk, Hq, Hkv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, d_sb, d_ss, d_sh;
  int causal, window;   // window <= 0: none
  float scale;
};

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ bool visible(const FlashArgs& a, int qpos, int kpos) {
  return (!a.causal || qpos >= kpos) && (a.window <= 0 || qpos - kpos < a.window);
}

// kv range [lo, hi) that rows [q0, q1] can see.
__device__ __forceinline__ void kv_range(const FlashArgs& a, int q0, int q1, int& lo, int& hi) {
  hi = a.causal ? min(a.Sk, q1 + 1) : a.Sk;
  lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
}

// Whether any (query, key) pair of rows [qa, qb] x keys [ka, kb] is visible
// (empty ranges are not).
__device__ __forceinline__ bool block_live(const FlashArgs& a, int qa, int qb, int ka,
                                           int kb) {
  return qa <= qb && ka <= kb && (!a.causal || qb >= ka) &&
         (a.window <= 0 || qa - kb < a.window);
}

// Whether every (query, key) pair of rows [qa, qb] x keys [ka, kb] is visible.
__device__ __forceinline__ bool block_full(const FlashArgs& a, int qa, int qb, int ka,
                                           int kb) {
  return (!a.causal || qa >= kb) && (a.window <= 0 || qb - ka < a.window);
}

// R rows [row0, row0 + R) of one (batch, head) slice at `base` (row stride
// `rs` elements) into shared memory as float32 rows of SD floats, zeros at
// and past `nrows`. float32 goes by 16-byte cp.async (the wrapper aligns
// rows and bases to 16 bytes; a row past the edge is zero-filled by the
// copy's src-size operand), bfloat16 is widened through registers (load4).
template <typename T, int D, int R, int SD>
__device__ __forceinline__ void load_rows(float* s, const T* base, long long rs, int row0,
                                          int nrows) {
  constexpr int V4 = D / 4;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < R * V4; idx += NT) {
    const int r = idx / V4, c4 = idx - r * V4;
    const bool ok = row0 + r < nrows;
    const T* src = ok ? base + (long long)(row0 + r) * rs + c4 * 4 : base;
    float* dst = s + r * SD + c4 * 4;
    if constexpr (std::is_same<T, float>::value) {
      cp16(dst, src, ok);
    } else {
      *reinterpret_cast<float4*>(dst) = ok ? load4(src) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// K9 tiles: BQ query rows, 16 a warp row; BK keys a step; WC warps along
// head_dim in o += p v (at D = 256 two, so that a warp's o is 16 x 128;
// both compute the same scores).
template <int D> struct FwdTile {
  static constexpr int BQ = D <= 128 ? 128 : 64, BK = 32;
  static constexpr int WC = D <= 128 ? 1 : 2, SD = D + 4;
  static constexpr int FLOATS = BQ * SD + 4 * BK * SD;   // q, 2 x (k, v)
};

// K10 tiles: BQ query rows, 16 a warp row; BK keys a step; WC warps along
// head_dim in dq += ds k (at D = 256 two, so that a warp's dq is 16 x 128;
// both compute the same scores).
template <int D> struct DqTile {
  static constexpr int BQ = D <= 128 ? 128 : 64, BK = D <= 128 ? 32 : 16;
  static constexpr int WC = D <= 128 ? 1 : 2, SD = D + 4;
  static constexpr int FLOATS = 2 * BQ * SD + 4 * BK * SD;   // q, do, 2 x (k, v)
};

// K11 tiles: BK keys, 16 a warp row (WK warps); BQ queries a step; the
// other WO = 8 / WK warps split the scores along the queries and dk, dv
// along head_dim. p^T and ds^T pass through shared memory (rows of LP).
// Up to D = 128 the CTA's k and v tiles also get a plane of remainders
// each (split once for the whole q loop: the A fragments of s^T and dp^T
// load hi and lo with no arithmetic); at D = 256 they do not fit beside the
// q / do ring.
template <int D> struct DkvTile {
  static constexpr int BK = D <= 128 ? 64 : 32, BQ = D <= 64 ? 64 : 32;
  static constexpr int WK = BK / 16, WO = 8 / WK, SD = D + 4, LP = BQ + 8;
  static constexpr bool PLANES = D <= 128;
  // k, v (and their remainders), 2 x (q, do), p^T, ds^T
  static constexpr int FLOATS = (PLANES ? 4 : 2) * BK * SD + 4 * BQ * SD + 2 * BK * LP;
};

// ---------------------------------------------------------------------------
// K9: forward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1) flash_fwd_kernel(FlashArgs a) {
  using TL = FwdTile<D>;
  constexpr int BQ = TL::BQ, BK = TL::BK, WC = TL::WC, SD = TL::SD;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int NJS = BK / 8;               // score n-tiles (keys) of a warp
  constexpr int NJO = D / WC / 8;           // o n-tiles (head_dim) of a warp
  constexpr int KC = D < 32 ? D / 8 : 4;    // k-steps of one partial sum over head_dim
  constexpr int NG = NJO < 8 ? NJO : 8;     // o n-tiles summed together
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KV = Qs + BQ * SD;                 // stage s: k at KV + 2 s BK SD, v after it
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / WC * 16, wc = warp % WC * (D / WC);
  const int qt = gridDim.y - 1 - blockIdx.y, h = blockIdx.x % a.Hq, b = blockIdx.x / a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * BQ;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  int lo, hi;
  kv_range(a, q0, min(q0 + BQ, a.Sq) - 1, lo, hi);
  const int kt0 = lo / BK, kt1 = (hi + BK - 1) / BK;
  load_rows<T, D, BQ, SD>(Qs, static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss,
                          q0, a.Sq);
  if (kt0 < kt1) {
    load_rows<T, D, BK, SD>(KV, kb, a.k_ss, kt0 * BK, a.Sk);
    load_rows<T, D, BK, SD>(KV + BK * SD, vb, a.v_ss, kt0 * BK, a.Sk);
  }
  cp_commit();
  // this thread's rows: qa + g and qa + g + 8; l sums this lane's columns
  // only (the quad's four are added at the end)
  const int qa = q0 + wr, qz = min(qa + 15, a.Sq - 1);
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float o[NJO][4];
#pragma unroll
  for (int n = 0; n < NJO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) & 1;
    cp_wait<0>();
    __syncthreads();               // tile kt landed; every warp is done with tile kt - 1
    if (kt + 1 < kt1) {
      float* nx = KV + (st ^ 1) * 2 * BK * SD;
      load_rows<T, D, BK, SD>(nx, kb, a.k_ss, (kt + 1) * BK, a.Sk);
      load_rows<T, D, BK, SD>(nx + BK * SD, vb, a.v_ss, (kt + 1) * BK, a.Sk);
    }
    cp_commit();
    const int k0 = kt * BK, kz = min(k0 + BK, a.Sk) - 1;
    if (!block_live(a, qa, qz, k0, kz)) continue;
    const float* Ks = KV + st * 2 * BK * SD;
    const float* Vs = Ks + BK * SD;

    // s = q k^T over head_dim, KC k-steps a partial sum
    float sc[NJS][4];
#pragma unroll
    for (int j = 0; j < NJS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll 1
    for (int kc = 0; kc < D; kc += 8 * KC) {
      float ps[NJS][4];
#pragma unroll
      for (int j = 0; j < NJS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ps[j][e] = 0.f;
#pragma unroll
      for (int kk = kc; kk < kc + 8 * KC; kk += 8) {
        uint32_t qh[4], ql[4], kh[NJS][2], kl[NJS][2];
        frag_a<F32>(Qs, SD, wr, kk, lane, qh, ql);
#pragma unroll
        for (int j = 0; j < NJS; j += 2)
          frag_b_rows2<F32>(Ks, SD, 8 * j, kk, lane, kh[j], kl[j], kh[j + 1], kl[j + 1]);
        passes<F32, F32>(ps, qh, ql, kh, kl);
      }
#pragma unroll
      for (int j = 0; j < NJS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] += ps[j][e];
    }

    // online softmax on the accumulator layout: accumulator e of n-tile j
    // is (row qa + g + 8 (e / 2), key k0 + 8 j + 2 t + e % 2). The new
    // max spans the keys before Sk, masked scores included, as the
    // reference's; keys past Sk get p = 0.
    const bool full = kz == k0 + BK - 1 && block_full(a, qa, qz, k0, kz);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NJS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[j][e] * a.scale;
        const int kpos = k0 + 8 * j + 2 * t + (e & 1);
        if (!full) {
          if (!visible(a, qa + g + 8 * (e >> 1), kpos)) s = NEG;
          if (kpos >= a.Sk) s = __int_as_float(0xff800000);   // -inf
        }
        sc[j][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    // p as the A fragments of o += p v: accumulator e of n-tile j is A
    // element (e / 2) + 2 (e % 2) of k-step j, keys paired as frag_b_pairs
    // reads v
    uint32_t ph[NJS][4], pl[NJS][4];
#pragma unroll
    for (int j = 0; j < NJS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[j][e] - m[e >> 1]);   // exp(-inf) = 0 past Sk
        l[e >> 1] += p;
        split<true>(p, ph[j][(e >> 1) | ((e & 1) << 1)], pl[j][(e >> 1) | ((e & 1) << 1)]);
      }

    // o = o alpha + p v over the tile's keys, NG n-tiles at a time, each
    // tile's sum taken on the tensor cores from zero
#pragma unroll
    for (int n0 = 0; n0 < NJO; n0 += NG) {
      float po[NG][4];
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) po[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NJS; ++j) {
        uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
        for (int n = 0; n < NG; ++n)
          frag_b_pairs<F32>(Vs, SD, 8 * j, wc + 8 * (n0 + n), g, t, bh[n], bl[n]);
        passes<true, F32>(po, ph[j], pl[j], bh, bl);
      }
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[n0 + n][e] = fmaf(o[n0 + n][e], alpha[e >> 1], po[n][e]);
    }
  }
  cp_wait<0>();

  T* ob = static_cast<T*>(a.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qpos = qa + g + 8 * r;
    if (qpos >= a.Sq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    T* row = ob + (((long long)b * a.Sq + qpos) * a.Hq + h) * D + wc + 2 * t;
#pragma unroll
    for (int n = 0; n < NJO; ++n) store2(row + 8 * n, o[n][2 * r] / lc, o[n][2 * r + 1] / lc);
    if (t == 0 && wc == 0) a.lse[((long long)b * a.Hq + h) * a.Sq + qpos] = m[r] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// K10: dq
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1) flash_dq_kernel(FlashArgs a) {
  using TL = DqTile<D>;
  constexpr int BQ = TL::BQ, BK = TL::BK, WC = TL::WC, SD = TL::SD;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int NJS = BK / 8;               // score n-tiles (keys) of a warp
  constexpr int NJQ = D / WC / 8;           // dq n-tiles (head_dim) of a warp
  constexpr int KC = D < 32 ? D / 8 : 4;    // k-steps of one partial sum over head_dim
  constexpr int NG = NJQ < 8 ? NJQ : 8;     // dq n-tiles summed together
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ds = Qs + BQ * SD;                 // do
  float* KV = Ds + BQ * SD;                 // stage s: k at KV + 2 s BK SD, v after it
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / WC * 16, wc = warp % WC * (D / WC);
  const int qt = gridDim.y - 1 - blockIdx.y, h = blockIdx.x % a.Hq, b = blockIdx.x / a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * BQ;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  int lo, hi;
  kv_range(a, q0, min(q0 + BQ, a.Sq) - 1, lo, hi);
  const int kt0 = lo / BK, kt1 = (hi + BK - 1) / BK;
  load_rows<T, D, BQ, SD>(Qs, static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss,
                          q0, a.Sq);
  load_rows<T, D, BQ, SD>(Ds, static_cast<const T*>(a.dout) + b * a.d_sb + h * a.d_sh,
                          a.d_ss, q0, a.Sq);
  if (kt0 < kt1) {
    load_rows<T, D, BK, SD>(KV, kb, a.k_ss, kt0 * BK, a.Sk);
    load_rows<T, D, BK, SD>(KV + BK * SD, vb, a.v_ss, kt0 * BK, a.Sk);
  }
  cp_commit();
  // this thread's rows: qa + g and qa + g + 8
  const int qa = q0 + wr, qz = min(qa + 15, a.Sq - 1);
  const long long row = ((long long)b * a.Hq + h) * a.Sq;
  float lse[2], dl[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qpos = qa + g + 8 * e;
    lse[e] = qpos < a.Sq ? a.lse_in[row + qpos] : 0.f;
    dl[e] = qpos < a.Sq ? a.delta[row + qpos] : 0.f;
  }
  float acc[NJQ][4];
#pragma unroll
  for (int n = 0; n < NJQ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) & 1;
    cp_wait<0>();
    __syncthreads();               // tile kt landed; every warp is done with tile kt - 1
    if (kt + 1 < kt1) {
      float* nx = KV + (st ^ 1) * 2 * BK * SD;
      load_rows<T, D, BK, SD>(nx, kb, a.k_ss, (kt + 1) * BK, a.Sk);
      load_rows<T, D, BK, SD>(nx + BK * SD, vb, a.v_ss, (kt + 1) * BK, a.Sk);
    }
    cp_commit();
    const int k0 = kt * BK;
    if (!block_live(a, qa, qz, k0, min(k0 + BK, a.Sk) - 1)) continue;
    const float* Ks = KV + st * 2 * BK * SD;
    const float* Vs = Ks + BK * SD;

    // s = q k^T and dp = do v^T over head_dim, KC k-steps a partial sum
    float sc[NJS][4], dp[NJS][4];
#pragma unroll
    for (int j = 0; j < NJS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll 1
    for (int kc = 0; kc < D; kc += 8 * KC) {
      float ps[NJS][4], pp[NJS][4];
#pragma unroll
      for (int j = 0; j < NJS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ps[j][e] = pp[j][e] = 0.f;
#pragma unroll
      for (int kk = kc; kk < kc + 8 * KC; kk += 8) {
        uint32_t qh[4], ql[4], oh[4], ol[4];
        uint32_t kh[NJS][2], kl[NJS][2], vh[NJS][2], vl[NJS][2];
        frag_a<F32>(Qs, SD, wr, kk, lane, qh, ql);
        frag_a<F32>(Ds, SD, wr, kk, lane, oh, ol);
#pragma unroll
        for (int j = 0; j < NJS; j += 2) {
          frag_b_rows2<F32>(Ks, SD, 8 * j, kk, lane, kh[j], kl[j], kh[j + 1], kl[j + 1]);
          frag_b_rows2<F32>(Vs, SD, 8 * j, kk, lane, vh[j], vl[j], vh[j + 1], vl[j + 1]);
        }
        passes<F32, F32>(ps, qh, ql, kh, kl);
        passes<F32, F32>(pp, oh, ol, vh, vl);
      }
#pragma unroll
      for (int j = 0; j < NJS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] += ps[j][e];
          dp[j][e] += pp[j][e];
        }
    }

    // ds = p (dp - delta) scale, p = exp(s scale - lse), as the A fragments
    // of dq += ds k: accumulator e of n-tile j (row g + 8 (e / 2), key
    // 8 j + 2 t + e % 2) is A element (e / 2) + 2 (e % 2) of k-step j, keys
    // paired as frag_b_pairs reads k
    uint32_t dh[NJS][4], dlo[NJS][4];
#pragma unroll
    for (int j = 0; j < NJS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = qa + g + 8 * (e >> 1), kpos = k0 + 8 * j + 2 * t + (e & 1);
        const float p = (kpos < a.Sk && qpos < a.Sq && visible(a, qpos, kpos))
                            ? expf(sc[j][e] * a.scale - lse[e >> 1]) : 0.f;
        const int f = (e >> 1) | ((e & 1) << 1);
        split<true>(p * (dp[j][e] - dl[e >> 1]) * a.scale, dh[j][f], dlo[j][f]);
      }

    // dq += ds k over the tile's keys, NG n-tiles at a time, each tile's
    // sum taken on the tensor cores from zero and added by a
    // round-to-nearest FADD (the cores truncate as they accumulate)
#pragma unroll
    for (int n0 = 0; n0 < NJQ; n0 += NG) {
      float pq[NG][4];
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pq[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NJS; ++j) {
        uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
        for (int n = 0; n < NG; ++n)
          frag_b_pairs<F32>(Ks, SD, 8 * j, wc + 8 * (n0 + n), g, t, bh[n], bl[n]);
        passes<true, F32>(pq, dh[j], dlo[j], bh, bl);
      }
#pragma unroll
      for (int n = 0; n < NG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n0 + n][e] += pq[n][e];
    }
  }
  cp_wait<0>();

  T* out = static_cast<T*>(a.dq);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qpos = qa + g + 8 * e;
    if (qpos >= a.Sq) continue;
    T* r = out + (((long long)b * a.Sq + qpos) * a.Hq + h) * D + wc + 2 * t;
#pragma unroll
    for (int n = 0; n < NJQ; ++n) store2(r + 8 * n, acc[n][2 * e], acc[n][2 * e + 1]);
  }
}

// ---------------------------------------------------------------------------
// K11: dk, dv
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1) flash_dkv_kernel(FlashArgs a) {
  using TL = DkvTile<D>;
  constexpr int BK = TL::BK, BQ = TL::BQ, WO = TL::WO, SD = TL::SD, LP = TL::LP;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int NJ1 = BQ / WO / 8;          // score n-tiles (queries) of a warp
  constexpr int NJ2 = D / WO / 8;           // dk, dv n-tiles (head_dim) of a warp
  constexpr int KC = D < 32 ? D / 8 : 4;    // k-steps of one partial sum over head_dim
  constexpr int NG = NJ2 < 4 ? NJ2 : 4;     // dk, dv n-tiles summed together
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * SD;
  float* Kl = Vs + BK * SD;                 // remainders of k and v (TL::PLANES)
  float* Vl = Kl + BK * SD;
  float* QD = (TL::PLANES ? Vl : Vs) + BK * SD;   // stage s: q at QD + 2 s BQ SD, do after it
  float* Pt = QD + 4 * BQ * SD;             // p^T  (BK x LP)
  float* St = Pt + BK * LP;                 // ds^T (BK x LP)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wk = warp / WO * 16, wo = warp % WO;
  const int wq = wo * (BQ / WO), wd = wo * (D / WO);
  const int kt = blockIdx.y, hk = blockIdx.x % a.Hkv, b = blockIdx.x / a.Hkv;
  const int G = a.Hq / a.Hkv;
  const int k0 = kt * BK, k1 = min(k0 + BK, a.Sk) - 1;
  const int ka = k0 + wk, kz = min(ka + 15, a.Sk - 1);   // this warp's keys
  // q rows that can see keys [k0, k1]: tiles [qt0, qt1) of every query head
  // of the group, walked as one sequence i = g * nq + (qt - qt0)
  const int qlo = a.causal ? k0 : 0;
  const int qhi = a.window > 0 ? min(a.Sq, k1 + a.window) : a.Sq;
  const int qt0 = qlo / BQ, nq = qhi > qlo ? (qhi + BQ - 1) / BQ - qt0 : 0;
  const int n_it = G * nq;
  const T* qh0 = static_cast<const T*>(a.q) + b * a.q_sb + (long long)hk * G * a.q_sh;
  const T* dh0 = static_cast<const T*>(a.dout) + b * a.d_sb + (long long)hk * G * a.d_sh;
  if (n_it > 0) {
    load_rows<T, D, BK, SD>(Ks, static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh,
                            a.k_ss, k0, a.Sk);
    load_rows<T, D, BK, SD>(Vs, static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh,
                            a.v_ss, k0, a.Sk);
    load_rows<T, D, BQ, SD>(QD, qh0, a.q_ss, qt0 * BQ, a.Sq);
    load_rows<T, D, BQ, SD>(QD + BQ * SD, dh0, a.d_ss, qt0 * BQ, a.Sq);
  }
  cp_commit();
  if constexpr (F32 && TL::PLANES) {
    if (n_it > 0) {
      cp_wait<0>();
      __syncthreads();             // k and v landed (the loop's first barrier orders the planes)
      for (int idx = threadIdx.x; idx < BK * D / 4; idx += NT) {
        const int off = idx / (D / 4) * SD + idx % (D / 4) * 4;
        float4 kx = *reinterpret_cast<const float4*>(Ks + off);
        float4 vx = *reinterpret_cast<const float4*>(Vs + off);
        uint32_t h, l[8];
        split<true>(kx.x, h, l[0]); split<true>(kx.y, h, l[1]);
        split<true>(kx.z, h, l[2]); split<true>(kx.w, h, l[3]);
        split<true>(vx.x, h, l[4]); split<true>(vx.y, h, l[5]);
        split<true>(vx.z, h, l[6]); split<true>(vx.w, h, l[7]);
        *reinterpret_cast<float4*>(Kl + off) = make_float4(
            __uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));
        *reinterpret_cast<float4*>(Vl + off) = make_float4(
            __uint_as_float(l[4]), __uint_as_float(l[5]), __uint_as_float(l[6]), __uint_as_float(l[7]));
      }
    }
  }
  float dk[NJ2][4], dv[NJ2][4];
#pragma unroll
  for (int n = 0; n < NJ2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    const int gq = it / nq, q0 = (qt0 + it % nq) * BQ;
    cp_wait<0>();
    __syncthreads();               // tile it landed; every warp is done with tile it - 1
    if (it + 1 < n_it) {
      const int gn = (it + 1) / nq, qn = (qt0 + (it + 1) % nq) * BQ;
      float* nx = QD + (st ^ 1) * 2 * BQ * SD;
      load_rows<T, D, BQ, SD>(nx, qh0 + gn * a.q_sh, a.q_ss, qn, a.Sq);
      load_rows<T, D, BQ, SD>(nx + BQ * SD, dh0 + gn * a.d_sh, a.d_ss, qn, a.Sq);
    }
    cp_commit();
    const float* Qs = QD + st * 2 * BQ * SD;
    const float* Ds = Qs + BQ * SD;
    const long long row = ((long long)b * a.Hq + hk * G + gq) * a.Sq;

    // phase 1: s^T = k q^T and dp^T = v do^T for this warp's 16 keys x
    // BQ / WO queries, then p^T and ds^T into shared memory
    {
      const int qa = q0 + wq, qz = min(qa + BQ / WO - 1, a.Sq - 1);
      float lq[NJ1][2], dlt[NJ1][2];
#pragma unroll
      for (int j = 0; j < NJ1; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qpos = qa + 8 * j + 2 * t + c;
          lq[j][c] = qpos < a.Sq ? a.lse_in[row + qpos] : 0.f;
          dlt[j][c] = qpos < a.Sq ? a.delta[row + qpos] : 0.f;
        }
      float sc[NJ1][4], dp[NJ1][4];
#pragma unroll
      for (int j = 0; j < NJ1; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
      if (block_live(a, qa, qz, ka, kz)) {
#pragma unroll 1
        for (int kc = 0; kc < D; kc += 8 * KC) {
          float ps[NJ1][4], pp[NJ1][4];
#pragma unroll
          for (int j = 0; j < NJ1; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) ps[j][e] = pp[j][e] = 0.f;
#pragma unroll
          for (int kk = kc; kk < kc + 8 * KC; kk += 8) {
            uint32_t kh[4], kl[4], vh[4], vl[4];
            uint32_t qh[NJ1][2], ql[NJ1][2], oh[NJ1][2], ol[NJ1][2];
            if constexpr (TL::PLANES) {
              frag_a_planes<F32>(Ks, Kl, SD, wk, kk, lane, kh, kl);
              frag_a_planes<F32>(Vs, Vl, SD, wk, kk, lane, vh, vl);
            } else {
              frag_a<F32>(Ks, SD, wk, kk, lane, kh, kl);
              frag_a<F32>(Vs, SD, wk, kk, lane, vh, vl);
            }
            if constexpr (NJ1 % 2 == 0) {
#pragma unroll
              for (int j = 0; j < NJ1; j += 2) {
                frag_b_rows2<F32>(Qs, SD, wq + 8 * j, kk, lane, qh[j], ql[j], qh[j + 1],
                                  ql[j + 1]);
                frag_b_rows2<F32>(Ds, SD, wq + 8 * j, kk, lane, oh[j], ol[j], oh[j + 1],
                                  ol[j + 1]);
              }
            } else {
#pragma unroll
              for (int j = 0; j < NJ1; ++j) {
                frag_b_rows<F32>(Qs, SD, wq + 8 * j, kk, g, t, qh[j], ql[j]);
                frag_b_rows<F32>(Ds, SD, wq + 8 * j, kk, g, t, oh[j], ol[j]);
              }
            }
            passes<F32, F32>(ps, kh, kl, qh, ql);
            passes<F32, F32>(pp, vh, vl, oh, ol);
          }
#pragma unroll
          for (int j = 0; j < NJ1; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sc[j][e] += ps[j][e];
              dp[j][e] += pp[j][e];
            }
        }
      }
      // accumulator e of n-tile j: key wk + g + 8 (e / 2), query
      // wq + 8 j + 2 t + e % 2
#pragma unroll
      for (int j = 0; j < NJ1; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int kpos = ka + g + 8 * hf;
          float pv[2], sv[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int qpos = qa + 8 * j + 2 * t + c;
            const float p = (kpos < a.Sk && qpos < a.Sq && visible(a, qpos, kpos))
                                ? expf(sc[j][2 * hf + c] * a.scale - lq[j][c]) : 0.f;
            pv[c] = p;
            sv[c] = p * (dp[j][2 * hf + c] - dlt[j][c]) * a.scale;
          }
          const int off = (wk + g + 8 * hf) * LP + wq + 8 * j + 2 * t;
          store2(Pt + off, pv[0], pv[1]);
          store2(St + off, sv[0], sv[1]);
        }
    }
    __syncthreads();               // p^T and ds^T of the whole tile are written

    // phase 2: dv += p^T do, dk += ds^T q over the tile's BQ queries for
    // this warp's 16 keys x D / WO columns, NG n-tiles at a time, each
    // tile's sum taken from zero and added by an FADD
    if (block_live(a, q0, min(q0 + BQ, a.Sq) - 1, ka, kz)) {
#pragma unroll
      for (int n0 = 0; n0 < NJ2; n0 += NG) {
        float pv[NG][4], pk[NG][4];
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[n][e] = pk[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BQ; kk += 8) {
          uint32_t ph[4], pl[4], sh[4], sl[4];
          uint32_t oh[NG][2], ol[NG][2], qh[NG][2], ql[NG][2];
          frag_a_pairs(Pt, LP, wk, kk, g, t, ph, pl);
          frag_a_pairs(St, LP, wk, kk, g, t, sh, sl);
#pragma unroll
          for (int n = 0; n < NG; ++n) {
            frag_b_pairs<F32>(Ds, SD, kk, wd + 8 * (n0 + n), g, t, oh[n], ol[n]);
            frag_b_pairs<F32>(Qs, SD, kk, wd + 8 * (n0 + n), g, t, qh[n], ql[n]);
          }
          passes<true, F32>(pv, ph, pl, oh, ol);
          passes<true, F32>(pk, sh, sl, qh, ql);
        }
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dv[n0 + n][e] += pv[n][e];
            dk[n0 + n][e] += pk[n][e];
          }
      }
    }
  }
  cp_wait<0>();

  T* dkb = static_cast<T*>(a.dk);
  T* dvb = static_cast<T*>(a.dv);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kpos = ka + g + 8 * hf;
    if (kpos >= a.Sk) continue;
    const long long off = (((long long)b * a.Sk + kpos) * a.Hkv + hk) * D + wd + 2 * t;
#pragma unroll
    for (int n = 0; n < NJ2; ++n) {
      store2(dkb + off + 8 * n, dk[n][2 * hf], dk[n][2 * hf + 1]);
      store2(dvb + off + 8 * n, dv[n][2 * hf], dv[n][2 * hf + 1]);
    }
  }
}

enum Pass { FWD = 0, DQ = 1, DKV = 2 };

template <typename T, int D>
int launch(int pass, const FlashArgs& a, cudaStream_t stream) {
  void (*kernel)(FlashArgs);
  int floats;
  dim3 grid;
  if (pass == FWD) {
    constexpr int BQ = FwdTile<D>::BQ;
    kernel = flash_fwd_kernel<T, D>;
    floats = FwdTile<D>::FLOATS;
    grid = dim3(a.Hq * a.B, (a.Sq + BQ - 1) / BQ);
  } else if (pass == DQ) {
    constexpr int BQ = DqTile<D>::BQ;
    kernel = flash_dq_kernel<T, D>;
    floats = DqTile<D>::FLOATS;
    grid = dim3(a.Hq * a.B, (a.Sq + BQ - 1) / BQ);
  } else {
    constexpr int BK = DkvTile<D>::BK;
    kernel = flash_dkv_kernel<T, D>;
    floats = DkvTile<D>::FLOATS;
    grid = dim3(a.Hkv * a.B, (a.Sk + BK - 1) / BK);
  }
  const size_t bytes = (size_t)floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int pass, int D, const FlashArgs& a, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(pass, a, stream);
    case 32: return launch<T, 32>(pass, a, stream);
    case 64: return launch<T, 64>(pass, a, stream);
    case 128: return launch<T, 128>(pass, a, stream);
    case 256: return launch<T, 256>(pass, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One entry point for the three passes. dtype 0 = float32, 1 = bfloat16 (q,
// k, v, do and the outputs o, dq, dk, dv share it; lse and delta are
// float32). Strides are in elements, for q, k, v and do: batch, sequence,
// head (head_dim contiguous). Outputs are contiguous: o and dq
// (B, Sq, Hq, D), dk and dv (B, Sk, Hkv, D), lse (B, Hq, Sq). Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(
    int pass, int dtype, int D, const void* q, const void* k, const void* v, const void* dout,
    const float* lse_in, const float* delta, void* o, float* lse, void* dq, void* dk, void* dv,
    int B, int Sq, int Sk, int Hq, int Hkv, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long d_sb, long long d_ss, long long d_sh, int causal, int window,
    float scale, void* stream) {
  cudaGetLastError();  // clear any stale error from an earlier call
  FlashArgs a;
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse_in = lse_in; a.delta = delta;
  a.o = o; a.lse = lse; a.dq = dq; a.dk = dk; a.dv = dv;
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.d_sb = d_sb; a.d_ss = d_ss; a.d_sh = d_sh;
  a.causal = causal; a.window = window; a.scale = scale;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || pass < 0 || pass > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(pass, D, a, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(pass, D, a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
