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
// Inputs are float32 or bfloat16. K9 computes in float32 FFMA; K10 and K11
// run their products on the TF32 tensor cores in split precision, which
// keeps float32's accuracy (below). Tiles are staged in shared memory as
// float32.
//
// Masked tiles: a kv tile that no row of the CTA's q tile can see (causal:
// above the diagonal; window: before it) is skipped. The reference visits
// every tile and lets masked scores add exp(0) terms to (l, acc) until the
// first visible score wipes them with alpha = exp(m_prev - m_new) = 0, so
// skipping gives the same function wherever a row sees at least one key.
// Rows that see none (a window with Sq > Sk + window - 1) are refused by the
// wrapper. Keys past Sk (the ragged last tile) get p = 0 exactly; query rows
// past Sq are computed on zeros and never written.
//
// What bounds them on the H100: operations. At qwen3-8b's training shape
// (B=1, S=4096, 32 query heads, D=128, causal) a product over the causal
// half is 68.7e9 multiply-adds against at most ~200 MB of operands.
//
// K9 (float32 FFMA): a CTA of 256 threads (16 x 16) owns a 64-row tile (32
// at D=256) of one (batch, head); tiles are staged as float32 rows padded
// to D + 4 floats, so each thread reads 16-byte vectors along the
// contraction axis without bank conflicts (rows owned as ty + 16 i and
// tx + 16 j); each thread keeps a 4 x 4 block of scores and a 4 x D/16
// block of the output in registers. Grid: q tiles x Hq x B, largest (last)
// q tiles first.
//
// K10 and K11 (the backward: three and four products):
//   * Split precision ("3xTF32"), as csrc/grouped_matmul.cu: each float32
//     operand of an mma.sync.m16n8k8 TF32 fragment is split into hi and a
//     remainder lo (an AND and an FADD), and each product issues lo*hi,
//     hi*lo, hi*hi. A bfloat16 input widened to float32 is already a TF32
//     value, so the products of two inputs (s = q k^T, dp = do v^T) take
//     hi*hi alone and those with p or ds (float32) take two passes.
//   * The tensor cores truncate as they add into a float32 accumulator, and
//     dq sums over up to Sk keys, dk and dv over up to Sq x G queries. So
//     every product is summed on the tensor cores from zero over one tile
//     of its contraction (32 of head_dim for s and dp, one kv tile for dq,
//     one q tile for dk and dv) and that partial tile is added to the
//     running float32 sums by an FADD, which rounds to nearest.
//   * mma.sync, not wgmma: TF32 wgmma reads both operands K-major from
//     shared memory, and three of the five products contract over a
//     sequence axis whose operand lies d-contiguous (ds k, p^T do, ds^T q).
//     mma.sync fragments load from shared memory in any orientation.
//   * Bank conflicts: one float32 copy of each tile, rows of D + 4 floats,
//     serves both orientations. Where a product contracts over a sequence
//     axis the 8-wide k-step is paired (k = t is row 2t, k = t + 4 is row
//     2t + 1; the order of a contraction's terms is free), which is exactly
//     the column order of the score accumulator, so ds and p^T go from the
//     accumulators to the next product's A fragments without a shuffle, and
//     the B fragment rows 2t, 2t + 1 land on banks 8t + g: conflict-free
//     at D + 4. The d-contracting fragments (q, do, k, v as rows) load by
//     ldmatrix, four 8 x 4 float32 matrices an instruction, whose 8 rows
//     of D + 4 floats fall on 8 distinct 16-byte bank groups. No swizzle
//     and no second copy are needed. p^T and ds^T (K11) pass through shared
//     memory in rows of BQ + 8 floats, read as 8-byte pairs, also
//     conflict-free. K11 splits its resident k and v tiles once into a
//     plane of remainders beside them (up to D = 128), so their fragments
//     take no arithmetic in the q loop.
//   * Staging: float32 tiles arrive by 16-byte cp.async, double-buffered:
//     the next kv tile (K10) or q / do tile (K11) is copied while the
//     current one computes, one barrier a tile (K11: two, around the p^T /
//     ds^T exchange). bfloat16 is widened through registers into the same
//     ring (synchronously).
//   * K10: a CTA of 8 warps owns 128 query rows (64 at D = 256) of one
//     (batch, head), 16 rows a warp, and walks kv tiles of 32 keys (16 at
//     D = 256): each warp computes its rows' s and dp on the tensor cores,
//     forms ds in registers and adds ds k to its dq rows (all of head_dim;
//     at D = 256 two warps share 16 rows, 128 columns each, and both
//     compute the rows' scores). A warp skips a tile none of its rows can
//     see.
//   * K11: a CTA of 8 warps owns 64 keys (32 at D = 256) of one (batch, kv
//     head) and walks the group's query heads and the q tiles of 32 rows (64
//     at D <= 64) the masks leave. Warps split s^T and dp^T as 16 keys x
//     the tile's queries / (8 / (keys / 16)), write p^T and ds^T to shared
//     memory, then split dk and dv as 16 keys x head_dim / (8 / (keys /
//     16)), each held in registers for the whole loop.
//   * Launch order: the grid is (heads x B) x tiles with the head fastest,
//     so CTAs start in order of their work over all heads (K10: the last q
//     tiles first; K11: the first kv tiles, which the most q rows see) and
//     the smallest end the run. With the tile fastest (K9's grid), one
//     head's largest CTA starts only after the heads before it, and under
//     a causal mask the run waits on it.
//   * Deterministic: two passes, no atomics; every sum has a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 256;          // 16 x 16 threads
constexpr float NEG = -1e30f;    // masked score, as the reference

template <int D> struct Tile { static constexpr int BQ = 64, BK = 64; };
template <> struct Tile<256> { static constexpr int BQ = 32, BK = 32; };

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

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <int XV>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (XV == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (XV == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

template <int XV>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
#pragma unroll
  for (int e = 0; e < XV; ++e) p[e] = __float2bfloat16(v[e]);
}

template <int XV>
__device__ __forceinline__ void load_vec(float (&r)[XV], const float* p) {
  if constexpr (XV == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
  } else if constexpr (XV == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r[0] = t.x; r[1] = t.y;
  } else {
    r[0] = p[0];
  }
}

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// R rows [row0, row0 + R) of one (batch, head) slice starting at `base`
// (row stride `rs` elements) into shared memory as float32 rows of D + 4;
// rows at or past `nrows` are zero.
template <typename T, int D, int R>
__device__ __forceinline__ void stage(float* s, const T* base, long long rs, int row0,
                                      int nrows) {
  constexpr int V4 = D / 4;
  for (int idx = threadIdx.x; idx < R * V4; idx += NT) {
    const int r = idx / V4, c4 = idx - r * V4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows) val = load4(base + (long long)(row0 + r) * rs + c4 * 4);
    *reinterpret_cast<float4*>(s + r * (D + 4) + c4 * 4) = val;
  }
}

// acc[i][j] += A[ty + 16 i] . Bm[tx + 16 j] over D, both staged with row
// stride D + 4.
template <int D, int NI, int NJ>
__device__ __forceinline__ void dot_rows(float (&acc)[NI][NJ], const float* A,
                                         const float* Bm, int ty, int tx) {
  constexpr int SD = D + 4;
#pragma unroll 2
  for (int k = 0; k < D; k += 4) {
    float4 a[NI], b[NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * SD + k);
#pragma unroll
    for (int j = 0; j < NJ; ++j) b[j] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * j) * SD + k);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][x] += sum_c P[ty + 16 i][c] * V[c][x] over NC columns; P has row
// stride LP, V row stride D + 4; thread tx owns the columns
// g * 16 XV + tx XV + e of the output.
template <int D, int NI, int NC, int LP>
__device__ __forceinline__ void acc_rows(float (&acc)[NI][D / 16], const float* P,
                                         const float* V, int ty, int tx) {
  constexpr int SD = D + 4, X = D / 16, XV = X < 4 ? X : 4, NG = X / XV;
#pragma unroll 2
  for (int c = 0; c < NC; c += 4) {
    float4 p[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * LP + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float vv[NG][XV];
#pragma unroll
      for (int g = 0; g < NG; ++g) load_vec<XV>(vv[g], V + (c + e) * SD + g * 16 * XV + tx * XV);
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float pe = comp(p[i], e);
#pragma unroll
        for (int g = 0; g < NG; ++g)
#pragma unroll
          for (int x = 0; x < XV; ++x) acc[i][g * XV + x] = fmaf(pe, vv[g][x], acc[i][g * XV + x]);
      }
    }
  }
}

// Rows of the output block owned by a thread: its D / 16 columns, written as
// NG vectors of XV.
template <typename T, int D>
__device__ __forceinline__ void write_row(T* row, const float* vals, int tx) {
  constexpr int X = D / 16, XV = X < 4 ? X : 4, NG = X / XV;
#pragma unroll
  for (int g = 0; g < NG; ++g) store_vec<XV>(row + g * 16 * XV + tx * XV, vals + g * XV);
}

__device__ __forceinline__ bool visible(const FlashArgs& a, int qpos, int kpos) {
  return (!a.causal || qpos >= kpos) && (a.window <= 0 || qpos - kpos < a.window);
}

// kv range [lo, hi) that rows [q0, q1] can see.
__device__ __forceinline__ void kv_range(const FlashArgs& a, int q0, int q1, int& lo, int& hi) {
  hi = a.causal ? min(a.Sk, q1 + 1) : a.Sk;
  lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
}

template <int D>
constexpr int fwd_smem_floats() {
  constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK, SD = D + 4;
  constexpr int kreg = BK * SD > BQ * (BK + 4) ? BK * SD : BQ * (BK + 4);
  return BQ * SD + kreg + BK * SD;
}

// ---------------------------------------------------------------------------
// K9: forward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(FlashArgs a) {
  constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK, SD = D + 4;
  constexpr int NI = BQ / 16, NJ = BK / 16, X = D / 16, LP = BK + 4;
  constexpr int kreg = BK * SD > BQ * LP ? BK * SD : BQ * LP;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * SD;      // K tile, then the tile's p (row stride LP)
  float* Vs = Ks + kreg;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * BQ;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  stage<T, D, BQ>(Qs, qb, a.q_ss, q0, a.Sq);

  float m[NI], l[NI], acc[NI][X];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int x = 0; x < X; ++x) acc[i][x] = 0.f;
  }
  int lo, hi;
  kv_range(a, q0, min(q0 + BQ, a.Sq) - 1, lo, hi);
  for (int kt = lo / BK; kt * BK < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();               // previous tile's p and V are consumed
    stage<T, D, BK>(Ks, kb, a.k_ss, k0, a.Sk);
    stage<T, D, BK>(Vs, vb, a.v_ss, k0, a.Sk);
    __syncthreads();
    float s[NI][NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
    dot_rows<D, NI, NJ>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        s[i][j] = visible(a, qpos, kpos) ? s[i][j] * a.scale : NEG;
        if (kpos < a.Sk) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        s[i][j] = kpos < a.Sk ? expf(s[i][j] - m_new) : 0.f;
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int x = 0; x < X; ++x) acc[i][x] *= alpha;
    }
    __syncthreads();               // every thread is done reading Ks
    float* Ps = Ks;
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) Ps[(ty + 16 * i) * LP + tx + 16 * j] = s[i][j];
    __syncthreads();
    acc_rows<D, NI, BK, LP>(acc, Ps, Vs, ty, tx);
  }
  T* ob = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= a.Sq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    float vals[X];
#pragma unroll
    for (int x = 0; x < X; ++x) vals[x] = acc[i][x] / lc;
    write_row<T, D>(ob + (((long long)b * a.Sq + qpos) * a.Hq + h) * D, vals, tx);
    if (tx == 0) a.lse[((long long)b * a.Hq + h) * a.Sq + qpos] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// K10 / K11: the backward on TF32 tensor cores, split precision ("3xTF32")
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp16(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// R rows [row0, row0 + R) of one (batch, head) slice at `base` (row stride
// `rs` elements) into shared memory as float32 rows of SD floats, zeros at
// and past `nrows`. float32 goes by 16-byte cp.async (the wrapper aligns
// rows and bases to 16 bytes; a row past the edge is zero-filled by the
// copy's src-size operand), bfloat16 is widened through registers.
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

// a = hi + lo as mma.sync TF32 operands, as csrc/grouped_matmul.cu splits
// them: the core reads a TF32 operand's top 19 bits, so hi is a itself
// (truncated by the core) and lo = a - (a with its low 13 bits cleared), one
// AND and one FADD, exact in float32; the core truncates lo in turn, an
// error of at most 2^-20 |a|. Without SPLIT the value is already a TF32
// value (a bfloat16 input widened to float32) and lo is not read.
template <bool SPLIT>
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(a);
  if constexpr (SPLIT) lo = __float_as_uint(a - __uint_as_float(hi & 0xffffe000u));
  else lo = 0u;
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, float32 sums. Fragment
// coordinates: g = lane / 4, t = lane % 4; a0 (g, t), a1 (g + 8, t), a2 (g,
// t + 4), a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g); d0 (g, 2t),
// d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The passes of one k-step over N n-tiles, small terms first: lo*hi where
// A splits, hi*lo where B splits, then hi*hi (lo*lo, ~2^-22 of a product,
// is dropped).
template <bool SA, bool SB, int N>
__device__ __forceinline__ void passes(float (&d)[N][4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], const uint32_t (&bh)[N][2],
                                       const uint32_t (&bl)[N][2]) {
  if constexpr (SA) {
#pragma unroll
    for (int n = 0; n < N; ++n) mma(d[n], al, bh[n]);
  }
  if constexpr (SB) {
#pragma unroll
    for (int n = 0; n < N; ++n) mma(d[n], ah, bl[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], ah, bh[n]);
}

// Four 8 x 4 float32 matrices from shared memory (ldmatrix on 16-bit
// pairs): lanes 8 m .. 8 m + 7 give the 16-byte row addresses of matrix m,
// and lane i gets word i % 4 of row i / 4 of matrix m in r[m], which is an
// mma fragment's (g, t) layout. Rows of D + 4 floats put the 8 rows of a
// matrix on 8 distinct 16-byte bank groups.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// Fragments from shared memory (float32 rows of `ld` floats), split.
// A (16 x 8) from rows r0 .. r0 + 15 of M, k along the row (M[r][k]).
template <bool SPLIT>
__device__ __forceinline__ void frag_a(const float* M, int ld, int r0, int k0, int lane,
                                       uint32_t (&h)[4], uint32_t (&l)[4]) {
  const int m = lane >> 3;
  uint32_t raw[4];
  ldsm4(raw, M + (r0 + (m & 1) * 8 + (lane & 7)) * ld + k0 + (m >> 1) * 4);
#pragma unroll
  for (int q = 0; q < 4; ++q) split<SPLIT>(__uint_as_float(raw[q]), h[q], l[q]);
}
// The same A from a tile and its plane of remainders (split once, below):
// two ldmatrix and no arithmetic.
template <bool SPLIT>
__device__ __forceinline__ void frag_a_planes(const float* Mh, const float* Ml, int ld, int r0,
                                              int k0, int lane, uint32_t (&h)[4],
                                              uint32_t (&l)[4]) {
  const int m = lane >> 3;
  const int off = (r0 + (m & 1) * 8 + (lane & 7)) * ld + k0 + (m >> 1) * 4;
  ldsm4(h, Mh + off);
  if constexpr (SPLIT) ldsm4(l, Ml + off);
}
// A (16 x 8) from rows r0 .. r0 + 15, k paired: k = t is column k0 + 2t and
// k = t + 4 column k0 + 2t + 1, one 8-byte load each half (the order of a
// contraction's terms is free; frag_b_pairs pairs the same way).
__device__ __forceinline__ void frag_a_pairs(const float* M, int ld, int r0, int k0, int g,
                                             int t, uint32_t (&h)[4], uint32_t (&l)[4]) {
  const float2 x = *reinterpret_cast<const float2*>(M + (r0 + g) * ld + k0 + 2 * t);
  const float2 y = *reinterpret_cast<const float2*>(M + (r0 + g + 8) * ld + k0 + 2 * t);
  split<true>(x.x, h[0], l[0]);
  split<true>(y.x, h[1], l[1]);
  split<true>(x.y, h[2], l[2]);
  split<true>(y.y, h[3], l[3]);
}
// B (8 x 8) as the transpose of rows n0 .. n0 + 7 of M: B[k][n] = M[n0 + n][k0 + k].
template <bool SPLIT>
__device__ __forceinline__ void frag_b_rows(const float* M, int ld, int n0, int k0, int g,
                                            int t, uint32_t (&h)[2], uint32_t (&l)[2]) {
  const float* p = M + (n0 + g) * ld + k0 + t;
  split<SPLIT>(p[0], h[0], l[0]);
  split<SPLIT>(p[4], h[1], l[1]);
}
// Two such B (rows n0 .. n0 + 7 and n0 + 8 .. n0 + 15) by one ldmatrix.
template <bool SPLIT>
__device__ __forceinline__ void frag_b_rows2(const float* M, int ld, int n0, int k0, int lane,
                                             uint32_t (&h0)[2], uint32_t (&l0)[2],
                                             uint32_t (&h1)[2], uint32_t (&l1)[2]) {
  const int m = lane >> 3;
  uint32_t raw[4];
  ldsm4(raw, M + (n0 + (m >> 1) * 8 + (lane & 7)) * ld + k0 + (m & 1) * 4);
  split<SPLIT>(__uint_as_float(raw[0]), h0[0], l0[0]);
  split<SPLIT>(__uint_as_float(raw[1]), h0[1], l0[1]);
  split<SPLIT>(__uint_as_float(raw[2]), h1[0], l1[0]);
  split<SPLIT>(__uint_as_float(raw[3]), h1[1], l1[1]);
}
// B (8 x 8) from rows k0 .. k0 + 7 of M, paired as frag_a_pairs: B[t][n] =
// M[k0 + 2t][n0 + n], B[t + 4][n] = M[k0 + 2t + 1][n0 + n].
template <bool SPLIT>
__device__ __forceinline__ void frag_b_pairs(const float* M, int ld, int k0, int n0, int g,
                                             int t, uint32_t (&h)[2], uint32_t (&l)[2]) {
  const float* p = M + (k0 + 2 * t) * ld + n0 + g;
  split<SPLIT>(p[0], h[0], l[0]);
  split<SPLIT>(p[ld], h[1], l[1]);
}

// Whether any (query, key) pair of rows [qa, qb] x keys [ka, kb] is visible
// (empty ranges are not).
__device__ __forceinline__ bool block_live(const FlashArgs& a, int qa, int qb, int ka,
                                           int kb) {
  return qa <= qb && ka <= kb && (!a.causal || qb >= ka) &&
         (a.window <= 0 || qa - kb < a.window);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

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
    cp_wait_all();
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
  cp_wait_all();

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
      cp_wait_all();
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
    cp_wait_all();
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
  cp_wait_all();

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
    constexpr int BQ = Tile<D>::BQ;
    kernel = flash_fwd_kernel<T, D>;
    floats = fwd_smem_floats<D>();
    grid = dim3((a.Sq + BQ - 1) / BQ, a.Hq, a.B);
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
