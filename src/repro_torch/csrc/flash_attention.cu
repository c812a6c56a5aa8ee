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
// Inputs are float32 or bfloat16; the arithmetic is float32 FFMA (no tensor
// cores: the port keeps TF32 off), staged through shared memory as float32.
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
// What bounds it on the H100: operations. At qwen3-8b's training shape
// (B=1, S=4096, 32 query heads, D=128, causal) a product over the causal
// half is 68.7e9 multiply-adds against at most ~200 MB of operands, far
// above float32's ~20 operations per byte. The design keeps every product
// in shared memory and registers: a CTA of 256 threads (16 x 16) owns a
// 64-row tile (32 at D=256) of one (batch, head); tiles are staged as
// float32 rows padded to D + 4 floats, so each thread reads 16-byte vectors
// along the contraction axis without bank conflicts (rows owned as
// ty + 16 i and tx + 16 j); each thread keeps a 4 x 4 block of scores and a
// 4 x D/16 block of the output in registers. K9 grid: q tiles x Hq x B,
// largest (last) q tiles first; K10 the same; K11: kv tiles x Hkv x B,
// looping over the group's query heads and the q tiles the masks leave.
// wgmma, TMA and warp specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <int D>
constexpr int dq_smem_floats() {
  constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK, SD = D + 4;
  constexpr int vreg = BK * SD > BQ * (BK + 4) ? BK * SD : BQ * (BK + 4);
  return 2 * BQ * SD + BK * SD + vreg;
}

template <int D>
constexpr int dkv_smem_floats() {
  constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK, SD = D + 4;
  return 2 * BK * SD + 2 * BQ * SD + 2 * BK * (BQ + 4);
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
// K10: dq
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_dq_kernel(FlashArgs a) {
  constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK, SD = D + 4;
  constexpr int NI = BQ / 16, NJ = BK / 16, X = D / 16, LP = BK + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ds = Qs + BQ * SD;      // do
  float* Ks = Ds + BQ * SD;
  float* Vs = Ks + BK * SD;      // V tile, then the tile's ds (row stride LP)
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = qt * BQ;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* db = static_cast<const T*>(a.dout) + b * a.d_sb + h * a.d_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  stage<T, D, BQ>(Qs, qb, a.q_ss, q0, a.Sq);
  stage<T, D, BQ>(Ds, db, a.d_ss, q0, a.Sq);
  const long long row = ((long long)b * a.Hq + h) * a.Sq;
  float lse[NI], dl[NI], acc[NI][X];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int qpos = q0 + ty + 16 * i;
    lse[i] = qpos < a.Sq ? a.lse_in[row + qpos] : 0.f;
    dl[i] = qpos < a.Sq ? a.delta[row + qpos] : 0.f;
#pragma unroll
    for (int x = 0; x < X; ++x) acc[i][x] = 0.f;
  }
  int lo, hi;
  kv_range(a, q0, min(q0 + BQ, a.Sq) - 1, lo, hi);
  for (int kt = lo / BK; kt * BK < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    stage<T, D, BK>(Ks, kb, a.k_ss, k0, a.Sk);
    stage<T, D, BK>(Vs, vb, a.v_ss, k0, a.Sk);
    __syncthreads();
    float s[NI][NJ], dp[NI][NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
    dot_rows<D, NI, NJ>(s, Qs, Ks, ty, tx);
    dot_rows<D, NI, NJ>(dp, Ds, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float p = (kpos < a.Sk && qpos < a.Sq && visible(a, qpos, kpos))
                            ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
        s[i][j] = p * (dp[i][j] - dl[i]) * a.scale;
      }
    }
    __syncthreads();               // every thread is done reading Vs
    float* dS = Vs;
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) dS[(ty + 16 * i) * LP + tx + 16 * j] = s[i][j];
    __syncthreads();
    acc_rows<D, NI, BK, LP>(acc, dS, Ks, ty, tx);
  }
  T* out = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos < a.Sq) write_row<T, D>(out + (((long long)b * a.Sq + qpos) * a.Hq + h) * D, acc[i], tx);
  }
}

// ---------------------------------------------------------------------------
// K11: dk, dv
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_dkv_kernel(FlashArgs a) {
  constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK, SD = D + 4;
  constexpr int NI = BK / 16, NJ = BQ / 16, X = D / 16, LP = BQ + 4;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * SD;
  float* Qs = Vs + BK * SD;
  float* Ds = Qs + BQ * SD;      // do
  float* Pt = Ds + BQ * SD;      // p^T  (BK x LP)
  float* St = Pt + BK * LP;      // ds^T (BK x LP)
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const int k0 = kt * BK, k1 = min(k0 + BK, a.Sk) - 1;
  stage<T, D, BK>(Ks, static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh, a.k_ss, k0, a.Sk);
  stage<T, D, BK>(Vs, static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh, a.v_ss, k0, a.Sk);
  float dk[NI][X], dv[NI][X];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int x = 0; x < X; ++x) dk[i][x] = dv[i][x] = 0.f;
  // q rows that can see keys [k0, k1]
  const int qlo = a.causal ? k0 : 0;
  const int qhi = a.window > 0 ? min(a.Sq, k1 + a.window) : a.Sq;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* db = static_cast<const T*>(a.dout) + b * a.d_sb + h * a.d_sh;
    const long long row = ((long long)b * a.Hq + h) * a.Sq;
    for (int qt = qlo / BQ; qt * BQ < qhi; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      stage<T, D, BQ>(Qs, qb, a.q_ss, q0, a.Sq);
      stage<T, D, BQ>(Ds, db, a.d_ss, q0, a.Sq);
      __syncthreads();
      float s[NI][NJ], dp[NI][NJ];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
      dot_rows<D, NI, NJ>(s, Ks, Qs, ty, tx);    // s^T: kv rows x q rows
      dot_rows<D, NI, NJ>(dp, Vs, Ds, ty, tx);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int qpos = q0 + tx + 16 * j;
        const bool qin = qpos < a.Sq;
        const float lse = qin ? a.lse_in[row + qpos] : 0.f;
        const float dl = qin ? a.delta[row + qpos] : 0.f;
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int kpos = k0 + ty + 16 * i;
          const float p = (qin && kpos < a.Sk && visible(a, qpos, kpos))
                              ? expf(s[i][j] * a.scale - lse) : 0.f;
          Pt[(ty + 16 * i) * LP + tx + 16 * j] = p;
          St[(ty + 16 * i) * LP + tx + 16 * j] = p * (dp[i][j] - dl) * a.scale;
        }
      }
      __syncthreads();
      acc_rows<D, NI, BQ, LP>(dv, Pt, Ds, ty, tx);
      acc_rows<D, NI, BQ, LP>(dk, St, Qs, ty, tx);
    }
  }
  T* dkb = static_cast<T*>(a.dk);
  T* dvb = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= a.Sk) continue;
    const long long off = (((long long)b * a.Sk + kpos) * a.Hkv + hk) * D;
    write_row<T, D>(dkb + off, dk[i], tx);
    write_row<T, D>(dvb + off, dv[i], tx);
  }
}

enum Pass { FWD = 0, DQ = 1, DKV = 2 };

template <typename T, int D>
int launch(int pass, const FlashArgs& a, cudaStream_t stream) {
  constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK;
  void (*kernel)(FlashArgs);
  int floats;
  dim3 grid;
  if (pass == FWD) {
    kernel = flash_fwd_kernel<T, D>;
    floats = fwd_smem_floats<D>();
    grid = dim3((a.Sq + BQ - 1) / BQ, a.Hq, a.B);
  } else if (pass == DQ) {
    kernel = flash_dq_kernel<T, D>;
    floats = dq_smem_floats<D>();
    grid = dim3((a.Sq + BQ - 1) / BQ, a.Hq, a.B);
  } else {
    kernel = flash_dkv_kernel<T, D>;
    floats = dkv_smem_floats<D>();
    grid = dim3((a.Sk + BK - 1) / BK, a.Hkv, a.B);
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
