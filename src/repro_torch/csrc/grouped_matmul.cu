// Grouped (per-expert) matmul on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of repro/kernels/grouped_matmul.py:
//   K12  _kernel via grouped_matmul (pallas_call :69)  -> grouped_mm_kernel
//   y[i] (T, F) = x[i] (T, D) @ w[blk_expert[i / bm]] (D, F)
// over expert-sorted rows: row block b (rows b*bm .. b*bm + bm - 1, the last
// one possibly shorter) multiplies by the weight of expert blk_expert[b].
// x and w are float32 or bfloat16 (the same type), the sums float32 FFMA,
// y is written in x's type. Any bm >= 1 and any T, D, F: ragged edges are
// masked with zeros. A block whose expert id lies outside [0, E) is written
// as zeros, never read from outside w. Offsets into w are 64-bit
// (e * D * F exceeds 2^31 at arctic's widths).
//
// What bounds it on the H100: operations. At mixtral-8x22b's training shape
// (x (10240, 6144) against w (8, 6144, 16384), bm = 1280) a call is 2.06
// TFLOP over ~1.3 GB, ~1600 operations per byte against float32's ~20:
// 30.8 ms at 67 TFLOP/s. The design is the classic register-tiled SIMT
// GEMM: a CTA of 256 threads owns a 128 x 128 output tile inside ONE row
// block, so it reads blk_expert once and every row of its tile uses the
// same weight tile (a row block longer than 128 rows is split into several
// tiles at its own edges, never joined with the next block's rows). The
// contraction runs in steps of 16: the x tile is staged transposed and the
// w tile as it lies, both as float32 rows padded by 4 floats, in two
// shared-memory buffers, the next step's tiles are loaded into registers
// while the current one is multiplied, so one barrier a step suffices.
// Each thread keeps an 8 x 8 block of accumulators (rows ty*4 + {0..3} and
// 64 + ty*4 + {0..3}, columns likewise with tx), fed by float4 reads that
// are broadcast (x) or contiguous (w) across a warp: no bank conflicts.
// wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BMT = 128;     // output rows per CTA
constexpr int BNT = 128;     // output columns per CTA
constexpr int BK = 16;       // contraction step
constexpr int PAD = 4;       // floats of padding per shared row
constexpr int NT = 256;      // 16 x 16 threads

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 4 consecutive elements of a row starting at column c (c < n when VEC,
// which implies n % 4 == 0), zeros past the row's end or for a dead row.
template <typename T, bool VEC>
__device__ __forceinline__ float4 fetch4(const T* row, int c, int n, bool live) {
  if (VEC) return (live && c < n) ? load4(row + c) : make_float4(0.f, 0.f, 0.f, 0.f);
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = (live && c + q < n) ? to_f(row[c + q]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT, 2)
grouped_mm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const int* __restrict__ blk_expert, T* __restrict__ y, int Tn, int D,
                  int F, int E, int bm, int tiles_per_block) {
  __shared__ __align__(16) float As[2][BK][BMT + PAD];
  __shared__ __align__(16) float Bs[2][BK][BNT + PAD];

  const int blk = blockIdx.x / tiles_per_block;
  const int sub = blockIdx.x - blk * tiles_per_block;
  const long long blk_start = (long long)blk * bm;
  const long long r0 = blk_start + (long long)sub * BMT;
  long long r_end = blk_start + bm;
  if (r_end > Tn) r_end = Tn;
  if (r0 + BMT < r_end) r_end = r0 + BMT;
  if (r0 >= r_end) return;                       // the whole CTA: no barrier yet
  const int rows = (int)(r_end - r0);
  const int c0 = blockIdx.y * BNT;
  const int e = blk_expert[blk];
  const bool valid_e = e >= 0 && e < E;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  // global -> register staging: x tile as 2 x (row, 4 k), w tile as 2 x (k, 4 cols)
  const int a_row = tid / 4, a_k = (tid % 4) * 4;          // rows a_row, a_row + 64
  const int b_k = tid / 32, b_col = (tid % 32) * 4;        // k rows b_k, b_k + 8
  const T* xa0 = x + (r0 + a_row) * (long long)D;
  const T* xa1 = x + (r0 + a_row + 64) * (long long)D;
  const bool live_a0 = valid_e && a_row < rows, live_a1 = valid_e && a_row + 64 < rows;
  const T* we = w + (valid_e ? (long long)e * D * F : 0LL);

  float4 ra[2], rb[2];
  auto fetch = [&](int k0) {
    ra[0] = fetch4<T, VEC>(xa0, k0 + a_k, D, live_a0);
    ra[1] = fetch4<T, VEC>(xa1, k0 + a_k, D, live_a1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + b_k + 8 * h;
      rb[h] = fetch4<T, VEC>(we + (long long)k * F, c0 + b_col, F, valid_e && k < D);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = a_row + 64 * h;
      As[buf][a_k + 0][m] = ra[h].x;
      As[buf][a_k + 1][m] = ra[h].y;
      As[buf][a_k + 2][m] = ra[h].z;
      As[buf][a_k + 3][m] = ra[h].w;
      *reinterpret_cast<float4*>(&Bs[buf][b_k + 8 * h][b_col]) = rb[h];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  stash(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < D; k0 += BK) {
    const bool more = k0 + BK < D;
    if (more) fetch(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) stash(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= rows) continue;
    T* yr = y + (r0 + m) * (long long)F;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 64 * h + tx * 4;
      if (VEC) {
        if (c < F)
          store4(yr + c, acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < F) store1(yr + c + q, acc[i][4 * h + q]);
      }
    }
  }
}

template <typename T>
int launch(bool vec, const void* x, const void* w, const int* blk_expert, void* y, int Tn,
           int D, int F, int E, int bm, cudaStream_t s) {
  const int tiles_per_block = (bm + BMT - 1) / BMT;
  const long long nblk = ((long long)Tn + bm - 1) / bm;
  const long long row_tiles = nblk * tiles_per_block;
  if (row_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)row_tiles, (F + BNT - 1) / BNT);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  if (vec)
    grouped_mm_kernel<T, true><<<grid, NT, 0, s>>>((const T*)x, (const T*)w, blk_expert,
                                                   (T*)y, Tn, D, F, E, bm, tiles_per_block);
  else
    grouped_mm_kernel<T, false><<<grid, NT, 0, s>>>((const T*)x, (const T*)w, blk_expert,
                                                    (T*)y, Tn, D, F, E, bm, tiles_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, w and y alike). x (T, D), w (E, D, F)
// and y (T, F) contiguous; blk_expert (ceil(T / bm),) int32. vec = 1 when
// D % 4 == 0, F % 4 == 0 and x, w are aligned for 4-element vector loads.
// Returns cudaGetLastError() after the launch.
extern "C" int grouped_matmul_launch(int dtype, int vec, const void* x, const void* w,
                                     const int* blk_expert, void* y, int Tn, int D, int F,
                                     int E, int bm, void* stream) {
  cudaGetLastError();  // clear any stale error from an earlier call
  if (Tn <= 0 || F <= 0) return (int)cudaSuccess;
  if (bm < 1 || D < 0 || E < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(vec != 0, x, w, blk_expert, y, Tn, D, F, E, bm, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(vec != 0, x, w, blk_expert, y, Tn, D, F, E, bm, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
