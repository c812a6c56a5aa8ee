// Grouped (per-expert) matmul on Hopper (sm_90a), on TF32 tensor cores.
//
// Replaces the Pallas TPU kernel of repro/kernels/grouped_matmul.py:
//   K12  _kernel via grouped_matmul (pallas_call :69)  -> grouped_mm_kernel
//   y[i] (T, F) = x[i] (T, D) @ w[blk_expert[i / bm]] (D, F)
// over expert-sorted rows: row block b (rows b*bm .. b*bm + bm - 1, the last
// one possibly shorter) multiplies by the weight of expert blk_expert[b].
// x and w are float32 or bfloat16 (the same type), the sums float32, y is
// written in x's type (bfloat16 with D and F multiples of 8 takes
// csrc/grouped_matmul_sm90.cu instead; kernels/grouped_matmul.py
// route()). Any bm >= 1 and any T, D, F: ragged edges are masked with
// zeros. A block whose expert id lies outside [0, E) is written as
// zeros, never read from outside w. Offsets into w are 64-bit (e * D * F
// exceeds 2^31 at arctic's widths).
//
// What bounds it on the H100: tensor-core operations. At mixtral-8x22b's
// training shape (x (10240, 6144) against w (8, 6144, 16384), bm = 1280,
// and its down twin) a call is 2.06 TFLOP over ~4.1 GB of operands. On
// float32 FFMA (67 TFLOP/s) that is 30.77 ms. Here every product runs as
// three TF32 products (below): 3 x 2.06 TFLOP at the dense TF32 rate of
// 495 TFLOP/s is 12.49 ms; at the ~315 TFLOP/s that mma.sync reaches on
// the card with nothing else to issue (launch/mma_ceiling.py, H100 80GB
// HBM3 at 700 W) it is ~19.6 ms. What keeps the kernel above that is the
// work each warp issues beside its mma.sync: the split, the fragment loads
// and the partial sums.
//
// Design:
//   * Split precision ("3xTF32"). Each float32 operand of an mma fragment is
//     split into hi + lo (split() of tf32x3.cuh: an AND and an FADD), and each fragment
//     pair issues lo*hi, hi*lo, hi*hi (small terms first, each pass over
//     all 16 tiles of the warp before the next) with
//     mma.sync.m16n8k8.tf32 into float32 sums: the dropped lo*lo term and
//     the truncation of lo are ~2^-20 of a product, so the sums keep
//     float32's accuracy (single-pass TF32 keeps ~2^-11). A bfloat16 value
//     is exactly a TF32 value, so bfloat16 inputs take the hi*hi pass
//     alone.
//   * The tensor cores' float32 sums truncate (round toward zero) as they
//     add into the accumulator. Over a whole contraction into one
//     accumulator that error has one sign and grows with the step count
//     (~5e-5 x max(1, |ref|) against float64 at D = 6144, where cuBLAS's
//     FFMA product has 3.5e-6). So each 32-step's products
//     are summed on the tensor cores from zero, and that partial tile is
//     added to the running sums with an FADD, which rounds to nearest: 64
//     FADDs a thread per 192 mma.sync a warp (~1e-6 against float64).
//   * mma.sync and not wgmma: TF32 wgmma reads both operands K-major from
//     shared memory, and w lies N-major (F contiguous); mma.sync fragments
//     are loaded from shared memory in any layout. The reason holds for
//     TF32 only: 16-bit wgmma reads w MN-major through its transpose bit,
//     which csrc/grouped_matmul_sm90.cu does.
//   * A CTA of 8 warps owns a 128 x 128 output tile inside ONE row block,
//     so it reads blk_expert once and every row of its tile uses the same
//     weight tile (a row block longer than 128 rows is split into several
//     tiles at its own edges, never joined with the next block's rows).
//     Each warp owns 64 x 32 of it: 4 x 4 m16n8 tiles, 64 accumulators and
//     64 partial sums a thread, ~220 registers, one CTA an SM.
//   * The contraction streams in steps of 32 through a 4-deep cp.async
//     ring in dynamic shared memory (one barrier a step). x tiles
//     lie [m][k] in rows of 32 + 16/sizeof(T) elements, w tiles [k][n] in
//     rows of 136, so every fragment load of a warp hits 32 distinct banks
//     and every row starts on 16 bytes. Where the wrapper's vec condition holds (rows a multiple of 16 bytes,
//     aligned bases) the copies are 16-byte cp.async.cg, otherwise 4-byte
//     cp.async.ca for float32 and plain loads for bfloat16 (a bfloat16
//     pair need not be 4-byte aligned); rows, columns and k past an edge
//     are zero-filled by the copy's src-size operand, so the main loop has
//     no tail branch.
//   * Launch order for L2 reuse. Output tiles are walked in groups of G
//     row tiles (G = the row block's tile count, 10 at bm = 1280, so a
//     group is one expert), the row tile fastest inside a group: the ~132
//     resident CTAs share one expert's x panel and ~13 of its weight
//     column tiles, each weight column tile is read from HBM once and the
//     x panel once per wave. HBM bytes a call moves at the mixtral shapes:
//     w once (3.22 GB), y once (0.67 / 0.25 GB), x at most once per wave of
//     a group (gate/up: 9.7 waves of the 251.7 MB x, down: 3.6 waves of
//     671 MB): <= 6.3 / 5.9 GB, where the row-tile-fastest order of the
//     FFMA kernel this replaced read x once per column tile (~32 GB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace {

constexpr int BM = 128;     // output rows per CTA
constexpr int BN = 128;     // output columns per CTA
constexpr int BK = 32;      // contraction step
constexpr int NT = 256;     // 8 warps: 2 along M x 4 along N
constexpr int NS = 4;       // cp.async ring depth
constexpr int WM = 64, WN = 32;           // warp tile
constexpr int MI = WM / 16, NI = WN / 8;  // m16n8k8 tiles of a warp tile
constexpr int LDB = BN + 8;               // row of a w tile, elements

template <typename T>
struct Tile {
  static constexpr int CE = 16 / (int)sizeof(T);  // elements of a 16-byte copy
  static constexpr int LDA = BK + CE;             // row of an x tile, elements
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int STAGE_ELEMS = A_ELEMS + BK * LDB;
  static constexpr int SMEM_BYTES = NS * STAGE_ELEMS * (int)sizeof(T);
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// One ring stage: the x tile (rows r0 .., k0 .. k0 + BK) and the w tile
// (k0 .. k0 + BK, columns c0 ..), zeros past every edge.
template <typename T, bool VEC>
__device__ __forceinline__ void load_stage(T* As, T* Bs, const T* xr, const T* we, int rows,
                                           int D, int F, int k0, int c0, int tid) {
  using TL = Tile<T>;
  if constexpr (VEC) {
    constexpr int CE = TL::CE;
    constexpr int ACH = BK / CE, BCH = BN / CE;  // 16-byte chunks of a row
#pragma unroll
    for (int i = 0; i < BM * ACH / NT; ++i) {
      const int m = tid / ACH + i * (NT / ACH), k = (tid % ACH) * CE;
      const bool ok = m < rows && k0 + k < D;
      cp16(As + m * TL::LDA + k, ok ? xr + (long long)m * D + k0 + k : xr, ok);
    }
#pragma unroll
    for (int i = 0; i < BK * BCH / NT; ++i) {
      const int k = tid / BCH + i * (NT / BCH), n = (tid % BCH) * CE;
      const bool ok = k0 + k < D && c0 + n < F;
      cp16(Bs + k * LDB + n, ok ? we + (long long)(k0 + k) * F + c0 + n : we, ok);
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < BM * BK; i += NT) {
      const int m = i / BK, k = i % BK;
      const bool ok = m < rows && k0 + k < D;
      const T* src = ok ? xr + (long long)m * D + k0 + k : xr;
      if constexpr (std::is_same<T, float>::value)
        cp4(As + m * TL::LDA + k, src, ok);
      else
        As[m * TL::LDA + k] = ok ? *src : T(0.f);
    }
#pragma unroll 4
    for (int i = tid; i < BK * BN; i += NT) {
      const int k = i / BN, n = i % BN;
      const bool ok = k0 + k < D && c0 + n < F;
      const T* src = ok ? we + (long long)(k0 + k) * F + c0 + n : we;
      if constexpr (std::is_same<T, float>::value)
        cp4(Bs + k * LDB + n, src, ok);
      else
        Bs[k * LDB + n] = ok ? *src : T(0.f);
    }
  }
}

// Grid: one CTA per (row tile, column tile), walked in groups of G row
// tiles with the row tile fastest inside a group (see the note above). A
// row tile is (row block, tile inside the block): tpb tiles a block.
template <typename T, bool VEC>
__global__ void __launch_bounds__(NT, 1)
grouped_mm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const int* __restrict__ blk_expert, T* __restrict__ y, int Tn, int D,
                  int F, int E, int bm, int tpb, long long row_tiles, int col_tiles,
                  int group) {
  using TL = Tile<T>;
  constexpr bool F32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const long long pid = blockIdx.x;
  const long long per_group = (long long)group * col_tiles;
  const long long first = pid / per_group * group;
  const long long in_group = pid - first * col_tiles;
  const int gsize = (int)(row_tiles - first < group ? row_tiles - first : group);
  const long long rt = first + in_group % gsize;
  const int c0 = (int)(in_group / gsize) * BN;
  const long long blk = rt / tpb;
  const long long blk_start = blk * bm;
  const long long r0 = blk_start + (rt - blk * tpb) * BM;
  long long r_end = blk_start + bm;
  if (r_end > Tn) r_end = Tn;
  if (r0 + BM < r_end) r_end = r0 + BM;
  if (r0 >= r_end) return;                       // the whole CTA: no barrier yet
  const int rows = (int)(r_end - r0);
  const int e = blk_expert[blk];
  const bool valid_e = e >= 0 && e < E;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;                 // mma fragment coordinates
  const int wm = (warp % 2) * WM, wn = (warp / 2) * WN;
  const T* xr = x + r0 * D;
  const T* we = w + (valid_e ? (long long)e * D * F : 0LL);
  const int nk = valid_e ? (D + BK - 1) / BK : 0;       // an invalid expert reads nothing

  // part: one step's products, summed on the tensor cores from zero, then
  // added to acc by a round-to-nearest FADD (see the note above)
  float acc[MI][NI][4], part[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = part[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nk) {
      T* st = smem + s * TL::STAGE_ELEMS;
      load_stage<T, VEC>(st, st + TL::A_ELEMS, xr, we, rows, D, F, s * BK, c0, tid);
    }
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<NS - 2>();
    __syncthreads();               // step kt landed; step kt - 1's stage is free
    const int nxt = kt + NS - 1;
    if (nxt < nk) {
      T* st = smem + (nxt % NS) * TL::STAGE_ELEMS;
      load_stage<T, VEC>(st, st + TL::A_ELEMS, xr, we, rows, D, F, nxt * BK, c0, tid);
    }
    cp_commit();
    const T* As = smem + (kt % NS) * TL::STAGE_ELEMS;
    const T* Bs = As + TL::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[MI][4], al[MI][4], bh[NI][2], bl[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const T* a = As + (wm + i * 16 + g) * TL::LDA + kk + t;
        const float v[4] = {to_f(a[0]), to_f(a[8 * TL::LDA]), to_f(a[4]),
                            to_f(a[8 * TL::LDA + 4])};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if constexpr (F32) {
            split(v[q], ah[i][q], al[i][q]);
          } else {
            ah[i][q] = __float_as_uint(v[q]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const T* b = Bs + (kk + t) * LDB + wn + j * 8 + g;
        const float v[2] = {to_f(b[0]), to_f(b[4 * LDB])};
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if constexpr (F32) {
            split(v[q], bh[j][q], bl[j][q]);
          } else {
            bh[j][q] = __float_as_uint(v[q]);
          }
        }
      }
      // pass p of tile (i, j): 0 lo*hi, 1 hi*lo, 2 hi*hi, pass by pass
#pragma unroll
      for (int n = 0; n < 3 * MI * NI; ++n) {
        const int p = n / (MI * NI), i = n % (MI * NI) / NI, j = n % NI;
        if (F32 || p == 2) mma(part[i][j], p == 0 ? al[i] : ah[i], p == 1 ? bl[j] : bh[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][j][q] += part[i][j][q];
          part[i][j][q] = 0.f;
        }
  }

  // accumulator q of tile (i, j): row wm + 16 i + g + 8 (q / 2), column
  // wn + 8 j + 2 t + q % 2
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wm + i * 16 + g + 8 * h;
      if (m >= rows) continue;
      T* yr = y + (r0 + m) * (long long)F;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int c = c0 + wn + j * 8 + 2 * t;
        if constexpr (VEC) {
          if (c < F) store2(yr + c, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          if (c < F) store1(yr + c, acc[i][j][2 * h]);
          if (c + 1 < F) store1(yr + c + 1, acc[i][j][2 * h + 1]);
        }
      }
    }
}

template <typename T, bool VEC>
int launch_t(const void* x, const void* w, const int* blk_expert, void* y, int Tn, int D,
             int F, int E, int bm, cudaStream_t s) {
  const int tpb = ((bm < Tn ? bm : Tn) + BM - 1) / BM;
  const long long nblk = ((long long)Tn + bm - 1) / bm;
  const long long row_tiles = nblk * tpb;
  const int col_tiles = (F + BN - 1) / BN;
  const long long ctas = row_tiles * col_tiles;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // a group is one row block's tiles (several small blocks make up 8),
  // at most 16 row tiles
  const int group = tpb > 16 ? 16 : (tpb >= 8 ? tpb : tpb * (8 / tpb));
  auto kern = grouped_mm_kernel<T, VEC>;
  const int smem = Tile<T>::SMEM_BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)ctas, NT, smem, s>>>((const T*)x, (const T*)w, blk_expert, (T*)y, Tn,
                                        D, F, E, bm, tpb, row_tiles, col_tiles, group);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, w and y alike). x (T, D), w (E, D, F)
// and y (T, F) contiguous; blk_expert (ceil(T / bm),) int32. vec = 1 when
// D and F are multiples of 16 bytes' worth of elements and x, w start on
// 16 bytes. Returns the error of cudaFuncSetAttribute or of the launch
// (cudaGetLastError()).
extern "C" int grouped_matmul_launch(int dtype, int vec, const void* x, const void* w,
                                     const int* blk_expert, void* y, int Tn, int D, int F,
                                     int E, int bm, void* stream) {
  cudaGetLastError();  // clear any stale error from an earlier call
  if (Tn <= 0 || F <= 0) return (int)cudaSuccess;
  if (bm < 1 || D < 0 || E < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return vec ? launch_t<float, true>(x, w, blk_expert, y, Tn, D, F, E, bm, s)
               : launch_t<float, false>(x, w, blk_expert, y, Tn, D, F, E, bm, s);
  if (dtype == 1)
    return vec ? launch_t<__nv_bfloat16, true>(x, w, blk_expert, y, Tn, D, F, E, bm, s)
               : launch_t<__nv_bfloat16, false>(x, w, blk_expert, y, Tn, D, F, E, bm, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
