// bfloat16 grouped (per-expert) matmul on Hopper's wgmma and TMA (sm_90a).
//
// Replaces, for bfloat16 x and w whose widths D and F are multiples of 8,
// the Pallas TPU kernel of repro/kernels/grouped_matmul.py:
//   K12  _kernel via grouped_matmul (pallas_call :69)  -> grouped_mm_sm90
//   y[i] (T, F) = x[i] (T, D) @ w[blk_expert[i / bm]] (D, F)
// (kernels/grouped_matmul.py route() sends float32, and bfloat16 with D or F
// not a multiple of 8, to csrc/grouped_matmul.cu). It computes what that
// file's kernel computes, with the same row-block semantics: row block b
// (rows b*bm .. b*bm + bm - 1, the last one possibly shorter) multiplies by
// the weight of expert blk_expert[b]; any bm >= 1; a block whose expert id
// lies outside [0, E) is written as zeros and reads nothing of w; y is
// written in bfloat16, rounded once from the float32 sums.
//
// What the reference computes: jnp.dot(x, w, preferred_element_type=
// float32) on bfloat16 blocks, rounded to x's dtype at the flush, one pure
// bfloat16 product with float32 sums: wgmma.f32.bf16.bf16 as it stands.
//
// What bounds it on the H100: operations. At mixtral-8x22b's training
// shape (x (10240, 6144) against w (8, 6144, 16384), bm = 1280, and its
// down twin) a call is 2.06 TFLOP, 2.08 ms at the bfloat16 rate of 989
// TFLOP/s, over ~1.7 GB of operands (0.5 ms).
//
// Design (csrc/sm90.cuh holds the PTX):
//   * A CTA owns a 128 x 256 output tile inside ONE row block (a longer
//     block is split into several tiles at its own edges, never joined with
//     the next block's rows; rows of the tile past the block or past T are
//     computed on whatever TMA reads there and never stored). It reads
//     blk_expert once.
//   * 384 threads: two consumer warpgroups, 64 rows x 256 columns each, by
//     wgmma m64n256k16 from shared memory (128 float32 accumulators a
//     thread), and a producer warpgroup whose one thread issues the TMA
//     loads (setmaxnreg: consumers 232 registers, producer 40).
//   * The contraction streams in steps of 64 through a ring of four stages
//     of 48 KB, each with a full and an empty mbarrier: the x tile (128 rows
//     x 64, one box, K-major) and the w tile (64 x 256: four boxes of 64
//     columns, read MN-major through the transpose bit, so no tile is
//     transposed or copied). x is a 2-d map (D, T), w a 3-d map (F, D, E),
//     so a tile of one expert never reads the next one's rows: TMA zero-
//     fills what lies past D, F and T (ragged widths, no tail branch; a w
//     box wholly past F is not loaded, and the columns it would feed are
//     never stored), and the 64-bit offsets into w are the map's. A consumer keeps one k-step
//     of wgmma in flight and releases the step before it.
//   * The accumulators sum over the whole contraction (no from-zero partial
//     sums): the tensor cores truncate as they add, at most 16384 / 16 =
//     1024 truncations of 2^-23, ~1.2e-4 of |y|, under the output's 2^-9.
//   * Launch order for L2 reuse, as csrc/grouped_matmul.cu: output tiles in
//     groups of G row tiles (G = a row block's tile count, 10 at bm = 1280,
//     so a group is one expert), the row tile fastest inside a group, so the
//     resident CTAs share one expert's x panel and a few of its weight
//     column tiles.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int BM = 128, BN = 256, BK = 64, ST = 4;
constexpr int NT = 384;         // two consumer warpgroups, one producer warpgroup
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
constexpr uint32_t X_BYTES = BM * BK * 2;           // one box: 128 rows x 64
constexpr uint32_t W_BOX = BK * 128;                // 64 k rows x 64 columns
constexpr uint32_t STAGE = X_BYTES + (BN / 64) * W_BOX;
constexpr uint32_t BAR = ST * STAGE;                // full[ST], empty[ST]
constexpr uint32_t SMEM = BAR + 1024 + 1024;        // + alignment slack

struct Grid {
  int Tn, D, F, E, bm, tpb, col_tiles, group;
  long long row_tiles;
};

// Grid: one CTA per (row tile, column tile), walked in groups of G row
// tiles with the row tile fastest inside a group. A row tile is (row block,
// tile inside the block): tpb tiles a block.
__global__ void __launch_bounds__(NT, 1)
    grouped_mm_sm90(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                    const int* __restrict__ blk_expert, __nv_bfloat16* __restrict__ y,
                    const Grid gr) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s0 = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = s0 + BAR, empty0 = full0 + 8 * ST;

  const long long pid = blockIdx.x;
  const long long per_group = (long long)gr.group * gr.col_tiles;
  const long long first = pid / per_group * gr.group;
  const long long in_group = pid - first * gr.col_tiles;
  const int gsize = (int)(gr.row_tiles - first < gr.group ? gr.row_tiles - first : gr.group);
  const long long rt = first + in_group % gsize;
  const int c0 = (int)(in_group / gsize) * BN;
  const long long blk = rt / gr.tpb;
  const long long blk_start = blk * gr.bm;
  const long long r0 = blk_start + (rt - blk * gr.tpb) * BM;
  long long r_end = blk_start + gr.bm;
  if (r_end > gr.Tn) r_end = gr.Tn;
  if (r0 + BM < r_end) r_end = r0 + BM;
  if (r0 >= r_end) return;                       // the whole CTA: no barrier yet
  const int rows = (int)(r_end - r0);
  const int e = blk_expert[blk];
  const int nk = e >= 0 && e < gr.E ? (gr.D + BK - 1) / BK : 0;   // a bad id reads nothing

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      // w boxes that hold a column below F (the others would be all zeros:
      // their columns are never stored, so they are not loaded)
      const int nbox = min(BN / 64, (gr.F - c0 + 63) / 64);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % ST;
        if (kt >= ST) mbar_wait(empty0 + 8 * s, (kt / ST - 1) & 1);
        const uint32_t xs = s0 + s * STAGE, ws = xs + X_BYTES, bar = full0 + 8 * s;
        mbar_expect_tx(bar, X_BYTES + nbox * W_BOX);
        tma_load_2d(xs, &tx, bar, kt * BK, (int)r0);
        for (int c = 0; c < nbox; ++c)
          tma_load_3d(ws + c * W_BOX, &tw, bar, c0 + 64 * c, kt * BK, e);
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x & 127, w = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % ST;
      mbar_wait(full0 + 8 * s, (kt / ST) & 1);
      // this warpgroup's 64 rows of the x tile, K-major; the w tile MN-major
      const uint32_t xs = s0 + s * STAGE + wg * 64 * 128, ws = s0 + s * STAGE + X_BYTES;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss_n256_tb(acc, kmajor_desc(xs + kk * 32), mnmajor_desc(ws + kk * 2048, W_BOX), 1);
      wg_commit();
      // the step before this one has completed: release its stage
      wg_wait<1>();
      if (kt > 0 && tid == 0) mbar_arrive(empty0 + 8 * ((kt - 1) % ST));
    }
    wg_wait<0>();
    fence_regs(acc);

    // acc[4 j + e] is (row 64 wg + 16 w + g + 8 (e / 2), column c0 + 8 j +
    // 2 t + e % 2); F is a multiple of 8, so a pair is wholly inside or past F
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 64 * wg + 16 * w + g + 8 * h;
      if (m >= rows) continue;
      __nv_bfloat16* yr = y + (r0 + m) * (long long)gr.F;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = c0 + 8 * j + 2 * t;
        if (c < gr.F)
          *reinterpret_cast<uint32_t*>(yr + c) =
              pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

}  // namespace

// x (T, D), w (E, D, F) and y (T, F) bfloat16, contiguous, x and w on
// 16-byte aligned bases, D and F multiples of 8 (TMA's 16-byte strides);
// blk_expert (ceil(T / bm),) int32. A tensor map cuTensorMapEncodeTiled refuses
// returns cudaErrorInvalidPitchValue. Returns the error of
// cudaFuncSetAttribute or of the launch (cudaGetLastError()).
extern "C" int grouped_matmul_sm90_launch(const void* x, const void* w, const int* blk_expert,
                                          void* y, int Tn, int D, int F, int E, int bm,
                                          void* stream) {
  cudaGetLastError();  // clear any stale error from an earlier call
  if (Tn <= 0 || F <= 0) return (int)cudaSuccess;
  if (bm < 1 || D <= 0 || E < 1 || D % 8 || F % 8) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  const cuuint64_t xdims[2] = {(cuuint64_t)D, (cuuint64_t)Tn};
  const cuuint64_t xstrides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t xbox[2] = {64, BM};
  const cuuint64_t wdims[3] = {(cuuint64_t)F, (cuuint64_t)D, (cuuint64_t)E};
  const cuuint64_t wstrides[2] = {(cuuint64_t)F * 2, (cuuint64_t)D * F * 2};
  const cuuint32_t wbox[3] = {64, BK, 1};
  if (!bf16_tiled_map(&tx, x, 2, xdims, xstrides, xbox) ||
      !bf16_tiled_map(&tw, w, 3, wdims, wstrides, wbox))
    return (int)cudaErrorInvalidPitchValue;
  Grid gr;
  gr.Tn = Tn; gr.D = D; gr.F = F; gr.E = E; gr.bm = bm;
  gr.tpb = ((bm < Tn ? bm : Tn) + BM - 1) / BM;
  const long long nblk = ((long long)Tn + bm - 1) / bm;
  gr.row_tiles = nblk * gr.tpb;
  gr.col_tiles = (F + BN - 1) / BN;
  const long long ctas = gr.row_tiles * gr.col_tiles;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // a group is one row block's tiles (several small blocks make up 8), at
  // most 16 row tiles
  gr.group = gr.tpb > 16 ? 16 : (gr.tpb >= 8 ? gr.tpb : gr.tpb * (8 / gr.tpb));
  cudaError_t err =
      cudaFuncSetAttribute(grouped_mm_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  grouped_mm_sm90<<<(unsigned)ctas, NT, SMEM, (cudaStream_t)stream>>>(
      tx, tw, blk_expert, static_cast<__nv_bfloat16*>(y), gr);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
