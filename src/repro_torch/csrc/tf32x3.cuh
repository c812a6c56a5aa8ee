// Split-precision TF32 ("3xTF32") on mma.sync for Hopper (sm_90a): the
// helpers that K12 (csrc/grouped_matmul.cu), K9-K11 (csrc/flash_attention.cu)
// and K6's WG kernel (csrc/slstm_scan.cu) share.
//
// What the route does. Each float32 operand a of an mma.sync.m16n8k8 TF32
// fragment is split into a = hi + lo (split(): an AND and an FADD), and a
// product issues lo*hi, hi*lo, then hi*hi (passes(): small terms first) into
// float32 sums. The dropped lo*lo term and the truncation of lo are ~2^-20
// of a product, so the sums keep float32's accuracy (single-pass TF32 keeps
// ~2^-11). A bfloat16 input widened to float32 is already a TF32 value and
// takes the hi pass alone (SPLIT = false).
//
// The tensor cores truncate (round toward zero) as they add into a float32
// accumulator, an error of one sign that grows with the length of the
// contraction. So every user sums one tile of its contraction on the cores
// from zero and adds that partial tile to its running sums by an FADD,
// which rounds to nearest.
//
// Fragment coordinates (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g + 8,
// t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g);
// d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// 16- and 4-byte global -> shared copies; with full == false nothing is
// read and the destination is zero-filled (the copy's src-size operand).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// a = hi + lo as TF32 operands. The core reads a TF32 operand's top 19 bits
// and drops the low 13, so hi is a itself, and lo = a - (a with its low 13
// bits cleared), exact in float32; the core truncates lo in turn, an error
// of at most 2^-20 |a|. (cvt.rna.tf32.f32, which rounds, is ~4 instructions
// on sm_90, and two a value made the split outweigh the mma.sync.) Without
// SPLIT the value is already a TF32 value and lo is not read.
template <bool SPLIT = true>
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(a);
  if constexpr (SPLIT) lo = __float_as_uint(a - __uint_as_float(hi & 0xffffe000u));
  else lo = 0u;
}

// a = hi + lo with hi rounded to the nearest TF32 value (ties away from
// zero: add half of the dropped bits' weight, then clear them), so |lo| <=
// 2^-11 |a|, and lo = a - hi exact (the core truncates it, at most 2^-21
// |a|). A product of two such values (lo*lo dropped) is off by at most
// ~1.25 x 2^-20 of |a b|, where split() allows ~3 x 2^-20: one integer
// add more a value. inf is not kept (it turns into NaN).
__device__ __forceinline__ void split_rn(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, float32 sums.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The passes of one k-step over N n-tiles, small terms first: lo*hi where
// A splits, hi*lo where B splits, then hi*hi.
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
// mma fragment's (g, t) layout. Rows of a multiple of 4 floats plus 4 put the
// 8 rows of a matrix on 8 distinct 16-byte bank groups.
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
// The same A from a tile and its plane of remainders (split once
// beforehand): two ldmatrix and no arithmetic.
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

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

}  // namespace
