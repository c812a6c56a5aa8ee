// The causal / sliding-window masks of the flash kernels (K9-K11 in
// csrc/flash_attention.cu and csrc/flash_attention_sm90.cu), for any
// argument struct with `causal` and `window` (<= 0: none), `Sk`: query qpos
// sees key kpos when (!causal || qpos >= kpos) && (window <= 0 || qpos -
// kpos < window), positions counted from 0 in both sequences, as the
// reference.
#pragma once

namespace {

template <typename A>
__device__ __forceinline__ bool visible(const A& a, int qpos, int kpos) {
  return (!a.causal || qpos >= kpos) && (a.window <= 0 || qpos - kpos < a.window);
}

// kv range [lo, hi) that rows [q0, q1] can see.
template <typename A>
__device__ __forceinline__ void kv_range(const A& a, int q0, int q1, int& lo, int& hi) {
  hi = a.causal ? min(a.Sk, q1 + 1) : a.Sk;
  lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
}

// Whether any (query, key) pair of rows [qa, qb] x keys [ka, kb] is visible
// (empty ranges are not).
template <typename A>
__device__ __forceinline__ bool block_live(const A& a, int qa, int qb, int ka, int kb) {
  return qa <= qb && ka <= kb && (!a.causal || qb >= ka) &&
         (a.window <= 0 || qa - kb < a.window);
}

// Whether every (query, key) pair of rows [qa, qb] x keys [ka, kb] is visible.
template <typename A>
__device__ __forceinline__ bool block_full(const A& a, int qa, int qb, int ka, int kb) {
  return (!a.causal || qa >= kb) && (a.window <= 0 || qb - ka < a.window);
}

}  // namespace
