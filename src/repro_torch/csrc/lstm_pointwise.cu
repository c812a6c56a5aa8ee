// Fused LSTM cell update on Hopper (sm_90a): one elementwise pass.
//
// Replaces the Pallas TPU kernel of repro/kernels/lstm_pointwise.py:
//   K5  _kernel via lstm_pointwise (pallas_call :68)  -> lstm_pointwise_kernel
// gates (B, 4H) hold [i | f | g | o] along the last axis (row stride ldg),
// c_prev (B, H); in float32:
//   c' = sigmoid(f + forget_bias) * c + sigmoid(i) * tanh(g)
//   h' = sigmoid(o) * tanh(c')
// with sigmoid(x) = 1 / (1 + expf(-x)), written as h, c (B, H) in gates'
// type (float32 or bfloat16). Forward only, as the reference's kernel.
//
// What bounds it on the H100: bytes, and below them the launch. At
// zaremba-medium (B=20, H=650) a call reads 52,000 gate and 13,000 cell
// values and writes 26,000: 364 KB, 0.11 us at 3.35 TB/s, far under the
// few microseconds of a launch. The design is the plainest one: one thread
// per (row, unit), a grid-stride loop over B x H, the four gate reads of a
// unit H apart (each warp's reads of one gate are contiguous). Any B and H.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

template <typename T>
__global__ void __launch_bounds__(NT)
lstm_pointwise_kernel(const T* __restrict__ gates, const T* __restrict__ c_prev,
                      T* __restrict__ h_out, T* __restrict__ c_out, int B, int H,
                      long long ldg, float forget_bias) {
  const long long n = (long long)B * H;
  for (long long idx = blockIdx.x * (long long)NT + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * NT) {
    const long long b = idx / H;
    const int j = (int)(idx - b * H);
    const T* g = gates + b * ldg + j;
    const float gi = to_f(g[0]);
    const float gf = to_f(g[H]);
    const float gg = to_f(g[2 * (long long)H]);
    const float go = to_f(g[3 * (long long)H]);
    const float c = sigmoid(gf + forget_bias) * to_f(c_prev[idx]) + sigmoid(gi) * tanhf(gg);
    from_f(c_out + idx, c);
    from_f(h_out + idx, sigmoid(go) * tanhf(c));
  }
}

template <typename T>
int launch(const void* gates, const void* c_prev, void* h_out, void* c_out, int B, int H,
           long long ldg, float forget_bias, cudaStream_t s) {
  const long long n = (long long)B * H;
  const long long blocks = (n + NT - 1) / NT;
  const int grid = (int)(blocks < 65535 ? blocks : 65535);
  lstm_pointwise_kernel<T><<<grid, NT, 0, s>>>(
      (const T*)gates, (const T*)c_prev, (T*)h_out, (T*)c_out, B, H, ldg, forget_bias);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (gates, c_prev, h_out and c_out alike).
// gates rows are ldg elements apart; c_prev, h_out and c_out are (B, H)
// contiguous. Returns cudaGetLastError() after the launch.
extern "C" int lstm_pointwise_launch(int dtype, const void* gates, const void* c_prev,
                                     void* h_out, void* c_out, int B, int H,
                                     long long ldg, float forget_bias, void* stream) {
  cudaGetLastError();  // clear any stale error from an earlier call
  if (B <= 0 || H <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(gates, c_prev, h_out, c_out, B, H, ldg, forget_bias, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(gates, c_prev, h_out, c_out, B, H, ldg, forget_bias, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
