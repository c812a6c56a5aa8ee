"""The card's mma.sync TF32 ceiling, the rate K12's tensor-core route can reach.

    PYTHONPATH=src python -m repro_torch.launch.mma_ceiling

Builds a probe kernel (``PROBE_SRC``) that issues nothing but
``mma.sync.m16n8k8`` TF32 products on register operands and prints its
rate in TFLOP/s for 16 independent accumulator tiles a warp with 8 warps
an SM, 8 warps twice an SM and 4 warps an SM, and for one accumulator
tile (each product waits for the one before). K12
(``csrc/grouped_matmul.cu``) issues three such products for each float32
product, so 3 x its flops over this rate is the least time that route can
take on the card. CUDA only.
"""
from __future__ import annotations

import ctypes
import subprocess

import torch

from repro_torch.kernels import _build

PROBE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int ACC>
__global__ void probe(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int q = 0; q < 4; ++q) a[q] = __float_as_uint(1.0f + 1e-3f * (threadIdx.x + q)) & 0xffffe000u;
  for (int q = 0; q < 2; ++q) b[q] = __float_as_uint(1.0f - 1e-3f * (threadIdx.x + q)) & 0xffffe000u;
  float acc[ACC][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[k % ACC][0]), "+f"(acc[k % ACC][1]), "+f"(acc[k % ACC][2]),
            "+f"(acc[k % ACC][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int k = 0; k < ACC; ++k) s += acc[k][0] + acc[k][1] + acc[k][2] + acc[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int probe_launch(int acc, int ctas, int threads, int iters, float* out,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (acc == 16) probe<16><<<ctas, threads, 0, st>>>(out, iters);
  else if (acc == 1) probe<1><<<ctas, threads, 0, st>>>(out, iters);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
"""


def mma_ceiling(iters=16384):
    """[(accumulators, warps a CTA, CTAs, TFLOP/s)] of the probe kernel: 16
    mma.sync TF32 m16n8k8 (2048 flops each) per iteration per warp."""
    out_dir = _build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "tf32_mma_probe.cu"
    src.write_text(PROBE_SRC)
    lib_path = out_dir / "libtf32_mma_probe.so"
    r = subprocess.run([_build.nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                        "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for the probe:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_launch.argtypes = [i, i, i, i, p, p]
    lib.probe_launch.restype = i
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for acc, threads, per_sm in ((16, 256, 1), (16, 256, 2), (16, 128, 1), (1, 256, 1)):
        ctas = sms * per_sm
        out = torch.empty(ctas * threads, device="cuda")

        def run():
            code = lib.probe_launch(acc, ctas, threads, iters, out.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream)
            if code != 0:
                raise RuntimeError(f"probe launch: CUDA error {code}")
        run()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        run()
        e.record()
        e.synchronize()
        ms = s.elapsed_time(e)
        flops = ctas * threads // 32 * iters * 16 * 2048
        rows.append((acc, threads // 32, ctas, flops / ms / 1e9))
    return rows


def main():
    if not torch.cuda.is_available():
        raise SystemExit("mma_ceiling: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"card: {smi}")
    for acc, warps, ctas, tf in mma_ceiling():
        print(f"mma.sync TF32 m16n8k8 probe: {acc} accumulator tile(s) a warp, {warps} "
              f"warps x {ctas} CTAs: {tf:.1f} TFLOP/s")


if __name__ == "__main__":
    main()
