"""Measure the peak rate of mma.sync m16n8k8 in TF32 on one card: the
ceiling of the port's "cc" flash kernel (``csrc/flash_attention.cu``),
whose products run on it.

    PYTHONPATH=src python3 benchmarks/torch_mma_tf32_peak.py

Compiles a loop of independent m16n8k8 products (``CHAINS`` accumulators a
warp, no loads) into ``build/kernels/``, times it with CUDA events at 4, 8
and 16 warps an SM, and prints TFLOP/s and products per scheduler per
microsecond beside the card's name and power limit; needs a card.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int CH>
__global__ void loop(float* out, int iters) {
  float c[CH][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = 3u * threadIdx.x;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < CH; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a0), "r"(a1), "r"(7u), "r"(9u), "r"(i), "r"(j));
  float s = 0.0f;
  for (int j = 0; j < CH; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// ms of one launch of `blocks` x 128 threads after a warm-up
extern "C" float mma_peak_run(int chains, int blocks, int iters) {
  float* out;
  cudaMalloc(&out, blocks * 128 * sizeof(float));
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  float ms = -1.0f;
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(a);
    if (chains == 1) loop<1><<<blocks, 128>>>(out, iters);
    else if (chains == 4) loop<4><<<blocks, 128>>>(out, iters);
    else loop<8><<<blocks, 128>>>(out, iters);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    cudaEventElapsedTime(&ms, a, b);
  }
  cudaFree(out);
  return ms;
}
"""
CHAINS = (1, 4, 8)
WARPS_PER_SM = (4, 8, 16)
ITERS = 20000


def main() -> int:
    import torch
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("torch_mma_tf32_peak: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "mma_tf32_peak.cu"
    lib = build.BUILD_DIR / "mma_tf32_peak.so"
    src.write_text(SOURCE)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).mma_peak_run
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_float
    print(card, flush=True)
    for chains in CHAINS:
        for warps in WARPS_PER_SM:
            blocks = sms * warps // 4
            ms = fn(chains, blocks, ITERS)
            n = blocks * 4 * ITERS * chains         # products
            print(f"m16n8k8 tf32: {chains} chains a warp, {warps} warps an "
                  f"SM: {ms:.3f} ms, {n * 2048 / ms / 1e9:.1f} TFLOP/s, "
                  f"{n / (sms * 4) / (ms * 1e3):.1f} products a scheduler "
                  f"a microsecond [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
