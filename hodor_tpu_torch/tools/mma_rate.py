"""The rate at which one GPU executes `mma.sync.m16n8k32` on unsigned bytes
from registers: the ceiling of the tensor-core body of the ntt_level
kernel (csrc/byte_plane_mma.cuh), which contracts with that instruction.

    python -m hodor_tpu_torch.tools.mma_rate

Compiles a probe kernel of its own with nvcc into build/ (nothing of the
port's kernels): every warp runs a loop of 16 independent products whose
operands never leave its registers, so neither shared memory nor device
memory is touched. One block per multiprocessor, with 1, 2 and 4 warps a
scheduler. Prints the card's name and power limit, then per case the
clocks a product takes on one tensor core (from clock64 inside the
kernel) and the int8 TOP/s of the whole card (from CUDA events), beside
the 1,979 TOP/s of the data sheet, which `wgmma` is needed to reach.
Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void probe(int* out, long long* clocks, int iters, uint32_t seed) {
  uint32_t a[4][4], b[4][2];
  int acc[4][4][4];
  for (int i = 0; i < 4; ++i) {
    for (int q = 0; q < 4; ++q) a[i][q] = seed * (threadIdx.x + 1) + 17 * i + q;
    for (int q = 0; q < 2; ++q) b[i][q] = seed * (threadIdx.x + 3) + 29 * i + q;
    for (int j = 0; j < 4; ++j)
      for (int o = 0; o < 4; ++o) acc[i][j][o] = 0;
  }
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_u8(acc[i][j], a[i], b[j]);
  }
  const long long t1 = clock64();
  int sum = 0;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      for (int o = 0; o < 4; ++o) sum ^= acc[i][j][o];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
  if (threadIdx.x == 0) clocks[blockIdx.x] = t1 - t0;
}

extern "C" int mma_probe(int* out, long long* clocks, int blocks, int threads, int iters,
                         void* stream) {
  probe<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, clocks, iters, 0x9E3779B1u);
  return (int)cudaGetLastError();
}
"""

PRODUCTS_PER_ITER = 16
MACS_PER_PRODUCT = 16 * 8 * 32


def main() -> int:
    from hodor_tpu_torch.field import kernels as K

    if not torch.cuda.is_available():
        print("mma_rate: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi}")
    os.makedirs(K.BUILD_DIR, exist_ok=True)
    src = os.path.join(K.BUILD_DIR, "mma_probe.cu")
    lib_path = os.path.join(K.BUILD_DIR, "libmma_probe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mma_probe.argtypes = [vp, vp, i32, i32, i32, vp]
    lib.mma_probe.restype = i32

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 1 << 16
    for warps_per_scheduler in (1, 2, 4):
        threads = 128 * warps_per_scheduler
        out = torch.zeros(sms * threads, dtype=torch.int32, device="cuda")
        clocks = torch.zeros(sms, dtype=torch.int64, device="cuda")

        def launch():
            code = lib.mma_probe(out.data_ptr(), clocks.data_ptr(), sms, threads, iters,
                                 K._stream())
            if code:
                raise RuntimeError(f"probe launch failed with CUDA error {code}")

        launch()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        per_core = iters * PRODUCTS_PER_ITER * warps_per_scheduler
        clk = float(clocks.double().mean().item()) / per_core
        tops = 2 * MACS_PER_PRODUCT * per_core * 4 * sms / (ms * 1e-3) / 1e12
        print(f"{warps_per_scheduler} warp(s) a scheduler: {clk:.2f} clocks a product on one "
              f"tensor core, {tops:.0f} int8 TOP/s on {sms} multiprocessors "
              f"({ms:.3f} ms; data sheet 1979 TOP/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
