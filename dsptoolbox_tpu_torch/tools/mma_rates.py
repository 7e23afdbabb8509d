"""Throughput of the warp-level tensor-core instructions the port's kernels use.

    python -m dsptoolbox_tpu_torch.tools.mma_rates

Times ``mma.sync`` TF32 m16n8k8 (B3's x·h) and fp64 m8n8k4 and m16n8k4
(B3's s·G) on a CUDA device: every warp issues 16 independent products in a
loop, at 8, 12 and 16 warps an SM, and the rate is the products' flops over
the CUDA-event time. These are the ceilings a kernel built on ``mma.sync``
can reach, beside the card's published peaks (which ``wgmma`` reaches).
Needs a CUDA device and ``nvcc``; the benchmark is built into the kernels'
build directory.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from .. import _cuda

_SRC = r"""
#include <cuda_runtime.h>
#include <cstdint>
template <int KIND>
__global__ void bench(double* out, int iters) {
    float f[16][4] = {};
    double d[16][4] = {};
    const uint32_t a0 = threadIdx.x, a1 = a0 + 1, a2 = a0 + 2, a3 = a0 + 3;
    const uint32_t b0 = 3u * threadIdx.x, b1 = b0 + 1;
    const double x0 = threadIdx.x, x1 = x0 + 1.0, y = 0.5;
    for (int i = 0; i < iters; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            if (KIND == 0)
                asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                             "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
                             : "+f"(f[j][0]), "+f"(f[j][1]), "+f"(f[j][2]), "+f"(f[j][3])
                             : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
            if (KIND == 1)
                asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
                             "{%3}, {%0, %1};" : "+d"(d[j][0]), "+d"(d[j][1]) : "d"(x0), "d"(y));
            if (KIND == 2)
                asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
                             "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
                             : "+d"(d[j][0]), "+d"(d[j][1]), "+d"(d[j][2]), "+d"(d[j][3])
                             : "d"(x0), "d"(x1), "d"(y));
        }
    double s = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) s += f[j][0] + f[j][3] + d[j][0] + d[j][1] + d[j][3];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int kind, int blocks, int iters, double* out) {
    if (kind == 0) bench<0><<<blocks, 128>>>(out, iters);
    if (kind == 1) bench<1><<<blocks, 128>>>(out, iters);
    if (kind == 2) bench<2><<<blocks, 128>>>(out, iters);
    return (int)cudaGetLastError();
}
"""

# (kind, instruction, flops per warp-level product)
_KINDS = ((0, "TF32 m16n8k8", 2 * 16 * 8 * 8), (1, "fp64 m8n8k4", 2 * 8 * 8 * 4),
          (2, "fp64 m16n8k4", 2 * 16 * 8 * 4))


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_rates: needs a CUDA device", file=sys.stderr)
        return 2
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _cuda.BUILD_DIR / "mma_rates.cu"
    lib_path = _cuda.BUILD_DIR / "libmma_rates.so"
    src.write_text(_SRC)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS[:-2], "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 4 * 128, dtype=torch.float64, device="cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(f"card: {card}; {sms} SMs")
    iters = 2000
    for kind, name, flops in _KINDS:
        for warps_per_sm in (8, 12, 16):
            blocks = sms * warps_per_sm // 4
            _cuda.check(lib.run(kind, blocks, 10, out.data_ptr()), "mma_rates")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            lib.run(kind, blocks, iters, out.data_ptr())
            end.record()
            end.synchronize()
            n = blocks * 4 * iters * 16
            rate = n * flops / (start.elapsed_time(end) * 1e-3) / 1e12
            print(f"{name}: {warps_per_sm} warps/SM, 16 independent products a warp: "
                  f"{rate:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
