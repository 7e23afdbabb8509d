// Attack/release exponential moving average over time for Hopper (sm_90a):
//
//   y[0] = x[0];   a = x[t] > y[t-1] ? alpha : beta;   y[t] = y[t-1] + a*(x[t] - y[t-1])
//
// per row of x (C, T), float32 or float64. No Pallas kernel: the JAX package runs
// this recursion as a `lax.scan` (dsptoolbox_tpu/helpers/smoothing.py:
// 164-175), a loop on the device. Its coefficient depends on the state, so
// no associative scan computes it in log depth, and a loop of torch ops
// would launch several kernels per sample.
//
// Bound on the H100: the dependent chain of each step, not bytes. A step
// is compare -> select -> multiply -> add on the carry, four dependent
// operations; the row's T steps are serial. The operations are the scan's
// in its order, each rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn
// and their double twins: no contraction into an FMA), so the kernel
// equals the plain torch loop bit for bit in either type.
//
// Design: one warp per row. The warp's lanes stage the row in chunks of
// kChunk samples in shared memory with element-wide cp.async, one chunk ahead
// of the one being walked (double buffer), so lane 0, which walks the
// chain, reads shared memory and never waits on device memory; the results
// overwrite the chunk in place and the warp stores them coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 2048;

template <typename T>
__device__ __forceinline__ void cp_elem(T* dst, const T* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (sizeof(T) == 4)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

// carry + a*(v - carry), each operation rounded to nearest on its own
__device__ __forceinline__ float ema_step(float carry, float a, float v) {
    return __fadd_rn(carry, __fmul_rn(a, __fsub_rn(v, carry)));
}

__device__ __forceinline__ double ema_step(double carry, double a, double v) {
    return __dadd_rn(carry, __dmul_rn(a, __dsub_rn(v, carry)));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

template <typename F>
__global__ void __launch_bounds__(32)
ema_attack_release_kernel(const F* __restrict__ x, F* __restrict__ y, long long T,
                          long long ldx, long long ldy, F alpha, F beta) {
    __shared__ F buf[2][kChunk];
    const int lane = threadIdx.x;
    const F* xr = x + (long long)blockIdx.x * ldx;
    F* yr = y + (long long)blockIdx.x * ldy;
    const long long n_chunks = (T + kChunk - 1) / kChunk;

    auto stage = [&](long long k) {
        if (k < n_chunks) {
            const long long base = k * kChunk;
            F* dst = buf[k & 1];
            const int n = (int)(T - base < kChunk ? T - base : kChunk);
            for (int j = lane; j < n; j += 32) cp_elem(dst + j, xr + base + j);
        }
        cp_commit();  // an empty group past the end keeps the count
    };

    stage(0);
    F carry = 0;
    for (long long k = 0; k < n_chunks; ++k) {
        stage(k + 1);
        cp_wait_one();  // chunk k has landed (this lane's copies)
        __syncwarp();   // ... and every lane's
        F* cur = buf[k & 1];
        const long long base = k * kChunk;
        const int n = (int)(T - base < kChunk ? T - base : kChunk);
        if (lane == 0) {
            int j = 0;
            if (k == 0) {
                carry = cur[0];
                j = 1;
            }
#pragma unroll 8
            for (; j < n; ++j) {
                const F v = cur[j];
                carry = ema_step(carry, v > carry ? alpha : beta, v);
                cur[j] = carry;
            }
        }
        __syncwarp();
        for (int j = lane; j < n; j += 32) yr[base + j] = cur[j];
        __syncwarp();  // the buffer is staged again two chunks on
    }
}

template <typename F>
int launch(const F* x, F* y, long long C, long long T, long long ldx, long long ldy, F alpha,
           F beta, void* stream) {
    if (C <= 0 || T <= 0 || C > 2147483647LL || ldx < T || ldy < T)
        return (int)cudaErrorInvalidValue;
    ema_attack_release_kernel<F><<<(unsigned)C, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        x, y, T, ldx, ldy, alpha, beta);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dsptb_ema_attack_release_f32(const float* x, float* y, long long C, long long T,
                                            long long ldx, long long ldy, float alpha,
                                            float beta, void* stream) {
    return launch(x, y, C, T, ldx, ldy, alpha, beta, stream);
}

extern "C" int dsptb_ema_attack_release_f64(const double* x, double* y, long long C, long long T,
                                            long long ldx, long long ldy, double alpha,
                                            double beta, void* stream) {
    return launch(x, y, C, T, ldx, ldy, alpha, beta, stream);
}
