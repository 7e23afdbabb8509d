// Attack/release exponential moving average over time for Hopper (sm_90a), in
// two forms, per row of x (C, T), float32 or float64:
//
//   smoothing:  y[0] = x[0];      a = x[t] > y[t-1] ? alpha : beta;
//               y[t] = y[t-1] + a*(x[t] - y[t-1])
//   average:    y[-1] = carry[row]; c = x[t] > y[t-1] ? inc : dec;
//               y[t] = x[t]*c + (1 - c)*y[t-1]
//
// No Pallas kernel: the JAX package runs both recursions as a `lax.scan`
// (smoothing: dsptoolbox_tpu/helpers/smoothing.py:164-175; average: the
// streaming ExponentialAverageFilter, dsptoolbox_tpu/realtime/misc.py:
// 62-77, which starts each block from the channel's state), a loop on the
// device. Its coefficient depends on the state, so
// no associative scan computes it in log depth, and a loop of torch ops
// would launch several kernels per sample.
//
// Bound on the H100: the dependent chain of each step, not bytes. A step
// is compare -> select -> multiply -> add on the carry, four dependent
// operations; the row's T steps are serial. The operations are the scan's
// in its order, each rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn
// and their double twins: no contraction into an FMA), so the kernel
// equals the plain torch loop bit for bit in either type. The average form
// takes 1 - c rounded once per coefficient, as the loop's `1 - c` does.
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

// x*c + (1 - c)*carry, with one_minus_c = 1 - c rounded on its own
__device__ __forceinline__ float average_step(float carry, float c, float one_minus_c, float v) {
    return __fadd_rn(__fmul_rn(v, c), __fmul_rn(one_minus_c, carry));
}

__device__ __forceinline__ double average_step(double carry, double c, double one_minus_c,
                                               double v) {
    return __dadd_rn(__dmul_rn(v, c), __dmul_rn(one_minus_c, carry));
}

__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// kAverage false: the smoothing form (alpha, beta; carry0 unused); true: the
// average form from carry0[row] (alpha = inc, beta = dec)
template <bool kAverage, typename F>
__global__ void __launch_bounds__(32)
ema_kernel(const F* __restrict__ x, const F* __restrict__ carry0, F* __restrict__ y,
           long long T, long long ldx, long long ldy, F alpha, F beta) {
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
    const F alpha1 = sub_rn(F(1), alpha), beta1 = sub_rn(F(1), beta);
    if constexpr (kAverage) carry = carry0[blockIdx.x];
    for (long long k = 0; k < n_chunks; ++k) {
        stage(k + 1);
        cp_wait_one();  // chunk k has landed (this lane's copies)
        __syncwarp();   // ... and every lane's
        F* cur = buf[k & 1];
        const long long base = k * kChunk;
        const int n = (int)(T - base < kChunk ? T - base : kChunk);
        if (lane == 0) {
            int j = 0;
            if (!kAverage && k == 0) {
                carry = cur[0];
                j = 1;
            }
#pragma unroll 8
            for (; j < n; ++j) {
                const F v = cur[j];
                if constexpr (kAverage) {
                    const bool up = v > carry;
                    carry = average_step(carry, up ? alpha : beta, up ? alpha1 : beta1, v);
                } else {
                    carry = ema_step(carry, v > carry ? alpha : beta, v);
                }
                cur[j] = carry;
            }
        }
        __syncwarp();
        for (int j = lane; j < n; j += 32) yr[base + j] = cur[j];
        __syncwarp();  // the buffer is staged again two chunks on
    }
}

template <bool kAverage, typename F>
int launch(const F* x, const F* carry0, F* y, long long C, long long T, long long ldx,
           long long ldy, F alpha, F beta, void* stream) {
    if (C <= 0 || T <= 0 || C > 2147483647LL || ldx < T || ldy < T ||
        (kAverage && carry0 == nullptr))
        return (int)cudaErrorInvalidValue;
    ema_kernel<kAverage, F><<<(unsigned)C, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        x, carry0, y, T, ldx, ldy, alpha, beta);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dsptb_ema_attack_release_f32(const float* x, float* y, long long C, long long T,
                                            long long ldx, long long ldy, float alpha,
                                            float beta, void* stream) {
    return launch<false, float>(x, nullptr, y, C, T, ldx, ldy, alpha, beta, stream);
}

extern "C" int dsptb_ema_attack_release_f64(const double* x, double* y, long long C, long long T,
                                            long long ldx, long long ldy, double alpha,
                                            double beta, void* stream) {
    return launch<false, double>(x, nullptr, y, C, T, ldx, ldy, alpha, beta, stream);
}

// the average form: carry (C,) is each row's state before its first sample
extern "C" int dsptb_ema_average_f32(const float* x, const float* carry, float* y, long long C,
                                     long long T, long long ldx, long long ldy, float inc,
                                     float dec, void* stream) {
    return launch<true, float>(x, carry, y, C, T, ldx, ldy, inc, dec, stream);
}

extern "C" int dsptb_ema_average_f64(const double* x, const double* carry, double* y,
                                     long long C, long long T, long long ldx, long long ldy,
                                     double inc, double dec, void* stream) {
    return launch<true, double>(x, carry, y, C, T, ldx, ldy, inc, dec, stream);
}
