// Fused framing + windowing + per-frame mean removal (the STFT/Welch/CSM
// front end). Replaces the Pallas kernel `windowed_frames_pallas`
// (dsptoolbox_tpu/ops/pallas_framing.py).
//
//   out[b, k, l] = x[b, k*step + l - pad] * win[l]    (x read as 0 outside [0, T))
//   detrend:  out[b, k, :] -= mean_l out[b, k, l]
//
// `pad` is the STFT's symmetric zero padding: the frames are those of the
// signal padded by `pad` zeros at both ends, read from the unpadded x.
//
// Bound on the H100: device-memory bytes. Each frame writes L floats and
// reads L inputs, which overlap their neighbours by L - step, so the
// unavoidable traffic is ~(T + K*L) floats per row. The design reads the
// unpadded input directly (no padded or framed copy is materialised), keeps
// the window in the read-only cache, and writes every output once. With
// detrend the frame is read a second time from L1/L2 instead of being
// staged through device memory.
//
// Launch: one block per (row, frame) pair on a 1-D grid of B*K blocks;
// block-reduced fp32 frame sum. Any L and step are accepted (no tiling constraints).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float block_sum(float v, float* red) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < (blockDim.x >> 5) ? red[lane] : 0.0f;
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) red[0] = v;
    }
    __syncthreads();
    return red[0];
}

__global__ void __launch_bounds__(kThreads)
windowed_frames_kernel(const float* __restrict__ x, const float* __restrict__ win,
                       float* __restrict__ out, long long T, long long pad,
                       long long step, long long K, int L, int detrend) {
    __shared__ float red[32];
    const long long frame = blockIdx.x;  // b * K + k
    const long long b = frame / K;
    const long long k = frame - b * K;
    const float* xrow = x + b * T;
    float* orow = out + frame * (long long)L;
    const long long start = k * step - pad;

    float sum = 0.0f;
    for (int l = threadIdx.x; l < L; l += blockDim.x) {
        const long long t = start + l;
        const float v = (t >= 0 && t < T ? __ldg(xrow + t) : 0.0f) * __ldg(win + l);
        sum += v;
        if (!detrend) orow[l] = v;
    }
    if (!detrend) return;
    const float mean = block_sum(sum, red) / (float)L;
    for (int l = threadIdx.x; l < L; l += blockDim.x) {
        const long long t = start + l;
        const float v = (t >= 0 && t < T ? __ldg(xrow + t) : 0.0f) * __ldg(win + l);
        orow[l] = v - mean;
    }
}

}  // namespace

// x (B, T), win (L,), out (B, K, L) with K the frame count of T + 2*pad
// samples; all fp32, contiguous, on one device.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int dsptb_windowed_frames_f32(const float* x, const float* win, float* out,
                                         long long B, long long T, long long pad,
                                         long long step, int L, long long K, int detrend,
                                         void* stream) {
    if (B <= 0 || K <= 0 || L <= 0 || step <= 0 || pad < 0 || B * K > 2147483647LL)
        return (int)cudaErrorInvalidValue;
    windowed_frames_kernel<<<(unsigned)(B * K), kThreads, 0, (cudaStream_t)stream>>>(
        x, win, out, T, pad, step, K, L, detrend);
    return (int)cudaGetLastError();
}
