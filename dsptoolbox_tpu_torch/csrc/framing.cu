// Fused framing + windowing + per-frame mean removal (the STFT/Welch/CSM
// front end) for Hopper (sm_90a). Replaces the Pallas kernel
// `windowed_frames_pallas` (dsptoolbox_tpu/ops/pallas_framing.py:45).
//
//   out[b, k, l] = x[b, k*step + l - pad] * win[l]    (x read as 0 outside [0, T))
//   detrend:  out[b, k, :] -= mean_l out[b, k, l]
//
// `pad` is the STFT's symmetric zero padding: the frames are those of the
// signal padded by `pad` zeros at both ends, read from the unpadded x.
//
// Bound on the H100: device-memory bytes. A row reads ~T floats and writes
// K*L; frames overlap by L - step, so every input sample feeds L / step
// frames. At the chain's STFT (16 x 384,000, L = 1024, hop 512) that is
// 24.6 MB read and 49.2 MB written: 22 us at 3.35 TB/s.
//
// Design. The first kernel gave each (row, frame) pair a block, read x and
// the window with scalar loads and 64-bit index arithmetic under a bounds
// test per element, read every sample twice (overlap) and, with detrend,
// read the frame a second time after a two-barrier block reduction. Here
// (frames_warp_kernel, L <= kWarpMaxL):
//   - a block takes a run of `fpb` consecutive frames of one row and stages
//     its input span [k0*step - pad, (k0+n-1)*step + L - pad) once in shared
//     memory with 16-byte cp.async copies; the span's start is rounded down
//     to 16 bytes of x, chunks inside the row are copied whole and only the
//     chunks at its edges (the STFT padding, the keep_last_frames tail,
//     another row) go element by element, zero-filled outside [0, T). A
//     misaligned x takes 4-byte copies throughout. The window is staged
//     once per block;
//   - one warp takes one frame: each lane holds its 4*NV samples times the
//     window in registers, the frame's sum is reduced with shuffles, the
//     mean subtracted and the frame stored with float4 stores. x is read
//     once from device memory and once from shared memory; no barrier per
//     frame;
//   - offsets inside a row and inside shared memory are 32-bit.
// Frames longer than kWarpMaxL (Welch takes up to 2^18) run
// frames_block_kernel: one block per frame, float4 loads and stores where
// the alignment allows, a block reduction for the mean and a second read of
// the frame (from L2) with detrend.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpMaxL = 2048;             // longest frame of the warp kernel
constexpr int kSmemFloats = 48 * 1024 / 4;  // the warp kernel's span + window

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

// 4-byte async copy, zero-filled when !valid (src then only needs to be a
// valid address)
__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// One block: frames k0 .. k0 + n - 1 of row b, n <= fpb; warp w takes
// frames w, w + kWarps, ... of the run. Lane `lane` owns samples 4 (lane +
// 32 i) .. + 3 for i < NV (L <= 128 NV).
template <int NV, bool XVEC>
__global__ void __launch_bounds__(kThreads)
frames_warp_kernel(const float* __restrict__ x, const float* __restrict__ win,
                   float* __restrict__ out, long long T, long long pad, long long step,
                   int L, long long K, int fpb, int blocks_per_row, int wvec16, int detrend) {
    extern __shared__ float4 smem4[];
    const int L4 = (L + 3) & ~3;
    float* ws = reinterpret_cast<float*>(smem4);  // (L4,), zero past L
    float* xs = ws + L4;                          // the run's input span
    const int tid = threadIdx.x;
    const long long b = blockIdx.x / blocks_per_row;
    const long long k0 = (long long)(blockIdx.x - b * blocks_per_row) * fpb;
    const int n = (int)min((long long)fpb, K - k0);

    // stage the span: xs[j] holds x's element a0 + j (linear index), a0 the
    // span's first element rounded down to 16 bytes; zero outside row b
    const long long row0 = b * T;
    const long long g0 = row0 + k0 * step - pad;
    const long long a0 = g0 - (((g0 % 4) + 4) % 4);
    const int lead = (int)(g0 - a0);
    const int span = (n - 1) * (int)step + L;  // (fpb - 1) step + L fits the span
    const int chunks = (lead + span + 3) >> 2;
    for (int c = tid; c < chunks; c += kThreads) {
        const long long q = a0 + 4 * c;
        float* dst = xs + 4 * c;
        if (XVEC && q >= row0 && q + 4 <= row0 + T) {
            cp16(dst, x + q);
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool ok = q + e >= row0 && q + e < row0 + T;
                cp4(dst + e, ok ? x + q + e : x, ok);
            }
        }
    }
    if (wvec16) {
        for (int q = 4 * tid; q < L; q += 4 * kThreads) cp16(ws + q, win + q);
    } else {
        for (int l = tid; l < L4; l += kThreads) cp4(ws + l, l < L ? win + l : win, l < L);
    }
    cp_commit_wait_all();
    __syncthreads();

    const int warp = tid >> 5;
    const int lane = tid & 31;
    const bool ovec = (L & 3) == 0;  // float4 rows of out
    for (int j = warp; j < n; j += kWarps) {
        const int off = lead + j * (int)step;  // the frame's first sample in xs
        const bool xvec = (off & 3) == 0;
        float4 v[NV];
        float sum = 0.0f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
            const int l = 4 * (lane + 32 * i);
            float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
            if (l + 3 < L) {
                a = xvec ? *reinterpret_cast<const float4*>(xs + off + l)
                         : make_float4(xs[off + l], xs[off + l + 1], xs[off + l + 2],
                                       xs[off + l + 3]);
            } else if (l < L) {  // the last, partial quad of the frame
                a.x = xs[off + l];
                if (l + 1 < L) a.y = xs[off + l + 1];
                if (l + 2 < L) a.z = xs[off + l + 2];
            }
            const float4 w = *reinterpret_cast<const float4*>(ws + min(l, L4 - 4));
            v[i] = l < L ? make_float4(a.x * w.x, a.y * w.y, a.z * w.z, a.w * w.w) : a;
            sum += (v[i].x + v[i].y) + (v[i].z + v[i].w);
        }
        float mean = 0.0f;
        if (detrend) mean = warp_sum(sum) / (float)L;
        float* orow = out + (b * K + k0 + j) * L;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
            const int l = 4 * (lane + 32 * i);
            const float4 o = make_float4(v[i].x - mean, v[i].y - mean, v[i].z - mean,
                                         v[i].w - mean);
            if (ovec && l < L) {
                *reinterpret_cast<float4*>(orow + l) = o;
            } else if (l < L) {
                orow[l] = o.x;
                if (l + 1 < L) orow[l + 1] = o.y;
                if (l + 2 < L) orow[l + 2] = o.z;
                if (l + 3 < L) orow[l + 3] = o.w;
            }
        }
    }
}

__device__ __forceinline__ float block_sum(float v, float* red) {
    v = warp_sum(v);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = warp_sum(lane < kWarps ? red[lane] : 0.0f);
        if (lane == 0) red[kWarps] = v;
    }
    __syncthreads();
    return red[kWarps];
}

// x[t0 + l .. + 3] * win[l .. + 3], zero outside [0, T); float4 loads when
// VEC (x's row and t0 on 16 bytes, L % 4 == 0) and the quad lies in [0, T)
template <bool VEC>
__device__ __forceinline__ float4 windowed_quad(const float* __restrict__ xrow,
                                                const float* __restrict__ win, long long t0,
                                                long long T, int l, int L) {
    const long long t = t0 + l;
    float4 a, w;
    if (VEC && t >= 0 && t + 4 <= T) {
        a = __ldg(reinterpret_cast<const float4*>(xrow + t));
        w = __ldg(reinterpret_cast<const float4*>(win + l));
    } else {
        float av[4], wv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const bool in = l + e < L;
            av[e] = in && t + e >= 0 && t + e < T ? __ldg(xrow + t + e) : 0.0f;
            wv[e] = in ? __ldg(win + l + e) : 0.0f;
        }
        a = make_float4(av[0], av[1], av[2], av[3]);
        w = make_float4(wv[0], wv[1], wv[2], wv[3]);
    }
    return make_float4(a.x * w.x, a.y * w.y, a.z * w.z, a.w * w.w);
}

// One block per (row, frame), for frames longer than kWarpMaxL
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
frames_block_kernel(const float* __restrict__ x, const float* __restrict__ win,
                    float* __restrict__ out, long long T, long long pad, long long step,
                    long long K, int L, int detrend) {
    __shared__ float red[kWarps + 1];
    const long long frame = blockIdx.x;  // b * K + k
    const long long b = frame / K;
    const float* xrow = x + b * T;
    float* orow = out + frame * L;
    const long long t0 = (frame - b * K) * step - pad;
    const bool vec_out = (L & 3) == 0;

    float mean = 0.0f;
    if (detrend) {
        float sum = 0.0f;
        for (int l = 4 * threadIdx.x; l < L; l += 4 * kThreads) {
            const float4 v = windowed_quad<VEC>(xrow, win, t0, T, l, L);
            sum += (v.x + v.y) + (v.z + v.w);
        }
        mean = block_sum(sum, red) / (float)L;
    }
    for (int l = 4 * threadIdx.x; l < L; l += 4 * kThreads) {
        const float4 v = windowed_quad<VEC>(xrow, win, t0, T, l, L);
        const float4 o = make_float4(v.x - mean, v.y - mean, v.z - mean, v.w - mean);
        if (vec_out && l + 4 <= L) {
            *reinterpret_cast<float4*>(orow + l) = o;
        } else {
            const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (l + e < L) orow[l + e] = ov[e];
        }
    }
}

template <int NV>
cudaError_t launch_warp(bool xvec, unsigned blocks, size_t smem, cudaStream_t st,
                        const float* x, const float* win, float* out, long long T,
                        long long pad, long long step, int L, long long K, int fpb, int bpr,
                        int detrend) {
    const int wvec16 = (L & 3) == 0 && reinterpret_cast<uintptr_t>(win) % 16 == 0;
    if (xvec)
        frames_warp_kernel<NV, true><<<blocks, kThreads, smem, st>>>(
            x, win, out, T, pad, step, L, K, fpb, bpr, wvec16, detrend);
    else
        frames_warp_kernel<NV, false><<<blocks, kThreads, smem, st>>>(
            x, win, out, T, pad, step, L, K, fpb, bpr, wvec16, detrend);
    return cudaGetLastError();
}

}  // namespace

// x (B, T), win (L,), out (B, K, L) with K the frame count of T + 2*pad
// samples; all fp32, contiguous, on one device, out on 16 bytes.
// frames_per_block: frames a block of the warp kernel takes (L <= 2048;
// span and window within 48 KB), or 0 for one block per frame (any L).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int dsptb_windowed_frames_f32(const float* x, const float* win, float* out,
                                         long long B, long long T, long long pad,
                                         long long step, int L, long long K, int detrend,
                                         int frames_per_block, void* stream) {
    if (B <= 0 || K <= 0 || L <= 0 || step <= 0 || pad < 0 || frames_per_block < 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (frames_per_block == 0) {
        if (B * K > 2147483647LL) return (int)cudaErrorInvalidValue;
        const bool vec = (L & 3) == 0 && (T & 3) == 0 && (step & 3) == 0 && (pad & 3) == 0 &&
                         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(win) % 16 == 0;
        if (vec)
            frames_block_kernel<true><<<(unsigned)(B * K), kThreads, 0, st>>>(
                x, win, out, T, pad, step, K, L, detrend);
        else
            frames_block_kernel<false><<<(unsigned)(B * K), kThreads, 0, st>>>(
                x, win, out, T, pad, step, K, L, detrend);
        return (int)cudaGetLastError();
    }
    const long long fpb = frames_per_block;
    const long long span_max = (fpb - 1) * step + L;
    const long long floats = ((L + 3) & ~3) + 4 * ((span_max + 3 + 3) / 4);
    const long long bpr = (K + fpb - 1) / fpb;
    if (L > kWarpMaxL || floats > kSmemFloats || B * bpr > 2147483647LL)
        return (int)cudaErrorInvalidValue;
    const bool xvec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const unsigned blocks = (unsigned)(B * bpr);
    const size_t smem = (size_t)floats * sizeof(float);
    const long long s = step;
    const int nv = (L + 127) / 128;
    cudaError_t err;
    if (nv <= 1)
        err = launch_warp<1>(xvec, blocks, smem, st, x, win, out, T, pad, s, L, K, (int)fpb,
                             (int)bpr, detrend);
    else if (nv <= 2)
        err = launch_warp<2>(xvec, blocks, smem, st, x, win, out, T, pad, s, L, K, (int)fpb,
                             (int)bpr, detrend);
    else if (nv <= 4)
        err = launch_warp<4>(xvec, blocks, smem, st, x, win, out, T, pad, s, L, K, (int)fpb,
                             (int)bpr, detrend);
    else if (nv <= 8)
        err = launch_warp<8>(xvec, blocks, smem, st, x, win, out, T, pad, s, L, K, (int)fpb,
                             (int)bpr, detrend);
    else
        err = launch_warp<16>(xvec, blocks, smem, st, x, win, out, T, pad, s, L, K, (int)fpb,
                              (int)bpr, detrend);
    return (int)err;
}
