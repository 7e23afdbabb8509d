// Fused delay-and-sum map for Hopper (sm_90a): steering build + quadratic
// form in one kernel.
//
//   map[g, f] = Re(h^H C_f h),   h[m] = amp[m, g] * exp(-i k_f diff[m, g])
//
// Replaces the Pallas kernel das_map_fused / _das_kernel
// (dsptoolbox_tpu/ops/pallas_das.py). See ops/cuda_das.py for what bounds
// it on the H100 and why the design is what it is.
//
// Layout: amp, diff (M, G) f32 row-major; k (F,) f32; cre, cim (F, M, M)
// f32 row-major, C[f][l][m]; out (G, F) f32. C is not assumed Hermitian.
//
// One block per (bin f, tile of GT = 64 grid points), of NG groups of 64
// threads (NG = 4, fewer for M <= 16): thread (group j, lane gl) owns grid
// point gl of the tile and the rows of row blocks j, j + NG, ... (blocks of
// 8 rows). Mics are taken in tiles of R (8, 16, 32 or 64, the smallest
// that holds M, else 64). For each row tile L and column tile K the block
//   - builds h for the mics of L (and of K, when K != L) with exact
//     sincosf into shared memory ([R][GT], all threads together);
//   - stages C_f[L, K] transposed in shared memory (ct[k][l]);
// and each thread forms t_l = sum_{k in K} C[l][k] h_k for eight rows l at
// a time in registers: per k, two 128-bit broadcast loads of C's real
// parts and two of its imaginary parts and one steering element feed 32
// FMAs. It adds Re(conj(h_l) t_l) = hr_l t_re + hi_l t_im to its partial
// sum, which is linear in t, so partial sums over column tiles and row
// groups add up exactly; the groups' sums are added in a fixed order at
// the end. Every M is taken: for M > 64 the column tile's steering is
// recomputed per row tile. fp32 FFMA throughout: no tensor cores, no TF32.

#include <climits>
#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int GT = 64;  // grid points per block

// row groups and threads per block for mic tile R: one group per row
// block of 8, at most 4
template <int R>
struct Tile {
  static constexpr int NG = R / 8 < 4 ? R / 8 : 4;
  static constexpr int NT = NG * GT;
};

// h for mics [m0, m0 + R) of the block's grid points [gbase, gbase + GT)
// into h_re / h_im ([R][GT]), by all NT threads; zero past M and G.
template <int R, int NT>
__device__ __forceinline__ void build_steering(
    float* __restrict__ h_re, float* __restrict__ h_im,
    const float* __restrict__ amp, const float* __restrict__ diff, float kf,
    int m0, int M, int G, int gbase, int tid) {
  for (int idx = tid; idx < R * GT; idx += NT) {
    const int r = idx / GT;
    const int m = m0 + r;
    const int g = gbase + (idx - r * GT);
    float hr = 0.f, hi = 0.f;
    if (m < M && g < G) {
      const size_t i = static_cast<size_t>(m) * G + g;
      const float a = amp[i];
      float s, c;
      sincosf(kf * diff[i], &s, &c);
      hr = a * c;
      hi = -(a * s);
    }
    h_re[idx] = hr;
    h_im[idx] = hi;
  }
}

template <int R>
__global__ void __launch_bounds__(Tile<R>::NT, 2) das_map_kernel(
    const float* __restrict__ amp, const float* __restrict__ diff,
    const float* __restrict__ kvec, const float* __restrict__ cre,
    const float* __restrict__ cim, float* __restrict__ out, int M, int G,
    int F, int n_gtiles) {
  constexpr int NG = Tile<R>::NG;
  constexpr int NT = Tile<R>::NT;
  extern __shared__ float4 smem4[];
  float* ct_re = reinterpret_cast<float*>(smem4);  // [R][R], ct[k][l]
  float* ct_im = ct_re + R * R;
  float* hl_re = ct_im + R * R;  // [R][GT], mics of the row tile
  float* hl_im = hl_re + R * GT;
  float* part = hl_im + R * GT;  // [NG][GT], the groups' sums
  float* hk_re = part + NG * GT;  // [R][GT], column tile (only if M > R)
  float* hk_im = hk_re + R * GT;

  const int tid = threadIdx.x;
  const int gl = tid % GT;
  const int grp = tid / GT;  // a warp lies in one group
  const int f = blockIdx.x / n_gtiles;
  const int gbase = (blockIdx.x - f * n_gtiles) * GT;
  const float kf = kvec[f];
  const float* cre_f = cre + static_cast<size_t>(f) * M * M;
  const float* cim_f = cim + static_cast<size_t>(f) * M * M;
  const int n_tiles = (M + R - 1) / R;
  float q = 0.f;

  for (int lt = 0; lt < n_tiles; ++lt) {
    const int l0 = lt * R;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * R;
      __syncthreads();  // every thread is done with the previous tiles
      if (kt == 0) {
        build_steering<R, NT>(hl_re, hl_im, amp, diff, kf, l0, M, G, gbase, tid);
      }
      const float* hk_r = hl_re;
      const float* hk_i = hl_im;
      if (kt != lt) {
        build_steering<R, NT>(hk_re, hk_im, amp, diff, kf, k0, M, G, gbase, tid);
        hk_r = hk_re;
        hk_i = hk_im;
      }
      for (int idx = tid; idx < R * R; idx += NT) {
        const int ll = idx % R;
        const int kk = idx / R;
        const int l = l0 + ll;
        const int m = k0 + kk;
        float vr = 0.f, vi = 0.f;
        if (l < M && m < M) {
          const size_t j = static_cast<size_t>(l) * M + m;
          vr = cre_f[j];
          vi = cim_f[j];
        }
        ct_re[idx] = vr;  // idx == kk * R + ll
        ct_im[idx] = vi;
      }
      __syncthreads();
#pragma unroll 1
      for (int rb = grp * 8; rb < R; rb += NG * 8) {
        float tr[8], ti[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          tr[j] = 0.f;
          ti[j] = 0.f;
        }
#pragma unroll 8
        for (int kk = 0; kk < R; ++kk) {
          const float hr = hk_r[kk * GT + gl];
          const float hi = hk_i[kk * GT + gl];
          const float4 a0 = *reinterpret_cast<const float4*>(ct_re + kk * R + rb);
          const float4 a1 = *reinterpret_cast<const float4*>(ct_re + kk * R + rb + 4);
          const float4 b0 = *reinterpret_cast<const float4*>(ct_im + kk * R + rb);
          const float4 b1 = *reinterpret_cast<const float4*>(ct_im + kk * R + rb + 4);
          const float cr[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float ci[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            tr[j] = fmaf(cr[j], hr, tr[j]);
            tr[j] = fmaf(-ci[j], hi, tr[j]);
            ti[j] = fmaf(cr[j], hi, ti[j]);
            ti[j] = fmaf(ci[j], hr, ti[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          q = fmaf(hl_re[(rb + j) * GT + gl], tr[j], q);
          q = fmaf(hl_im[(rb + j) * GT + gl], ti[j], q);
        }
      }
    }
  }
  part[grp * GT + gl] = q;
  __syncthreads();
  if (grp == 0 && gbase + gl < G) {
    float sum = part[gl];
#pragma unroll
    for (int j = 1; j < NG; ++j) sum += part[j * GT + gl];
    out[static_cast<size_t>(gbase + gl) * F + f] = sum;
  }
}

template <int R>
int launch(const float* amp, const float* diff, const float* k,
           const float* cre, const float* cim, float* out, int M, int G,
           int F, cudaStream_t stream) {
  const int n_tiles = (M + R - 1) / R;
  const int n_gtiles = (G + GT - 1) / GT;
  if (static_cast<long long>(n_gtiles) * F > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const size_t floats = 2 * static_cast<size_t>(R) * R +
                        (n_tiles > 1 ? 4 : 2) * static_cast<size_t>(R) * GT +
                        Tile<R>::NG * GT;
  const size_t bytes = floats * sizeof(float);
  // above 48 KB only after opting in
  cudaError_t err = cudaFuncSetAttribute(
      das_map_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  das_map_kernel<R><<<n_gtiles * F, Tile<R>::NT, bytes, stream>>>(
      amp, diff, k, cre, cim, out, M, G, F, n_gtiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dsptb_das_map_f32(const float* amp, const float* diff,
                                 const float* k, const float* cre,
                                 const float* cim, float* out, int M, int G,
                                 int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 8) return launch<8>(amp, diff, k, cre, cim, out, M, G, F, s);
  if (M <= 16) return launch<16>(amp, diff, k, cre, cim, out, M, G, F, s);
  if (M <= 32) return launch<32>(amp, diff, k, cre, cim, out, M, G, F, s);
  return launch<64>(amp, diff, k, cre, cim, out, M, G, F, s);
}
