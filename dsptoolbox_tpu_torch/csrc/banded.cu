// Banded-operator matmul for Hopper (sm_90a): the O(F·W) fractional-octave
// complex-smoothing operator applied to a batch of spectra, every segment
// of the operator's plan in one launch.
//
//   for each segment s, tile b, row r < TR with b * TR + r < rows[s]:
//   out[row0[s] + b * TR + r, c] = sum_k slab_s[b, r, k] * x[offsets_s[b] + k, c]
//
// Replaces the Pallas kernel banded_matmul / _banded_kernel
// (dsptoolbox_tpu/ops/pallas_banded.py:43), which ran one launch per
// segment. See ops/cuda_banded.py for what bounds it on the H100 and why
// the design is what it is.
//
// Layout: slab_s (NB_s, TR, SPAN_s) f32 row-major; offsets_s (NB_s,) i32;
// x (F, C) f32 row-major; out (R, C) f32 row-major. Rows of x outside
// [0, F) read as zero.
//
// One block per (segment, tile, 64 of its rows, 32 columns of x), of 256
// threads in four k-groups of 64; blocks of the longest bands first. The
// block walks the band in chunks of 128 k through two shared-memory stages
// filled by cp.async (16-byte copies where alignment allows, zero-filled
// outside the tile, the band and x): while the k-groups compute on one
// stage, the next chunk's slab rows (64 x 128, row-major) and x window
// (128 x 32) land in the other. k-group g takes k in [32g, 32g + 32) of a
// chunk; each of its threads keeps an 8 x 4 register tile of out (rows
// ty + 8 i, columns 4 tx .. 4 tx + 3), so per 4 k eight 16-byte slab loads
// and four 16-byte x loads from shared memory feed 128 FMAs, and every slab
// element is read from device memory once for all 32 columns. The four
// groups' tiles are added in a fixed order at the end. fp32 FFMA only: no
// tensor cores, no TF32.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_SEG = 8;
constexpr int RB = 64;            // rows per block
constexpr int CB = 32;            // columns per block
constexpr int KCH = 128;          // k per staged chunk
constexpr int KG = 4;             // k groups
constexpr int KPG = KCH / KG;     // k per group and chunk
constexpr int NT = 256;           // threads: KG groups of 64
constexpr int SW = KCH + 4;       // slab row stride in shared memory (floats)
constexpr int STAGE = RB * SW + KCH * CB;  // floats per stage
constexpr size_t SMEM_BYTES = 2 * STAGE * sizeof(float);

static_assert((KG - 1) * 64 * 32 <= STAGE, "reduction scratch fits a stage");

struct Segs {
  const float* slab[MAX_SEG];
  const int* offsets[MAX_SEG];
  int span[MAX_SEG];
  int row0[MAX_SEG];
  int rows[MAX_SEG];
  int block0[MAX_SEG + 1];  // first block of each segment, in launch order
  int n;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy, zero-filled when !valid (src then only needs to be a
// valid address)
__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// queue one chunk's copies into a stage: slab rows [r0, r0 + RB) of the
// tile and k [k0, k0 + KCH), and the x rows off + k0 .. of columns
// [c0, c0 + CB)
template <bool SVEC, bool XVEC>
__device__ __forceinline__ void load_chunk(
    float* sw, float* sx, const float* __restrict__ slab_b,
    const float* __restrict__ x, int tid, int r0, int k0, int off, int c0,
    int TR, int SPAN, int F, int C) {
#pragma unroll
  for (int i = 0; i < RB * KCH / 4 / NT; ++i) {
    const int idx = tid + i * NT;
    const int rl = idx >> 5;  // 32 float4 per slab row
    const int q = idx & 31;
    const int r = r0 + rl;
    const int k = k0 + 4 * q;
    float* dst = sw + rl * SW + 4 * q;
    const float* src = slab_b + static_cast<size_t>(r) * SPAN + k;
    if (SVEC) {
      const bool ok = r < TR && k < SPAN;  // SPAN % 4 == 0
      cp16(dst, ok ? src : slab_b, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = r < TR && k + j < SPAN;
        cp4(dst + j, ok ? src + j : slab_b, ok);
      }
    }
  }
  if (XVEC) {  // C % 4 == 0
#pragma unroll
    for (int i = 0; i < KCH * CB / 4 / NT; ++i) {
      const int idx = tid + i * NT;
      const int kk = idx >> 3;  // 8 float4 per x row of the block
      const int c = c0 + 4 * (idx & 7);
      const long long g = static_cast<long long>(off) + k0 + kk;
      const bool ok = c < C && k0 + kk < SPAN && g >= 0 && g < F;
      cp16(sx + kk * CB + 4 * (idx & 7), ok ? x + g * C + c : x, ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < KCH * CB / NT; ++i) {
      const int idx = tid + i * NT;
      const int kk = idx >> 5;
      const int c = c0 + (idx & 31);
      const long long g = static_cast<long long>(off) + k0 + kk;
      const bool ok = c < C && k0 + kk < SPAN && g >= 0 && g < F;
      cp4(sx + idx, ok ? x + g * C + c : x, ok);
    }
  }
}

template <bool SVEC, bool XVEC>
__global__ void __launch_bounds__(NT, 2) banded_kernel(
    const Segs segs, const float* __restrict__ x, float* __restrict__ out,
    int TR, int F, int C, int row_blocks) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  int s = 0;
  while (s + 1 < segs.n && static_cast<int>(blockIdx.x) >= segs.block0[s + 1]) ++s;
  const int local = blockIdx.x - segs.block0[s];
  const int b = local / row_blocks;
  const int r0 = (local - b * row_blocks) * RB;
  const int c0 = blockIdx.y * CB;
  const int SPAN = segs.span[s];
  const int off = segs.offsets[s][b];
  const float* slab_b = segs.slab[s] + static_cast<size_t>(b) * TR * SPAN;

  const int tid = threadIdx.x;
  const int grp = tid >> 6;
  const int lt = tid & 63;
  const int ty = lt >> 3;  // rows ty + 8 i
  const int tx = lt & 7;   // columns 4 tx .. 4 tx + 3

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  const int n_chunks = (SPAN + KCH - 1) / KCH;
  if (n_chunks > 0) {
    load_chunk<SVEC, XVEC>(smem, smem + RB * SW, slab_b, x, tid, r0, 0, off,
                           c0, TR, SPAN, F, C);
  }
  cp_commit();
  for (int ch = 0; ch < n_chunks; ++ch) {
    float* stage = smem + (ch & 1) * STAGE;
    if (ch + 1 < n_chunks) {
      float* nxt = smem + ((ch + 1) & 1) * STAGE;
      load_chunk<SVEC, XVEC>(nxt, nxt + RB * SW, slab_b, x, tid, r0,
                             (ch + 1) * KCH, off, c0, TR, SPAN, F, C);
    }
    cp_commit();
    cp_wait<1>();  // this chunk's copies have landed
    __syncthreads();
    const float* wg = stage + grp * KPG;
    const float* xg = stage + RB * SW + grp * KPG * CB + 4 * tx;
#pragma unroll
    for (int kk = 0; kk < KPG; kk += 4) {
      float4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = *reinterpret_cast<const float4*>(xg + (kk + j) * CB);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(wg + (ty + 8 * i) * SW + kk);
        const float w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][0] = fmaf(w[j], v[j].x, acc[i][0]);
          acc[i][1] = fmaf(w[j], v[j].y, acc[i][1]);
          acc[i][2] = fmaf(w[j], v[j].z, acc[i][2]);
          acc[i][3] = fmaf(w[j], v[j].w, acc[i][3]);
        }
      }
    }
    __syncthreads();  // the stage is refilled two chunks on
  }
  cp_wait<0>();

  // add the k-groups' tiles: groups 1..3 park theirs in stage 0
  float* red = smem;  // [element e][group - 1][lt]
  if (grp > 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        red[((i * 4 + j) * (KG - 1) + grp - 1) * 64 + lt] = acc[i][j];
      }
    }
  }
  __syncthreads();
  if (grp == 0) {
    const int row_lim = segs.rows[s] - b * TR;  // valid tile rows
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r0 + ty + 8 * i;
      if (r >= TR || r >= row_lim) continue;
      float* orow = out + (static_cast<size_t>(segs.row0[s]) + static_cast<size_t>(b) * TR + r) * C;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + 4 * tx + j;
        float sum = acc[i][j];
#pragma unroll
        for (int g = 0; g < KG - 1; ++g) {
          sum += red[((i * 4 + j) * (KG - 1) + g) * 64 + lt];
        }
        if (c < C) orow[c] = sum;
      }
    }
  }
}

constexpr int MAX_DEV = 64;

template <bool SVEC, bool XVEC>
int launch(const Segs& segs, const float* x, float* out, int TR, int F, int C,
           int row_blocks, dim3 grid, cudaStream_t stream) {
  // the shared-memory opt-in, once per template instance and device (a
  // repeat from a racing thread sets the same value)
  static bool opted_in[MAX_DEV] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEV || !opted_in[dev]) {
    err = cudaFuncSetAttribute(banded_kernel<SVEC, XVEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(SMEM_BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 0 && dev < MAX_DEV) opted_in[dev] = true;
  }
  banded_kernel<SVEC, XVEC><<<grid, NT, SMEM_BYTES, stream>>>(segs, x, out, TR, F,
                                                               C, row_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n_seg segments of one plan: slabs[s] (nbs[s], TR, spans[s]), offsets[s]
// (nbs[s],); segment s writes rows [row0s[s], row0s[s] + rows[s]) of out
// (R, C). x (F, C).
extern "C" int dsptb_banded_matmul_f32(const float* const* slabs,
                                       const int* const* offsets,
                                       const int* nbs, const int* spans,
                                       const int* row0s, const int* rows,
                                       int n_seg, int TR, const float* x,
                                       int F, int C, float* out, void* stream) {
  if (n_seg < 1 || n_seg > MAX_SEG || TR <= 0 || C <= 0) {
    return n_seg == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  }
  const int row_blocks = (TR + RB - 1) / RB;
  // launch order: longest bands first, so the longest blocks start first
  int order[MAX_SEG];
  for (int i = 0; i < n_seg; ++i) order[i] = i;
  for (int i = 1; i < n_seg; ++i) {
    for (int j = i; j > 0 && spans[order[j]] > spans[order[j - 1]]; --j) {
      const int t = order[j];
      order[j] = order[j - 1];
      order[j - 1] = t;
    }
  }
  Segs segs{};
  long long blocks = 0;
  bool svec = true;
  for (int i = 0; i < n_seg; ++i) {
    const int s = order[i];
    segs.slab[i] = slabs[s];
    segs.offsets[i] = offsets[s];
    segs.span[i] = spans[s];
    segs.row0[i] = row0s[s];
    segs.rows[i] = rows[s];
    segs.block0[i] = static_cast<int>(blocks);
    blocks += static_cast<long long>(nbs[s]) * row_blocks;
    svec = svec && spans[s] % 4 == 0 &&
           reinterpret_cast<uintptr_t>(slabs[s]) % 16 == 0;
  }
  segs.block0[n_seg] = static_cast<int>(blocks);
  segs.n = n_seg;
  const int col_blocks = (C + CB - 1) / CB;
  if (blocks > 0x7fffffffLL || col_blocks > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (blocks == 0) return 0;
  const bool xvec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(blocks), col_blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (svec && xvec) return launch<true, true>(segs, x, out, TR, F, C, row_blocks, grid, st);
  if (svec) return launch<true, false>(segs, x, out, TR, F, C, row_blocks, grid, st);
  if (xvec) return launch<false, true>(segs, x, out, TR, F, C, row_blocks, grid, st);
  return launch<false, false>(segs, x, out, TR, F, C, row_blocks, grid, st);
}
