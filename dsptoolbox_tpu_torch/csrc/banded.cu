// Banded-operator matmul for Hopper (sm_90a): the O(F·W) fractional-octave
// complex-smoothing operator applied to a batch of spectra, every segment
// of the operator's plan in one launch.
//
//   for each segment s, tile b, row r < TR with b * TR + r < rows[s]:
//   out[row0[s] + b * TR + r, c] = sum_k slab_s[b, r, k] * x[offsets_s[b] + k, c]
//
// Replaces the Pallas kernel banded_matmul / _banded_kernel
// (dsptoolbox_tpu/ops/pallas_banded.py:43), which ran one launch per
// segment and one (128, SPAN) x (SPAN, C) MXU dot per grid step.
//
// Bound on the H100: the slab's bytes. At the measurement path's plan
// (32,769 bins, 1/3 octave, 32 columns) the slabs hold 158.3 M weights, 633
// MB: 0.19 ms at 3.35 TB/s. Each weight serves 32 columns, 1.01e10 FLOP:
// 0.15 ms at the 67 TFLOP/s of fp32 FFMA. An FFMA kernel must issue FMAs
// near their peak while it streams at its peak, and the first one (8 x 4
// register tiles, two cp.async stages) reached neither: 0.30 ms device.
// Here the product runs on the tensor cores as three TF32 products of a
// hi/lo split (fp32 accuracy: hi + lo carries 22 of a float's 24 bits):
// 3.04e10 TF32 FLOP, ~0.10 ms at the ~300 TFLOP/s that mma.sync reaches on
// the card, which leaves the issue slots to the slab stream.
//
// Layout: slab_s (NB_s, TR, SPAN_s) f32 row-major; offsets_s (NB_s,) i32;
// x (F, C) f32 row-major; out (R, C) f32 row-major. Rows of x outside
// [0, F) read as zero.
//
// One block per (segment, tile, 64 of its rows, 32 columns of x), 8 warps;
// blocks of the longest bands first. The block walks the band in chunks of
// 64 k through a ring of 4 shared-memory stages filled by cp.async (16-byte
// copies where alignment allows, zero-filled outside the tile, the band
// and x): three chunks stay in flight while the warps compute on the
// fourth, one barrier a chunk. Warp w takes rows 32 (w % 2) .. + 31 (two
// m16 tiles) and k 16 (w / 2) .. + 15 of every chunk (two k8 steps); per
// step it splits its A fragments (the slab, rows x k) once and its B
// fragments (the x window, k x columns) once, and runs mma.sync m16n8k8
// lo·hi, hi·lo, hi·hi (cvt.rna rounding; never a single TF32 product) into
// 2 x 4 tensor-core accumulator tiles. After each chunk these are added to
// fp32 running sums and cleared: a sum kept in the tensor cores'
// accumulators over a whole band drifted by 0.10 rad on the 1/3-octave
// smoothing of a 5,000-rad unwrapped phase (their adds round toward zero).
// Every slab element is read from device memory once, for all 32 columns.
// The four k groups' sums are added in a fixed order at the end.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_SEG = 8;
constexpr int RB = 64;            // rows per block
constexpr int CB = 32;            // columns per block: four n8 tiles
constexpr int KCH = 64;           // k per staged chunk
constexpr int STAGES = 4;         // chunks in the ring
constexpr int NW = 8;             // warps: 2 row groups x 4 k groups
constexpr int NT = 32 * NW;
constexpr int KG = 4;             // k groups
constexpr int KPW = KCH / KG;     // k per warp and chunk
constexpr int SW = KCH + 4;       // slab row stride in shared memory (floats):
                                  // A fragment loads hit 32 distinct banks
constexpr int XW = CB + 8;        // x row stride: B fragment loads likewise
constexpr int STAGE = RB * SW + KCH * XW;  // floats per stage
constexpr size_t SMEM_BYTES = STAGES * STAGE * sizeof(float);

static_assert((KG - 1) * 2 * 32 * 32 <= STAGES * STAGE, "reduction scratch fits the ring");

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
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The parts of an fp32 value for three TF32 products: v = hi + lo, both
// rounded with cvt.rna (hi + lo carries 22 of v's 24 bits; lo·lo is
// dropped).
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// c += a b, m16n8k8, TF32 in, fp32 sums. Lane (gid = lane / 4, tig = lane %
// 4) holds a = A[gid, tig], A[gid + 8, tig], A[gid, tig + 4], A[gid + 8, tig
// + 4]; b = B[tig, gid], B[tig + 4, gid]; c = C[gid, 2 tig], C[gid, 2 tig +
// 1], C[gid + 8, 2 tig], C[gid + 8, 2 tig + 1].
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
    const int rl = idx / (KCH / 4);
    const int q = idx % (KCH / 4);
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
      const int kk = idx / (CB / 4);
      const int cq = 4 * (idx % (CB / 4));
      const long long g = static_cast<long long>(off) + k0 + kk;
      const bool ok = c0 + cq < C && k0 + kk < SPAN && g >= 0 && g < F;
      cp16(sx + kk * XW + cq, ok ? x + g * C + c0 + cq : x, ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < KCH * CB / NT; ++i) {
      const int idx = tid + i * NT;
      const int kk = idx / CB;
      const int c = idx % CB;
      const long long g = static_cast<long long>(off) + k0 + kk;
      const bool ok = c0 + c < C && k0 + kk < SPAN && g >= 0 && g < F;
      cp4(sx + kk * XW + c, ok ? x + g * C + c0 + c : x, ok);
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
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wr = 32 * (warp & 1);       // the warp's first row in the block
  const int kg = warp >> 1;             // its k group
  const int ntc = min(4, (C - c0 + 7) >> 3);  // n8 tiles holding columns

  float acc[2][4][4], tc[2][4][4];  // running sums; the chunk's, on the tensor cores
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = tc[mt][nt][i] = 0.f;

  const int n_chunks = (SPAN + KCH - 1) / KCH;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_chunks) {
      float* sg = smem + st * STAGE;
      load_chunk<SVEC, XVEC>(sg, sg + RB * SW, slab_b, x, tid, r0, st * KCH, off, c0, TR,
                             SPAN, F, C);
    }
    cp_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_wait<STAGES - 2>();  // chunk ch has landed
    __syncthreads();        // for every thread; chunk ch - 1's stage is free
    if (ch + STAGES - 1 < n_chunks) {
      float* sg = smem + ((ch + STAGES - 1) % STAGES) * STAGE;
      load_chunk<SVEC, XVEC>(sg, sg + RB * SW, slab_b, x, tid, r0, (ch + STAGES - 1) * KCH,
                             off, c0, TR, SPAN, F, C);
    }
    cp_commit();
    const float* sa = smem + (ch % STAGES) * STAGE + (wr + gid) * SW + kg * KPW + tig;
    const float* sb = smem + (ch % STAGES) * STAGE + RB * SW + (kg * KPW + tig) * XW + gid;
#pragma unroll
    for (int ks = 0; ks < KPW; ks += 8) {
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* a = sa + mt * 16 * SW + ks;
        split_tf32(a[0], ahi[mt][0], alo[mt][0]);
        split_tf32(a[8 * SW], ahi[mt][1], alo[mt][1]);
        split_tf32(a[4], ahi[mt][2], alo[mt][2]);
        split_tf32(a[8 * SW + 4], ahi[mt][3], alo[mt][3]);
      }
      uint32_t bhi[4][2], blo[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* bp = sb + ks * XW + 8 * nt;
        split_tf32(bp[0], bhi[nt][0], blo[nt][0]);
        split_tf32(bp[4 * XW], bhi[nt][1], blo[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          if (nt < ntc) mma_tf32(tc[mt][nt], alo[mt], bhi[nt][0], bhi[nt][1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          if (nt < ntc) mma_tf32(tc[mt][nt], ahi[mt], blo[nt][0], blo[nt][1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          if (nt < ntc) mma_tf32(tc[mt][nt], ahi[mt], bhi[nt][0], bhi[nt][1]);
    }
    // the chunk's sums leave the tensor cores' accumulators for fp32 sums
    // rounded to nearest: the tensor cores' adds round toward zero, and
    // over the thousands of steps of a long band into a large sum they
    // drift
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[mt][nt][i] += tc[mt][nt][i];
          tc[mt][nt][i] = 0.f;
        }
  }
  cp_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // add the k groups' tiles: groups 1..3 park theirs in the ring,
  // red[group - 1][row group][element][lane]
  float* red = smem;
  const int rg = warp & 1;
  if (kg > 0) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          red[(((kg - 1) * 2 + rg) * 32 + (mt * 4 + nt) * 4 + i) * 32 + lane] = acc[mt][nt][i];
  }
  __syncthreads();
  if (kg == 0) {
    const int row_lim = min(TR, segs.rows[s] - b * TR);  // valid tile rows
    float* ob = out + (static_cast<size_t>(segs.row0[s]) + static_cast<size_t>(b) * TR) * C;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float sum = acc[mt][nt][i];
#pragma unroll
          for (int g = 0; g < KG - 1; ++g)
            sum += red[((g * 2 + rg) * 32 + (mt * 4 + nt) * 4 + i) * 32 + lane];
          const int r = r0 + wr + 16 * mt + gid + 8 * (i >> 1);
          const int c = c0 + 8 * nt + 2 * tig + (i & 1);
          if (r < row_lim && c < C) ob[static_cast<size_t>(r) * C + c] = sum;
        }
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
