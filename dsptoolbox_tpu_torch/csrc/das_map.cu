// Fused delay-and-sum map for Hopper (sm_90a): steering build + quadratic
// form in one kernel.
//
//   map[g, f] = Re(h^H C_f h),   h[m] = amp[m, g] * exp(-i k_f diff[m, g])
//
// Replaces the Pallas kernel das_map_fused / _das_kernel
// (dsptoolbox_tpu/ops/pallas_das.py); ops/cuda_das.py says how it differs
// from it.
//
// Layout: amp, diff (M, G) f32 row-major; k (F,) f32; cre, cim (F, M, M)
// f32 row-major, C[f][l][m]; out (G, F) f32. C is not assumed Hermitian.
//
// The fold. Re(h^H C h) = h^H C_H h with C_H = (C + C^H)/2 for any C, so
//   q = sum_l Re(C[l][l]) |h_l|^2 + sum_{l<m} Re(conj(h_l) D[l][m] h_m),
//   D[l][m] = C[l][m] + conj(C[m][l]),
// 2·M² + 2·M FMAs a (point, bin) over the upper triangle instead of 4·M².
//
// One block per (bin f, run of tiles of GT = 32·P grid points), 8 warps.
// Mics are taken in tiles of R (8, 16, 32 or 64, the smallest that holds
// M; 32 for M > 64); the block visits the tile pairs (L, K), L <= K, in
// order. For each pair it stages C_f[L, K] (and C_f[K, L] off the
// diagonal) with cp.async along C's rows (16 bytes where M % 4 == 0, else
// 4), padded to rows of R + 4 floats, and folds them in shared memory into
// D^T[m][l] (on the diagonal tile: D above it, Re C[l][l] on it, zeros
// below). The first pair's copies are issued before the steering build
// (exact sincosf; h kept as (re, im) pairs), and for M > 64 the next
// pair's copies are issued before the current pair's product, into a
// second buffer. The steering of all the block's mics stays resident in
// shared memory while the padded M is at most 256 (RESIDENT_MAX); beyond
// that the row and column tiles' steering is rebuilt for every pair. With
// one mic tile a block takes several point tiles of its bin where the grid
// keeps TARGET_BLOCKS blocks (the sweep: 3), D_f folded once for them.
//
// The split. A tile's work is a list of steps (row block b of 8 rows,
// column c), b = 0.., c from 8·b (diagonal tile) or 0 to R - 1; each warp
// takes an equal run of it (warp u: steps [u·S/8, (u+1)·S/8)), and its
// lane holds P grid points. Per step a thread loads the 8 rows' D^T[c] as
// four broadcast 128-bit loads and h_c of its points in one load, and does
// 32·P FMAs into t_l = sum_c D[l][c] h_c (8 complex rows in registers); at
// the end of a row block's run it adds Re(conj(h_l) t_l) to its sum. The
// warps' sums are added in a fixed order at the end: no atomics, so two
// launches give bit-identical maps. P = 2 (64 points a tile) only where
// the grid has at least 1024 tiles of 64 points at M <= 64 (the 513-bin
// sweep); at the DAS path's 10-30 bins P = 1 gives 290-870 blocks of 8
// warps, at least two blocks (16 warps) an SM at 10 bins.
//
// What bounds it (tools/das_phases.py, NVIDIA H100 80GB HBM3, 700.00 W):
// at 10 bins, 64 mics, 900 points it takes 14.9 µs a launch against a
// 2.2 µs bound: the product 6.2, the loads of C, amp and diff with the
// sums 4.3, the fold 2.1, sincosf 0.8, the launch 1.5. Every block reads
// its bin's C_f and its points' amp and diff from L2, and the few blocks
// start in step, so the loads and the barriers between the phases are
// latency the card cannot hide. At 30 bins: 29.0 µs (bound
// 6.7), the loads 10.3 of it; at the 513-bin sweep 317 µs (bound 115),
// the product 209 (about 60 % of the FFMA rate, the diagonal tiles'
// zeros counted), the loads 65, sincosf 34.
//
// fp32 FFMA throughout: no tensor cores, no TF32. The shared-memory opt-in
// is set once per template instance and device.

#include <climits>
#include <cstddef>
#include <cuda_runtime.h>

// DSPTB_DAS_SKIP, 0 in the library: phases left out, to time the others
// (tools/das_phases.py): 1 the product, 2 the fold, 4 sincosf (cos and sin
// of x taken as 1 - x and x), 8 everything (the launch alone)
#ifndef DSPTB_DAS_SKIP
#define DSPTB_DAS_SKIP 0
#endif

namespace {

constexpr int NU = 8;                 // warps a block, each a run of steps
constexpr int NT = NU * 32;           // threads a block
constexpr int RB = 8;                 // rows of a register block
constexpr int MULTI_R = 32;           // mic tile for M > 64
constexpr int RESIDENT_MAX = 256;     // padded M up to which h stays resident
constexpr int P2_MIN_BLOCKS = 1024;   // blocks of 64 points for P = 2
constexpr int TARGET_BLOCKS = 2048;   // fewest blocks of several point tiles
constexpr int MAX_DEV = 64;

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

// shared-memory floats of a block: the warps' sums, h (re, im) for
// h_rows mics, and n_buf buffers of tiles_per_pair tiles (re, im)
template <int R, int P>
__host__ __device__ constexpr size_t smem_floats(int h_rows, int n_buf, int tiles_per_pair) {
  return static_cast<size_t>(NU) * 32 * P + 2 * static_cast<size_t>(h_rows) * 32 * P +
         static_cast<size_t>(n_buf) * tiles_per_pair * 2 * R * (R + 4);
}

// the most shared memory an instance can take: R = 32 also runs M > 64
template <int R, int P>
constexpr size_t max_smem_bytes() {
  return sizeof(float) * (R == MULTI_R ? smem_floats<R, P>(RESIDENT_MAX, 2, 2)
                                       : smem_floats<R, P>(R, 1, 1));
}

// C_f[r0 : r0 + R, c0 : c0 + R] into t_re / t_im (rows of R + 4 floats),
// zero past M; consecutive threads copy consecutive addresses of a row
template <int R>
__device__ __forceinline__ void stage_tile(float* t_re, float* t_im,
                                           const float* __restrict__ cre_f,
                                           const float* __restrict__ cim_f, int r0,
                                           int c0, int M, bool vec, int tid) {
  constexpr int S = R + 4;
  if (vec) {
    constexpr int CPR = R / 4;  // 16-byte chunks a row
    for (int idx = tid; idx < R * CPR; idx += NT) {
      const int r = idx / CPR;
      const int ch = idx - r * CPR;
      const int gr = r0 + r;
      const int gc = c0 + 4 * ch;
      const bool ok = gr < M && gc < M;  // M % 4 == 0: a chunk is in or out
      const size_t off = ok ? static_cast<size_t>(gr) * M + gc : 0;
      cp16(t_re + r * S + 4 * ch, cre_f + off, ok);
      cp16(t_im + r * S + 4 * ch, cim_f + off, ok);
    }
  } else {
    for (int idx = tid; idx < R * R; idx += NT) {
      const int r = idx / R;
      const int c = idx - r * R;
      const int gr = r0 + r;
      const int gc = c0 + c;
      const bool ok = gr < M && gc < M;
      const size_t off = ok ? static_cast<size_t>(gr) * M + gc : 0;
      cp4(t_re + r * S + c, cre_f + off, ok);
      cp4(t_im + r * S + c, cim_f + off, ok);
    }
  }
}

// h for mics [m0, m0 + nm) of the block's points [gbase, gbase + GT) into
// h ([nm][GT] of (re, im)); zero past M and G. A thread loads its next
// HB elements' amp and diff before the first sincosf, so their latencies
// overlap.
template <int GT>
__device__ __forceinline__ void build_steering(
    float2* __restrict__ h, const float* __restrict__ amp,
    const float* __restrict__ diff, float kf, int m0, int nm, int M, int G, int gbase,
    int tid) {
  constexpr int HB = 8;
  for (int base = tid; base < nm * GT; base += HB * NT) {
    float a[HB], x[HB];
#pragma unroll
    for (int u = 0; u < HB; ++u) {
      const int idx = base + u * NT;
      const int r = idx / GT;
      const int m = m0 + r;
      const int g = gbase + (idx - r * GT);
      a[u] = 0.f;
      x[u] = 0.f;
      if (idx < nm * GT && m < M && g < G) {
        const size_t i = static_cast<size_t>(m) * G + g;
        a[u] = amp[i];
        x[u] = kf * diff[i];
      }
    }
#pragma unroll
    for (int u = 0; u < HB; ++u) {
      const int idx = base + u * NT;
      if (idx < nm * GT) {
        float s, c;
        if (DSPTB_DAS_SKIP & 4) {
          s = x[u];
          c = 1.f - x[u];
        } else {
          sincosf(x[u], &s, &c);
        }
        h[idx] = make_float2(a[u] * c, -(a[u] * s));
      }
    }
  }
}

// fold a staged pair in place into D^T[m][l]: on the diagonal tile t0
// (slot (m, l) = D[l][m] for l < m, (Re C[l][l], 0) on the diagonal, zero
// for l > m); off it into t1 (t0 = C[L, K], t1 = C[K, L]). On the diagonal
// each thread takes pairs (l, m), l <= m: (a, b) of the top half's rows is
// the pair itself when b > a, else (R-1-a, R-1-b) of the bottom half.
template <int R>
__device__ __forceinline__ void fold(float* t0_re, float* t0_im, float* t1_re, float* t1_im,
                                     bool diag, int tid) {
  constexpr int S = R + 4;
  if (diag) {
    for (int idx = tid; idx < R * R / 2; idx += NT) {
      const int a = idx / R;
      const int b = idx - a * R;
      if (b == a) t0_im[a * S + a] = 0.f;
      const int i = b > a ? a : R - 1 - a;  // l
      const int j = b > a ? b : R - 1 - b;  // m >= l
      if (i == j) {
        t0_im[i * S + i] = 0.f;
      } else {  // one thread a pair: no race
        const float a_re = t0_re[i * S + j], a_im = t0_im[i * S + j];
        const float b_re = t0_re[j * S + i], b_im = t0_im[j * S + i];
        t0_re[j * S + i] = a_re + b_re;
        t0_im[j * S + i] = a_im - b_im;
        t0_re[i * S + j] = 0.f;
        t0_im[i * S + j] = 0.f;
      }
    }
  } else {
    for (int idx = tid; idx < R * R; idx += NT) {
      const int j = idx / R;  // m, the slot's row
      const int i = idx - j * R;  // l
      t1_re[j * S + i] = t0_re[i * S + j] + t1_re[j * S + i];
      t1_im[j * S + i] = t0_im[i * S + j] - t1_im[j * S + i];
    }
  }
}

// h of the thread's P points: one 8- or 16-byte load
template <int P>
__device__ __forceinline__ void load_points(const float2* p, float (&re)[P], float (&im)[P]) {
  if constexpr (P == 2) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    re[0] = x.x;
    im[0] = x.y;
    re[1] = x.z;
    im[1] = x.w;
  } else {
    const float2 x = *p;
    re[0] = x.x;
    im[0] = x.y;
  }
}

// warp `unit`'s run of the tile's steps: q[p] += Re(conj(h_l) D[l][c] h_c)
// over its (row block, column) steps; dt = D^T (rows of R + 4, the
// imaginary part R·(R + 4) floats after the real), hr / hc the steering of
// the row and column tiles' mics ([R][GT]), gl the thread's first point
template <int R, int P>
__device__ __forceinline__ void product(float (&q)[P], const float* dt, const float2* hr,
                                        const float2* hc, bool diag,
                                        int unit, int gl) {
  constexpr int GT = 32 * P;
  constexpr int S = R + 4;
  constexpr int TILE = R * S;
  constexpr int NB = R / RB;
  const int steps = diag ? 4 * NB * (NB + 1) : RB * NB * NB;
  const int s0 = unit * steps / NU;
  int rem = (unit + 1) * steps / NU - s0;
  // the run's first step: row block b, column c
  int b = 0, off = s0;
  while (off >= R - (diag ? RB * b : 0)) {
    off -= R - (diag ? RB * b : 0);
    ++b;
  }
  int c = (diag ? RB * b : 0) + off;
  while (rem > 0) {
    const int n = min(rem, R - c);
    float tr[P][RB], ti[P][RB];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        tr[p][r] = 0.f;
        ti[p][r] = 0.f;
      }
    // D^T[c][8b ..] and h_c of the thread's points, one row further a step
    const float* dr = dt + c * S + b * RB;  // its imaginary part TILE floats on
    const float2* hcp = hc + c * GT + gl;
#pragma unroll 2
    for (int j = 0; j < n; ++j, dr += S, hcp += GT) {
      const float4 a0 = *reinterpret_cast<const float4*>(dr);
      const float4 a1 = *reinterpret_cast<const float4*>(dr + 4);
      const float4 e0 = *reinterpret_cast<const float4*>(dr + TILE);
      const float4 e1 = *reinterpret_cast<const float4*>(dr + TILE + 4);
      const float cr[RB] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float ci[RB] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
      float hr[P], hi[P];
      load_points<P>(hcp, hr, hi);
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          tr[p][r] = fmaf(cr[r], hr[p], tr[p][r]);
          tr[p][r] = fmaf(-ci[r], hi[p], tr[p][r]);
          ti[p][r] = fmaf(cr[r], hi[p], ti[p][r]);
          ti[p][r] = fmaf(ci[r], hr[p], ti[p][r]);
        }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float lr[P], li[P];
      load_points<P>(hr + (b * RB + r) * GT + gl, lr, li);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        q[p] = fmaf(lr[p], tr[p][r], q[p]);
        q[p] = fmaf(li[p], ti[p][r], q[p]);
      }
    }
    rem -= n;
    ++b;
    c = diag ? RB * b : 0;
  }
}

template <int R, int P>
__global__ void __launch_bounds__(NT, P == 1 ? 4 : 3) das_map_kernel(
    const float* __restrict__ amp, const float* __restrict__ diff,
    const float* __restrict__ kvec, const float* __restrict__ cre,
    const float* __restrict__ cim, float* __restrict__ out, int M, int G, int F,
    int n_gtiles, int per_block) {
  constexpr int GT = 32 * P;
  constexpr int TILE = R * (R + 4);  // floats of one part (re or im) of a tile
  const int n = (M + R - 1) / R;     // mic tiles
  const int n_pairs = n * (n + 1) / 2;
  const bool resident = n * R <= RESIDENT_MAX;
  const int h_rows = resident ? n * R : 2 * R;
  const int tiles = n > 1 ? 2 : 1;  // tiles a pair
  const int buf_floats = tiles * 2 * TILE;

  extern __shared__ float4 smem4[];
  float* part = reinterpret_cast<float*>(smem4);  // [NU][GT], the warps' sums
  float2* h = reinterpret_cast<float2*>(part + NU * GT);    // [h_rows][GT]
  float* stage = reinterpret_cast<float*>(h + h_rows * GT);  // (n > 1 ? 2 : 1) buffers

  if (DSPTB_DAS_SKIP & 8) return;
  const int tid = threadIdx.x;
  const int unit = tid / 32;
  const int gl = (tid % 32) * P;
  // the block's bin and its run of point tiles [gt0, gt1)
  const int per_bin = (n_gtiles + per_block - 1) / per_block;
  const int f = blockIdx.x / per_bin;
  const int gt0 = (blockIdx.x - f * per_bin) * per_block;
  const int gt1 = min(gt0 + per_block, n_gtiles);
  const float kf = kvec[f];
  const float* cre_f = cre + static_cast<size_t>(f) * M * M;
  const float* cim_f = cim + static_cast<size_t>(f) * M * M;
  const bool vec = M % 4 == 0;

  auto issue = [&](int lt, int kt, float* buf) {
    stage_tile<R>(buf, buf + TILE, cre_f, cim_f, lt * R, kt * R, M, vec, tid);
    if (lt != kt) {
      stage_tile<R>(buf + 2 * TILE, buf + 3 * TILE, cre_f, cim_f, kt * R, lt * R, M, vec, tid);
    }
    cp_commit();
  };

  // the first pair's copies fly while the steering is built
  issue(0, 0, stage);
  for (int gt = gt0; gt < gt1; ++gt) {
    const int gbase = gt * GT;
    if (resident) build_steering<GT>(h, amp, diff, kf, 0, n * R, M, G, gbase, tid);
    float q[P];
#pragma unroll
    for (int p = 0; p < P; ++p) q[p] = 0.f;
    if (gt == gt0) {
      int lt = 0, kt = 0;
      for (int pr = 0; pr < n_pairs; ++pr) {
        float* buf = stage + (pr & 1) * buf_floats;
        int nlt = lt, nkt = kt + 1;
        if (nkt == n) nkt = ++nlt;
        const bool more = pr + 1 < n_pairs;
        // the next pair's copies fly behind this pair's product (the buffer
        // they fill was last read before the previous iteration's barrier)
        if (more) issue(nlt, nkt, stage + ((pr + 1) & 1) * buf_floats);
        const float2* hr = h + lt * R * GT;  // the row tile's steering
        const float2* hc = h + kt * R * GT;  // the column tile's
        if (!resident) {
          build_steering<GT>(h, amp, diff, kf, lt * R, R, M, G, gbase, tid);
          hr = h;
          hc = h;
          if (kt != lt) {
            hc = h + R * GT;
            build_steering<GT>(h + R * GT, amp, diff, kf, kt * R, R, M, G, gbase, tid);
          }
        }
        if (more) {
          cp_wait<1>();
        } else {
          cp_wait<0>();
        }
        __syncthreads();
        const bool diag = lt == kt;
        if (!(DSPTB_DAS_SKIP & 2)) {
          fold<R>(buf, buf + TILE, buf + 2 * TILE, buf + 3 * TILE, diag, tid);
        }
        __syncthreads();
        const float* dt = diag ? buf : buf + 2 * TILE;
        if (!(DSPTB_DAS_SKIP & 1)) product<R, P>(q, dt, hr, hc, diag, unit, gl);
        __syncthreads();  // every warp is done with this buffer and h tiles
        lt = nlt;
        kt = nkt;
      }
    } else {
      // a later point tile (one mic tile only): D_f stays folded in the
      // buffer, only the steering is new
      __syncthreads();
      if (!(DSPTB_DAS_SKIP & 1)) product<R, P>(q, stage, h, h, true, unit, gl);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) part[unit * GT + gl + p] = q[p];
    __syncthreads();
    if (unit == 0) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int g = gbase + gl + p;
        if (g < G) {
          float sum = part[gl + p];
#pragma unroll
          for (int u = 1; u < NU; ++u) sum += part[u * GT + gl + p];
          out[static_cast<size_t>(g) * F + f] = sum;
        }
      }
    }
    __syncthreads();  // part and h are free for the next point tile
  }
}

// the shared-memory opt-in, once per template instance and device (a
// repeat from a racing thread sets the same value)
template <int R, int P>
cudaError_t opt_in() {
  static bool opted_in[MAX_DEV] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEV || !opted_in[dev]) {
    err = cudaFuncSetAttribute(das_map_kernel<R, P>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(max_smem_bytes<R, P>()));
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < MAX_DEV) opted_in[dev] = true;
  }
  return cudaSuccess;
}

struct Plan {
  int R, P, n, resident, blocks, n_gtiles, per_block;
  size_t bytes;
};

template <int R, int P>
Plan plan_of(int M, int G, int F) {
  constexpr int GT = 32 * P;
  Plan pl;
  pl.R = R;
  pl.P = P;
  pl.n = (M + R - 1) / R;
  pl.resident = pl.n * R <= RESIDENT_MAX;
  const int tiles = pl.n > 1 ? 2 : 1;
  pl.bytes = sizeof(float) * smem_floats<R, P>(pl.resident ? pl.n * R : 2 * R, tiles, tiles);
  pl.n_gtiles = (G + GT - 1) / GT;
  // with one mic tile a block takes several point tiles of its bin (C_f
  // staged and folded once) where the grid keeps TARGET_BLOCKS blocks
  const long long tiles_all = static_cast<long long>(pl.n_gtiles) * F;
  pl.per_block = 1;
  if (pl.n == 1) {
    const long long t = tiles_all / TARGET_BLOCKS;
    pl.per_block = static_cast<int>(t < 1 ? 1 : (t > pl.n_gtiles ? pl.n_gtiles : t));
  }
  const long long blocks =
      static_cast<long long>((pl.n_gtiles + pl.per_block - 1) / pl.per_block) * F;
  pl.blocks = blocks > INT_MAX ? -1 : static_cast<int>(blocks);
  return pl;
}

template <int R, int P>
int launch(const float* amp, const float* diff, const float* k, const float* cre,
           const float* cim, float* out, int M, int G, int F, cudaStream_t stream) {
  const Plan pl = plan_of<R, P>(M, G, F);
  if (pl.blocks < 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = opt_in<R, P>();
  if (err != cudaSuccess) return static_cast<int>(err);
  das_map_kernel<R, P><<<pl.blocks, NT, pl.bytes, stream>>>(amp, diff, k, cre, cim, out, M, G,
                                                             F, pl.n_gtiles, pl.per_block);
  return static_cast<int>(cudaGetLastError());
}

// the instance for (M, G, F): 0 = (8, 1), 1 = (16, 1), 2 = (32, 1),
// 3 = (64, 1), 4 = (64, 2)
int instance(int M, int G, int F) {
  if (M <= 8) return 0;
  if (M <= 16) return 1;
  if (M <= 32 || M > 64) return 2;
  const long long blocks64 = static_cast<long long>((G + 63) / 64) * F;
  return blocks64 >= P2_MIN_BLOCKS ? 4 : 3;
}

template <int R, int P>
int design(int M, int G, int F, int* info) {
  const Plan pl = plan_of<R, P>(M, G, F);
  cudaError_t err = opt_in<R, P>();
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, das_map_kernel<R, P>, NT,
                                                      pl.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[11] = {pl.R,         pl.P,       32 * P, NU, pl.n, pl.n * (pl.n + 1) / 2,
                        pl.per_block, pl.resident, static_cast<int>(pl.bytes), pl.blocks,
                        per_sm};
  for (int i = 0; i < 11; ++i) info[i] = vals[i];
  return 0;
}

}  // namespace

extern "C" int dsptb_das_map_f32(const float* amp, const float* diff,
                                 const float* k, const float* cre,
                                 const float* cim, float* out, int M, int G,
                                 int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (instance(M, G, F)) {
    case 0: return launch<8, 1>(amp, diff, k, cre, cim, out, M, G, F, s);
    case 1: return launch<16, 1>(amp, diff, k, cre, cim, out, M, G, F, s);
    case 2: return launch<32, 1>(amp, diff, k, cre, cim, out, M, G, F, s);
    case 3: return launch<64, 1>(amp, diff, k, cre, cim, out, M, G, F, s);
    default: return launch<64, 2>(amp, diff, k, cre, cim, out, M, G, F, s);
  }
}

// The kernel's plan for (M, G, F) on the current device, into info[11]:
// mic tile R, points a thread P, points a tile, warps a block, mic tiles,
// tile pairs, point tiles a block, steering resident (1/0), shared bytes a
// block, blocks, blocks resident an SM (the occupancy calculator's).
extern "C" int dsptb_das_map_design(int M, int G, int F, int* info) {
  switch (instance(M, G, F)) {
    case 0: return design<8, 1>(M, G, F, info);
    case 1: return design<16, 1>(M, G, F, info);
    case 2: return design<32, 1>(M, G, F, info);
    case 3: return design<64, 1>(M, G, F, info);
    default: return design<64, 2>(M, G, F, info);
  }
}
