// Zero-state IIR filter bank: B same-order SOS cascades on one shared input.
// Replaces the Pallas kernel `sosfilt_bank_pallas` / `_bank_kernel_real` /
// `_bank_kernel_cplx` (dsptoolbox_tpu/ops/pallas_iir_bank.py).
//
// The input x (R rows, row stride ldx) is real and shared by every band.
// Per band b and L-sample block k of row r, in the real form of the
// operators (a complex cascade with N complex states runs as Ns = 2N real
// state lanes [Re s, Im s] and P = 2 output planes, a real one as Ns = N
// lanes and P = 1 plane):
//     y_p[b,k] = x_k h_{p,b} + s[b,k] G_{p,b}        (h: in-block impulse response)
//     s[b,k+1] = s[b,k] A_b + x_k M_b,  s[b,0] = 0,   s[b,K] is returned as zf.
//
// Precision: x_k h (the lower-triangular Toeplitz product of the in-block
// impulse response) in fp32 accuracy: on the tensor cores as three TF32
// products of a hi/lo split (x_lo h_hi + x_hi h_lo + x_hi h_hi, each part
// rounded with cvt.rna; never a single TF32 product), or in fp32 FFMA. The
// whole state path (v = x M, the chain, s G) runs in fp64: for low-frequency
// cascades (the 40-50 Hz third-octave bands) G reaches 1e4-1e5 against O(1)
// outputs, and fp32 rounding of the state is amplified by that cancellation.
//
// Bound on the H100: y dominates the bytes (16 complex bands write 32 floats
// per input float), and the work is ~L/2 fp32 FMAs per output sample for
// x h plus ~Ns fp64 FMAs per output sample for s G and per band-lane for
// x M. The TPU kernel concatenated the bands' Toeplitz matrices into dense
// MXU products and carried the state across a sequential grid in VMEM;
// here, in three passes (five launches):
//   1. inject: parallel over tiles of 64 rows (r,k): v = x M for every band,
//              x's tile staged once in shared memory, M streamed through it
//              in chunks of 64 band-lanes; v is stored as (rows, B*Ns);
//   2. chain:  s_{k+1} = s_k A_b + v_k per (band, row), one warp per walk,
//              cut into chunks of ~sqrt(K/2) steps walked in parallel with
//              one serial carry over the chunk starts (as in iir_lead.cu,
//              with A per band and the v rows strided by B*Ns); v_k is
//              overwritten with the state entering block k;
//   3. out:    y = x h + s G for every band and plane, y stored once.
//      L <= 128 (the filter-bank path's blocks) takes the tensor cores
//      (`bank_out_mma_kernel`). It replaces an FFMA pass whose x h alone
//      needed ~1.7 ms per config-3 bank at the FFMA peak, with s G as dense
//      fp64 on the CUDA cores, and whose inner loop was held by shared-memory
//      loads as much as by the FMAs (6.99 / 6.53 ms on the H100). A warp
//      owns 16 rows and every column: x h runs as m16n8k8 TF32 mma.sync in
//      three products, h held in registers as its 16 distinct 8x8 Toeplitz
//      tiles (tile d = column tile - l tile; B[k][n] = h[8d + n - k], zero
//      below 0), the tiles above the diagonal skipped; its fp32 sums,
//      converted to double in place, are the C operand of m16n8k4 fp64
//      mma.sync for s G (the same lane layout; the older m8n8k4 shape runs
//      at half the fp64 tensor rate on the H100). What bounds it then: the
//      tensor pipe (mma.sync TF32 peaks near 300 TFLOP/s on the H100, well
//      below the 495 of wgmma) and the y bytes; G and h arrive by cp.async a
//      plane ahead, and y leaves straight from the accumulators. Longer
//      blocks keep the FFMA pass (`bank_out_kernel`, x streamed in chunks
//      of 128 l).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;        // rows (r,k) per block in passes 1 and 3
constexpr int kLChunk = 128;         // l per shared-memory chunk of x
constexpr int kXS = kTileRows + 4;   // row stride of the transposed x tile xt[l][row]
constexpr int kLaneChunk = 64;       // band-lanes (b,n) per step of pass 1
constexpr int kColTile = 128;        // columns of y per block in pass 3
constexpr int kStepAhead = 16;       // v_k loaded ahead in pass 2
constexpr int kMaxState = 32;        // Ns <= one warp
constexpr int kYS = kColTile + 1;    // row stride of pass 3's output tile

// floats of pass 3's h window: lmax + 135 <= L + 135, rounded up to 4
__host__ __device__ constexpr int hw_alloc(int L) { return (L + 139) & ~3; }

// rowoff[r] <- offset of row row0 + r in x: (row / K) * ldx + (row % K) * L
// (-1 past the last row); with yoff, the same row's offset in one y plane.
__device__ __forceinline__ void row_offsets(long long* rowoff, long long* yoff, long long row0,
                                            long long RK, long long K, int L, long long ldx,
                                            long long ldy) {
    for (int r = threadIdx.x; r < kTileRows; r += blockDim.x) {
        const long long row = row0 + r;
        const long long q = row / K;
        const long long k = row - q * K;
        rowoff[r] = row < RK ? q * ldx + k * L : -1;
        if (yoff != nullptr) yoff[r] = row < RK ? q * ldy + k * L : -1;
    }
}

// xt[l][r] <- x[row0 + r, lc + l] for l < kc, zero for rows past the end
// and for l from kc up to the next multiple of 8
__device__ __forceinline__ void load_x_tile(const float* __restrict__ x, float* xt,
                                            const long long* rowoff, int lc, int kc) {
    const int kp = (kc + 7) & ~7;
    for (int i = threadIdx.x; i < kTileRows * kp; i += blockDim.x) {
        const int r = i / kp;
        const int l = i - r * kp;
        const long long off = rowoff[r];
        xt[l * kXS + r] = (off >= 0 && l < kc) ? x[off + lc + l] : 0.0f;
    }
}

// Pass 1. vs[row, j] = sum_l x[row, l] M[l, j], j = b*Ns + n < BN, in fp64.
// Thread (tg, lg) owns rows 4tg..4tg+3 and lanes 4lg..4lg+3 of a 64-lane
// chunk: per l one float4 of x (broadcast to the 16 threads of a row group)
// and two double2 of M for 16 fp64 FMAs. When one l-chunk covers L (L <=
// 128), x's tile is loaded once for all lane chunks.
__global__ void __launch_bounds__(kThreads, 2)
bank_inject_kernel(const float* __restrict__ x, const double* __restrict__ M,
                   double* __restrict__ vs, long long RK, long long K, int L, int BN,
                   long long ldx) {
    extern __shared__ double2 smem1[];
    double* Ms = reinterpret_cast<double*>(smem1);                    // (kLChunk, kLaneChunk)
    long long* rowoff = reinterpret_cast<long long*>(Ms + kLChunk * kLaneChunk);
    float* xt = reinterpret_cast<float*>(rowoff + kTileRows);          // (kLChunk, kXS)
    const int tid = threadIdx.x;
    const int tg = tid / 16;
    const int lg = tid - tg * 16;
    const long long row0 = (long long)blockIdx.x * kTileRows;
    const bool resident = L <= kLChunk;
    row_offsets(rowoff, nullptr, row0, RK, K, L, ldx, 0);

    for (int j0 = 0; j0 < BN; j0 += kLaneChunk) {
        double acc[4][4] = {};
        for (int lc = 0; lc < L; lc += kLChunk) {
            const int kc = L - lc < kLChunk ? L - lc : kLChunk;
            __syncthreads();  // the previous chunk's reads of Ms and xt are done
            if (!resident || j0 == 0) load_x_tile(x, xt, rowoff, lc, kc);
#pragma unroll 8
            for (int i = tid; i < kc * kLaneChunk; i += kThreads) {
                const int l = i / kLaneChunk;
                const int jj = i - l * kLaneChunk;
                Ms[i] = j0 + jj < BN ? M[(size_t)(lc + l) * BN + j0 + jj] : 0.0;
            }
            __syncthreads();
#pragma unroll 4
            for (int l = 0; l < kc; ++l) {
                const float4 xv = *reinterpret_cast<const float4*>(xt + l * kXS + 4 * tg);
                const double2 m01 = *reinterpret_cast<const double2*>(Ms + l * kLaneChunk + 4 * lg);
                const double2 m23 = *reinterpret_cast<const double2*>(Ms + l * kLaneChunk + 4 * lg + 2);
                const double xr[4] = {xv.x, xv.y, xv.z, xv.w};
                const double mc[4] = {m01.x, m01.y, m23.x, m23.y};
#pragma unroll
                for (int a = 0; a < 4; ++a)
#pragma unroll
                    for (int c = 0; c < 4; ++c) acc[a][c] = fma(xr[a], mc[c], acc[a][c]);
            }
        }
        // BN is even (Ns = 2 * sections or 4 * sections), so a lane pair
        // never straddles its end and the double2 stores are aligned
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            const long long row = row0 + 4 * tg + a;
            if (row >= RK) continue;
#pragma unroll
            for (int c = 0; c < 4; c += 2) {
                const int j = j0 + 4 * lg + c;
                if (j < BN)
                    *reinterpret_cast<double2*>(vs + row * BN + j) =
                        make_double2(acc[a][c], acc[a][c + 1]);
            }
        }
    }
}

// The chain kernels are templated on the state size: NN > 0 fixes Ns = NN
// at compile time (loops unrolled, no bound checks); NN == 0 reads it at
// run time (Ns <= kMaxState).
template <int NN>
__host__ __device__ constexpr int loop_bound() { return NN > 0 ? NN : kMaxState; }

// One step of the chain for the warp: lane n returns v[n] + sum_j s[j] A[j][n],
// with a[j] = A[j][lane] in registers; two partial sums halve the FMA chain.
template <int NN>
__device__ __forceinline__ double chain_step(double s, double v, const double (&a)[kMaxState],
                                             int N) {
    double acc0 = v, acc1 = 0.0;
#pragma unroll
    for (int j = 0; j < loop_bound<NN>(); j += 2) {
        if (NN == 0 && j >= N) break;
        acc0 = fma(__shfl_sync(0xffffffffu, s, j), a[j], acc0);
        if (j + 1 < (NN > 0 ? NN : N)) acc1 = fma(__shfl_sync(0xffffffffu, s, j + 1), a[j + 1], acc1);
    }
    return acc0 + acc1;
}

// Walk steps [k_begin, k_end) of one chain whose v_k sit at row[k * ld + n]
// from state s; with `store`, overwrite each v_k with the state entering
// step k. The v_k of the next kStepAhead steps are loaded before the
// current ones are used (clamped addresses, so the loads cannot be sunk
// into the steps).
template <int NN>
__device__ __forceinline__ double chain_walk(double s, double* __restrict__ row, long long ld,
                                             long long k_begin, long long k_end,
                                             const double (&a)[kMaxState], int N, bool store) {
    if (k_begin >= k_end) return s;
    const int lane = threadIdx.x & 31;
    const bool live = lane < N;
    const int ln = live ? lane : N - 1;  // idle lanes read a valid address
    const long long last = k_end - 1;
    double nxt[kStepAhead];
#pragma unroll
    for (int i = 0; i < kStepAhead; ++i) {
        const long long k = k_begin + i < last ? k_begin + i : last;
        nxt[i] = row[k * ld + ln];
    }
    for (long long k0 = k_begin; k0 < k_end; k0 += kStepAhead) {
        double cur[kStepAhead];
#pragma unroll
        for (int i = 0; i < kStepAhead; ++i) {
            cur[i] = nxt[i];
            const long long k = k0 + kStepAhead + i < last ? k0 + kStepAhead + i : last;
            nxt[i] = row[k * ld + ln];
        }
#pragma unroll
        for (int i = 0; i < kStepAhead; ++i) {
            if (k0 + i < k_end) {
                if (store && live) row[(k0 + i) * ld + lane] = s;
                s = chain_step<NN>(s, cur[i], a, N);
            }
        }
    }
    return s;
}

template <int NN>
__device__ __forceinline__ void load_column(const double* __restrict__ A, int N,
                                            double (&a)[kMaxState]) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < loop_bound<NN>(); ++j) a[j] = (lane < N && j < N) ? A[j * N + lane] : 0.0;
}

struct ChainShape {
    long long W;   // chains: B * R, chain w = b * R + r
    long long R;
    long long K;   // steps per chain
    int BN;        // row stride of vs: B * Ns
    int N;         // state lanes Ns
    int F;         // chunk length
    int nc;        // chunks: ceil(K / F)
};

// the v_k of chain w: vs[(r * K + k) * BN + b * Ns + n]
__device__ __forceinline__ double* chain_row(double* vs, const ChainShape& cs, long long w) {
    const long long b = w / cs.R;
    const long long r = w - b * cs.R;
    return vs + r * cs.K * cs.BN + b * cs.N;
}

// Pass 2a. One warp per (w, c), c < nc - 1: the end state of chunk c walked
// from zero, written to carry[w, c].
template <int NN>
__global__ void chain_local_kernel(const double* __restrict__ A, double* __restrict__ vs,
                                   double* __restrict__ carry, ChainShape cs) {
    const int lane = threadIdx.x & 31;
    const long long g = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (g >= cs.W * (cs.nc - 1)) return;
    const long long w = g / (cs.nc - 1);
    const long long c = g - w * (cs.nc - 1);
    double a[kMaxState];
    load_column<NN>(A + (w / cs.R) * cs.N * cs.N, cs.N, a);
    const double s = chain_walk<NN>(0.0, chain_row(vs, cs, w), cs.BN, c * cs.F, (c + 1) * cs.F,
                                    a, cs.N, false);
    if (lane < cs.N) carry[(w * cs.nc + c) * cs.N + lane] = s;
}

// Pass 2b. One warp per chain w: with P = A^F (lane n holding column n),
// S_0 = 0 and S_{c+1} = S_c P + w_c; carry[w, c] <- S_c.
template <int NN>
__global__ void chain_carry_kernel(const double* __restrict__ A, double* __restrict__ carry,
                                   ChainShape cs) {
    const int lane = threadIdx.x & 31;
    const long long w = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (w >= cs.W) return;
    const int N = cs.N;
    double a[kMaxState], p[kMaxState];
    load_column<NN>(A + (w / cs.R) * N * N, N, a);
#pragma unroll
    for (int i = 0; i < loop_bound<NN>(); ++i) p[i] = (i == lane && lane < N) ? 1.0 : 0.0;
    for (int t = 0; t < cs.F; ++t) {
        double q[kMaxState];
#pragma unroll
        for (int i = 0; i < loop_bound<NN>(); ++i) q[i] = 0.0;
#pragma unroll
        for (int j = 0; j < loop_bound<NN>(); ++j) {
            if (NN == 0 && j >= N) break;
#pragma unroll
            for (int i = 0; i < loop_bound<NN>(); ++i) {
                if (NN == 0 && i >= N) break;
                q[i] = fma(__shfl_sync(0xffffffffu, p[i], j), a[j], q[i]);
            }
        }
#pragma unroll
        for (int i = 0; i < loop_bound<NN>(); ++i) p[i] = q[i];
    }
    double* row = carry + w * cs.nc * N;
    const double s = chain_walk<NN>(0.0, row, N, 0, cs.nc - 1, p, N, true);
    if (lane < N) row[(long long)(cs.nc - 1) * N + lane] = s;
}

// Pass 2c. One warp per (w, c): walk chunk c from S_c = carry[w, c],
// overwriting v_k with s_k; the last chunk writes zf[w].
template <int NN>
__global__ void chain_expand_kernel(const double* __restrict__ A, const double* __restrict__ carry,
                                    double* __restrict__ vs, double* __restrict__ zf,
                                    ChainShape cs) {
    const int lane = threadIdx.x & 31;
    const long long g = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (g >= cs.W * cs.nc) return;
    const long long w = g / cs.nc;
    const long long c = g - w * cs.nc;
    double a[kMaxState];
    load_column<NN>(A + (w / cs.R) * cs.N * cs.N, cs.N, a);
    const long long k_end = (c + 1) * cs.F < cs.K ? (c + 1) * cs.F : cs.K;
    const double s0 = lane < cs.N ? carry[(w * cs.nc + c) * cs.N + lane] : 0.0;
    const double s = chain_walk<NN>(s0, chain_row(vs, cs, w), cs.BN, c * cs.F, k_end, a, cs.N,
                                    true);
    if (c == cs.nc - 1 && lane < cs.N) zf[w * cs.N + lane] = s;
}

template <int NN>
cudaError_t launch_chain(const double* A, double* vs, double* carry, double* zf,
                         const ChainShape& cs, cudaStream_t st) {
    constexpr int kWarps = 4;  // warps per block
    auto blocks = [](long long warps) { return (unsigned)((warps + kWarps - 1) / kWarps); };
    cudaError_t err;
    if (cs.nc > 1) {
        chain_local_kernel<NN><<<blocks(cs.W * (cs.nc - 1)), 32 * kWarps, 0, st>>>(A, vs, carry, cs);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    chain_carry_kernel<NN><<<blocks(cs.W), 32 * kWarps, 0, st>>>(A, carry, cs);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    chain_expand_kernel<NN><<<blocks(cs.W * cs.nc), 32 * kWarps, 0, st>>>(A, carry, vs, zf, cs);
    return cudaGetLastError();
}

// Pass 3 on the CUDA cores, for L > 128. Block (tile, ct) writes columns
// [c0, c0 + 128) of 64 rows (r,k) of every band and plane. The columns
// form 16 groups of 8; warp w owns groups w and 15 - w (so that every warp
// has the same share of the Toeplitz triangle: group g needs l < c0 + 8g +
// 8 only), lane i rows i and i + 32. Per 8 l a group reads 15 values of the
// band's h window (broadcast to the warp: hv[t] = h[col0 - l0 - 7 + t])
// and, per row, the 8 x values of its own row (consecutive across the warp)
// for 128 FMAs; the triangle's partial blocks are covered by the window's
// zeros. The fp64 epilogue adds s G with s stored column-major (consecutive
// rows across the warp) and G's values broadcast, and the tile is stored
// through shared memory. x's tile is streamed in chunks of 128 l for each
// band and plane.
__global__ void __launch_bounds__(kThreads, 2)
bank_out_kernel(const float* __restrict__ x, const float* __restrict__ h,
                const double* __restrict__ G, const double* __restrict__ vs,
                float* __restrict__ y, int B, long long R, long long K, int L, int N, int P,
                long long ldx, long long ldy) {
    extern __shared__ double2 smem3[];
    double* sT = reinterpret_cast<double*>(smem3);            // (N, kTileRows)
    double* Gs = sT + kTileRows * N;                          // (N, kColTile)
    long long* rowoff = reinterpret_cast<long long*>(Gs + (size_t)N * kColTile);
    long long* yoff = rowoff + kTileRows;
    float* xt = reinterpret_cast<float*>(yoff + kTileRows);   // (kLChunk, kXS)
    float* hw = xt + kLChunk * kXS;                           // (lmax + 135)
    float* yt = hw + hw_alloc(L);                             // (kTileRows, kYS)
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int groups[2] = {warp, 15 - warp};
    const long long RK = R * K;
    const long long BN = (long long)B * N;
    const long long row0 = (long long)blockIdx.x * kTileRows;
    const int c0 = blockIdx.y * kColTile;
    const int lmax = L < c0 + kColTile ? L : c0 + kColTile;  // only l <= column matter
    row_offsets(rowoff, yoff, row0, RK, K, L, ldx, ldy);

    for (int b = 0; b < B; ++b) {
        __syncthreads();  // rowoff is written; the previous band's reads of sT are done
        for (int i = tid; i < kTileRows * N; i += kThreads) {
            const int r = i / N;
            const int n = i - r * N;
            const long long row = row0 + r;
            sT[n * kTileRows + r] = row < RK ? vs[row * BN + (long long)b * N + n] : 0.0;
        }
        for (int p = 0; p < P; ++p) {
            const long long band = (long long)p * B + b;
            __syncthreads();  // the previous plane's reads of Gs and hw are done
#pragma unroll 4
            for (int i = tid; i < N * kColTile; i += kThreads) {
                const int n = i / kColTile;
                const int m = i - n * kColTile;
                Gs[i] = c0 + m < L ? G[(band * N + n) * L + c0 + m] : 0.0;
            }
            // hw[u] = h[c0 - lmax - 7 + u], zero outside [0, L)
            for (int u = tid; u < lmax + 135; u += kThreads) {
                const int idx = c0 - lmax - 7 + u;
                hw[u] = (idx >= 0 && idx < L) ? h[band * L + idx] : 0.0f;
            }
            __syncthreads();

            float acc[2][2][8] = {};  // [group][row][column]
            for (int lc = 0; lc < lmax; lc += kLChunk) {
                const int kc = lmax - lc < kLChunk ? lmax - lc : kLChunk;
                __syncthreads();
                load_x_tile(x, xt, rowoff, lc, kc);
                __syncthreads();
                // group g needs l < c0 + 8g + 8: the second group's range
                // holds the first's
                const int l_end1 = c0 + 8 * groups[1] + 8 - lc;
                const int n8 = ((l_end1 < kc ? l_end1 : kc) + 7) / 8;
                for (int i8 = 0; i8 < n8; ++i8) {
                    const int l0 = 8 * i8;  // within the chunk; rows past kc are zero
                    float xr[2][8];
#pragma unroll
                    for (int i = 0; i < 8; ++i) {
                        xr[0][i] = xt[(l0 + i) * kXS + lane];
                        xr[1][i] = xt[(l0 + i) * kXS + lane + 32];
                    }
#pragma unroll
                    for (int gi = 1; gi >= 0; --gi) {
                        if (lc + l0 >= c0 + 8 * groups[gi] + 8) continue;  // warp-uniform
                        const float* hb = hw + lmax + 8 * groups[gi] - (lc + l0);
                        float hv[15];
#pragma unroll
                        for (int t = 0; t < 15; ++t) hv[t] = hb[t];
#pragma unroll
                        for (int i = 0; i < 8; ++i)
#pragma unroll
                            for (int rr = 0; rr < 2; ++rr)
#pragma unroll
                                for (int j = 0; j < 8; ++j)
                                    acc[gi][rr][j] = fmaf(xr[rr][i], hv[j - i + 7], acc[gi][rr][j]);
                    }
                }
            }

#pragma unroll
            for (int gi = 0; gi < 2; ++gi) {
                const int m0 = 8 * groups[gi];
                double d[2][8];
#pragma unroll
                for (int rr = 0; rr < 2; ++rr)
#pragma unroll
                    for (int j = 0; j < 8; ++j) d[rr][j] = (double)acc[gi][rr][j];
                for (int n = 0; n < N; ++n) {
                    const double s0 = sT[n * kTileRows + lane];
                    const double s1 = sT[n * kTileRows + lane + 32];
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        const double g = Gs[n * kColTile + m0 + j];
                        d[0][j] = fma(s0, g, d[0][j]);
                        d[1][j] = fma(s1, g, d[1][j]);
                    }
                }
#pragma unroll
                for (int rr = 0; rr < 2; ++rr)
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        yt[(lane + 32 * rr) * kYS + m0 + j] = (float)d[rr][j];
            }
            __syncthreads();
            // the tile's rows leave through shared memory: each warp store
            // then covers 32 consecutive columns of one row
            float* yb = y + band * R * ldy;
            for (int i = tid; i < kTileRows * kColTile; i += kThreads) {
                const int r = i / kColTile;
                const int m = i - r * kColTile;
                const long long off = yoff[r];
                if (off >= 0 && c0 + m < L) yb[off + c0 + m] = yt[r * kYS + m];
            }
        }
    }
}

// Pass 3 on the tensor cores, for L <= 128 (one column tile). The parts of
// fp32 x and h for three TF32 products: v = hi + lo, both rounded with
// cvt.rna (hi + lo carries 22 of v's 24 bits; x_lo h_lo is dropped).
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

// c += a b, m16n8k4 in fp64 (sm_90): a = A[gid, tig], A[gid + 8, tig]; b =
// B[tig, gid]; c in the lanes and order of mma_tf32's.
__device__ __forceinline__ void mma_f64(double (&c)[4], double a0, double a1, double b) {
    asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
        "{%0, %1, %2, %3};"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a0), "d"(a1), "d"(b));
}

// y row `row` (null past the end) <- columns m and m + 1 (those < L)
__device__ __forceinline__ void store_pair(float* row, int m, int L, double v0, double v1) {
    if (row == nullptr) return;
    float* p = row + m;
    if (m + 1 < L && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
        *reinterpret_cast<float2*>(p) = make_float2((float)v0, (float)v1);
    } else {
        if (m < L) p[0] = (float)v0;
        if (m + 1 < L) p[1] = (float)v1;
    }
}

constexpr int kMmaWarps = 4;                 // warps per block: 16 rows each
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kTiles = kColTile / 8;         // 8-column tiles of a block's columns
constexpr int kXR = kColTile + 4;            // row stride of xs: conflict-free A fragments
constexpr int kGR = kColTile + 8;            // row stride (doubles) of Gs: conflict-free B fragments
constexpr int kHZ = kColTile + 8;            // hz[u] = h[u - 8], zero outside [0, L)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// async copies, zero-filled when !valid (src then only needs to be a valid
// address)
__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp8(double* dst, const double* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// queue plane (b, p)'s G slab (lanes padded to N4 with zeros) and zero-padded
// h into one of the two stages
__device__ __forceinline__ void queue_plane(const float* __restrict__ h,
                                            const double* __restrict__ G, double* Gs, float* hz,
                                            long long band, int L, int N, int N4) {
    for (int i = threadIdx.x; i < N4 * kColTile; i += kMmaThreads) {
        const int n = i / kColTile;
        const int m = i - n * kColTile;
        const bool valid = n < N && m < L;
        cp8(Gs + n * kGR + m, valid ? G + (band * N + n) * L + m : G, valid);
    }
    for (int u = threadIdx.x; u < kHZ; u += kMmaThreads) {
        const bool valid = u >= 8 && u - 8 < L;
        cp4(hz + u, valid ? h + band * L + u - 8 : h, valid);
    }
}

// Block: 64 rows (r,k); warp w owns rows 16w..16w+15 and all columns. x's
// tile (rows x 128, zero past L) stays in shared memory for every band and
// plane; each plane's G slab and h arrive by cp.async in one of two stages
// while the previous plane is computed. Each warp keeps h's 16 Toeplitz
// tiles as B fragments (hi and lo: 64 registers) and its 16 column tiles'
// sums (64 registers); for each l tile lt it splits its A fragment of x
// once and adds it to the column tiles nt >= lt: x_lo h_hi, x_hi h_lo,
// x_hi h_hi. The epilogue adds s G per column tile on the fp64 tensor cores
// in KS k-steps of 4 lanes (s's A fragments read from vs once per band,
// before the x h loop) and stores each lane's column pairs of its two rows.
template <int KS>
__global__ void __launch_bounds__(kMmaThreads, KS <= 4 ? 3 : 2)
bank_out_mma_kernel(const float* __restrict__ x, const float* __restrict__ h,
                    const double* __restrict__ G, const double* __restrict__ vs,
                    float* __restrict__ y, int B, long long R, long long K, int L, int N, int P,
                    long long ldx, long long ldy) {
    extern __shared__ double2 smem4[];
    const int N4 = (N + 3) & ~3;
    double* Gs = reinterpret_cast<double*>(smem4);                 // 2 stages of (N4, kGR)
    long long* rowoff = reinterpret_cast<long long*>(Gs + 2 * (size_t)N4 * kGR);
    long long* yoff = rowoff + kTileRows;
    float* xs = reinterpret_cast<float*>(yoff + kTileRows);        // (kTileRows, kXR)
    float* hz = xs + kTileRows * kXR;                              // 2 stages of (kHZ)
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    const long long RK = R * K;
    const long long BN = (long long)B * N;
    const long long row0 = (long long)blockIdx.x * kTileRows;
    const int wr = 16 * warp;       // the warp's first row in the tile
    const int nT = (L + 7) >> 3;    // l tiles holding x
    const int planes = B * P;       // in the order (b, p)
    row_offsets(rowoff, yoff, row0, RK, K, L, ldx, ldy);
    __syncthreads();
    for (int i = tid; i < kTileRows * kColTile; i += kMmaThreads) {
        const int r = i / kColTile;
        const int l = i - r * kColTile;
        const long long off = rowoff[r];
        const bool valid = off >= 0 && l < L;
        cp4(xs + r * kXR + l, valid ? x + off + l : x, valid);
    }
    queue_plane(h, G, Gs, hz, 0, L, N, N4);
    cp_commit();
    const float* xw = xs + wr * kXR + tig;
    const long long off0 = yoff[wr + gid];
    const long long off1 = yoff[wr + gid + 8];

    double sa[2][KS];
    for (int q = 0; q < planes; ++q) {
        const int b = q / P;
        const long long band = (long long)(q - b * P) * B + b;
        const double* Gq = Gs + (q & 1) * (size_t)N4 * kGR;
        const float* hq = hz + (q & 1) * kHZ;
        cp_wait_all();
        __syncthreads();  // plane q's stage is visible; plane q - 1's is free
        if (q + 1 < planes) {
            const int b1 = (q + 1) / P;
            queue_plane(h, G, Gs + ((q + 1) & 1) * (size_t)N4 * kGR, hz + ((q + 1) & 1) * kHZ,
                        (long long)(q + 1 - b1 * P) * B + b1, L, N, N4);
            cp_commit();
        }

        // s's A fragments, once per band: sa[half][ks] = s[row wr + 8 half +
        // gid][lane 4 ks + tig]
        if (q == b * P) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const long long row = row0 + wr + 8 * half + gid;
#pragma unroll
                for (int ks = 0; ks < KS; ++ks) {
                    const int n = 4 * ks + tig;
                    sa[half][ks] = (n < N && row < RK) ? vs[row * BN + (long long)b * N + n] : 0.0;
                }
            }
        }
        // tile d: b0 = h[8d + gid - tig], b1 = h[8d + gid - tig - 4]
        uint32_t hb[kTiles][2][2];  // [d][b0, b1][hi, lo]
#pragma unroll
        for (int d = 0; d < kTiles; ++d) {
            split_tf32(hq[8 * d + gid - tig + 8], hb[d][0][0], hb[d][0][1]);
            split_tf32(hq[8 * d + gid - tig + 4], hb[d][1][0], hb[d][1][1]);
        }
        float acc[kTiles][4];
#pragma unroll
        for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
#pragma unroll
        for (int lt = 0; lt < kTiles; ++lt) {
            if (lt < nT) {  // warp-uniform
                const float* xa = xw + 8 * lt;
                uint32_t ahi[4], alo[4];
                split_tf32(xa[gid * kXR], ahi[0], alo[0]);
                split_tf32(xa[(gid + 8) * kXR], ahi[1], alo[1]);
                split_tf32(xa[gid * kXR + 4], ahi[2], alo[2]);
                split_tf32(xa[(gid + 8) * kXR + 4], ahi[3], alo[3]);
#pragma unroll
                for (int nt = lt; nt < kTiles; ++nt)
                    mma_tf32(acc[nt], alo, hb[nt - lt][0][0], hb[nt - lt][1][0]);
#pragma unroll
                for (int nt = lt; nt < kTiles; ++nt)
                    mma_tf32(acc[nt], ahi, hb[nt - lt][0][1], hb[nt - lt][1][1]);
#pragma unroll
                for (int nt = lt; nt < kTiles; ++nt)
                    mma_tf32(acc[nt], ahi, hb[nt - lt][0][0], hb[nt - lt][1][0]);
            }
        }

        float* yb = y + band * R * ldy;
        float* y0 = off0 >= 0 ? yb + off0 : nullptr;  // rows gid and gid + 8
        float* y1 = off1 >= 0 ? yb + off1 : nullptr;
#pragma unroll
        for (int nt = 0; nt < kTiles; ++nt) {
            double c[4] = {acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]};
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
                if (4 * ks < N4)  // warp-uniform
                    mma_f64(c, sa[0][ks], sa[1][ks], Gq[(4 * ks + tig) * kGR + 8 * nt + gid]);
            }
            store_pair(y0, 8 * nt + 2 * tig, L, c[0], c[1]);
            store_pair(y1, 8 * nt + 2 * tig, L, c[2], c[3]);
        }
    }
}
}  // namespace

// x (R rows of stride ldx; the first K*L samples of each are filtered), fp32;
// h (P, B, L) fp32; M (L, B*Ns), A (B, Ns, Ns), G (P, B, Ns, L) fp64, the
// operators' real form -> y (P, B, R rows of stride ldy), columns [0, K*L)
// written, fp32; zf (B, R, Ns) fp64, the state after block K. Scratch, fp64:
// vs (R*K, B*Ns) and carry (B*R, ceil(K/F), Ns), F the chunk length of the
// chain. Ns <= 32 and even; all on one device. Returns the first CUDA error
// code met (0 on success).
extern "C" int dsptb_iir_bank_f32(const float* x, const float* h, const double* M,
                                  const double* A, const double* G, float* y, double* vs,
                                  double* carry, double* zf, int B, long long R, long long K,
                                  int L, int Ns, int P, int F, long long ldx, long long ldy,
                                  void* stream) {
    if (B <= 0 || R <= 0 || K <= 0 || L <= 0 || Ns <= 0 || Ns > kMaxState || (Ns & 1) ||
        P < 1 || P > 2 || F <= 0 || ldx < K * L || ldy < K * L)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const long long RK = R * K;
    const long long tiles = (RK + kTileRows - 1) / kTileRows;
    const long long nc = (K + F - 1) / F;
    if (tiles > 2147483647LL || (long long)B * R * nc > 2147483647LL / 32)
        return (int)cudaErrorInvalidValue;

    int device = 0, smem_max = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                      device)) != cudaSuccess)
        return (int)err;

    // pass 1
    const size_t smem1 = sizeof(double) * kLChunk * kLaneChunk + sizeof(long long) * kTileRows +
                         sizeof(float) * kLChunk * kXS;
    if ((err = cudaFuncSetAttribute(bank_inject_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem1)) != cudaSuccess)
        return (int)err;
    bank_inject_kernel<<<(unsigned)tiles, kThreads, smem1, st>>>(x, M, vs, RK, K, L, B * Ns, ldx);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    // pass 2: Ns = 2 * sections (real) or 4 * sections (complex); the
    // bank sizes of the filter-bank path get a compile-time state size
    const ChainShape cs{(long long)B * R, R, K, B * Ns, Ns, F, (int)nc};
    switch (Ns) {
        case 4: err = launch_chain<4>(A, vs, carry, zf, cs, st); break;
        case 8: err = launch_chain<8>(A, vs, carry, zf, cs, st); break;
        case 12: err = launch_chain<12>(A, vs, carry, zf, cs, st); break;
        case 16: err = launch_chain<16>(A, vs, carry, zf, cs, st); break;
        default: err = launch_chain<0>(A, vs, carry, zf, cs, st); break;
    }
    if (err != cudaSuccess) return (int)err;

    // pass 3: L <= 128 on the tensor cores, x's tile resident; longer blocks
    // on the CUDA cores, x streamed. Both keep one plane's G slab and h in
    // shared memory
    if (L <= kColTile) {
        const size_t smem4 = sizeof(double) * 2 * (size_t)((Ns + 3) & ~3) * kGR +
                             sizeof(long long) * 2 * kTileRows +
                             sizeof(float) * ((size_t)kTileRows * kXR + 2 * kHZ);
        if (smem4 > (size_t)smem_max) return (int)cudaErrorInvalidValue;
        // s's k-steps: up to 4 (Ns <= 16, three blocks an SM) or 8
        auto out_kernel = Ns <= 16 ? bank_out_mma_kernel<4> : bank_out_mma_kernel<8>;
        if ((err = cudaFuncSetAttribute(out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem4)) != cudaSuccess)
            return (int)err;
        out_kernel<<<(unsigned)tiles, kMmaThreads, smem4, st>>>(
            x, h, G, vs, y, B, R, K, L, Ns, P, ldx, ldy);
        return (int)cudaGetLastError();
    }
    const int n_col = (L + kColTile - 1) / kColTile;
    const size_t smem3 = sizeof(double) * ((size_t)kTileRows * Ns + (size_t)Ns * kColTile) +
                         sizeof(long long) * 2 * kTileRows +
                         sizeof(float) * ((size_t)kLChunk * kXS + hw_alloc(L) +
                                          (size_t)kTileRows * kYS);
    if (smem3 > (size_t)smem_max) return (int)cudaErrorInvalidValue;
    if ((err = cudaFuncSetAttribute(bank_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem3)) != cudaSuccess)
        return (int)err;
    bank_out_kernel<<<dim3((unsigned)tiles, (unsigned)n_col), kThreads, smem3, st>>>(
        x, h, G, vs, y, B, R, K, L, Ns, P, ldx, ldy);
    return (int)cudaGetLastError();
}
