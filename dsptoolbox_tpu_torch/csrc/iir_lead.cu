// Blocked SOS-cascade lead: L-sample blocks of a state-space filter.
// Replaces the Pallas kernel `sosfilt_pallas` / `_iir_kernel`
// (dsptoolbox_tpu/ops/pallas_iir.py).
//
// Per block k of row b, with operators H (L,L), G (N,L), A (N,N), M (L,N):
//     y_k     = x_k H + s_k G
//     s_{k+1} = s_k A + x_k M,        s_0 given, zf = s_K.
//
// Precision: the Toeplitz product x_k H runs in fp32 FFMA (H is the impulse
// response, entries below 1, well conditioned). The boundary-state path
// (v = x M, the chain, s G) runs in fp64: for low-frequency cascades the
// output operator G reaches 1e3-1e5 while y stays O(1), so fp32 rounding of
// the state is amplified ~1e4 by cancellation. No tensor cores, no TF32.
//
// Bound on the H100: the Toeplitz product x_k H is 2·L² flops per block
// (L = 128: 64 flop per input byte), and the state chain is K serial steps
// of an N×N product per row, which is bound by latency, not by any
// throughput. The Pallas kernel carried the state across a sequential grid
// in VMEM; CUDA blocks run in no order, so the work is split in passes
// (five launches):
//   1. free:  parallel over rows (b,k) and column tiles of 128: y = x H and
//             v = x M, y in 4 x 4 register tiles per thread. H's column slab
//             and M sit in shared memory (92 KB for L = 128 and N = 8,
//             dynamic shared memory), loaded once per block of a grid sized
//             to fill the card; for block lengths whose slab does not fit
//             (L above ~200), they are streamed in chunks of 32 rows of l;
//   2. state: s_{k+1} = s_k A + v_k, with one warp per walk, the state in
//             registers (lane n holds s[n], N <= 32) and the v_k of 16 steps
//             loaded ahead. A walk over all K blocks of a row would be K
//             serial steps; instead the K steps are cut into chunks of F:
//             2a. each chunk walks from a zero state (parallel over chunks);
//             2b. one warp per row carries the chunk start states,
//                 S_{c+1} = S_c A^F + w_c (K/F serial steps);
//             2c. each chunk walks again from S_c and overwrites v_k with s_k.
//             The serial depth drops from K to ~2F + K/F (F ~ sqrt(K/2));
//   3. out:   parallel over rows: y += s_k G.

#include <cuda_runtime.h>

namespace {

constexpr int kFreeRows = 32;   // rows (b,k) per tile in pass 1
constexpr int kXT = 36;         // row stride of pass 1's transposed x tile (a multiple of 4)
constexpr int kColTile = 128;   // columns of y per block in passes 1 and 3
constexpr int kChunk = 32;      // l per step of pass 1 when H's slab does not fit at once
constexpr int kOutRows = 32;    // rows per block in pass 3
constexpr int kStepAhead = 16;  // v_k loaded ahead in pass 2
constexpr int kMaxState = 32;   // N <= one warp

// Pass 1. Block (., c) computes columns [c*CT, c*CT + CT) of y = x H for
// tiles of kFreeRows rows (b,k) at a time, walking the tiles strided by the
// grid; the blocks of column tile 0 also compute v = x M. The reduction over
// l runs in chunks of KC: when one chunk covers all of l (KC >= L; L = 128
// does), H's column slab and M are loaded into shared memory once per
// block, otherwise chunk by chunk for every tile. blockDim.x == 2 * CT:
// thread (rg, cg) owns a 4 x 4 register tile of y, rows 4rg..4rg+3 and
// columns 4cg..4cg+3 of the slab, and per l reads one float4 of x (from the
// tile stored transposed, xt[l][r]) and one float4 of H: 16 FFMA per two
// shared loads. (One thread per column with the rows' x values broadcast
// took 1.3x as long: 128-bit broadcasts are paid in shared-memory
// wavefronts.) Thread i accumulates v for (row, n) = (i / N, i % N) in
// shared memory across chunks, four partial sums over l per chunk to
// shorten the fp64 FMA chain. kResident (KC >= L) is a template parameter
// so that the one-chunk case (L = 128) compiles to the plain loop over a
// resident slab: with the chunk bookkeeping compiled in, pass 1 ran ~1.35x
// as long at L = 128 on the H100.
template <bool kResident>
__global__ void __launch_bounds__(2 * kColTile, 2)
lead_free_kernel(const float* __restrict__ xb, const float* __restrict__ H,
                 const double* __restrict__ M, float* __restrict__ y, double* __restrict__ v,
                 long long rows, int L, int N, int KC, int CT) {
    extern __shared__ double2 smem1[];
    double* Ms = reinterpret_cast<double*>(smem1);             // (KC, N), zero padded
    double* vacc = Ms + (size_t)KC * N;                        // (kFreeRows, N)
    float* Hs = reinterpret_cast<float*>(vacc + kFreeRows * N);  // (KC, CT), zero padded
    float* xt = Hs + (size_t)KC * CT;                          // (KC, kXT): xt[l][r]
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const int ncg = CT / 4;
    const int rg = tid / ncg;
    const int m0 = 4 * (tid - rg * ncg);
    const int q0 = 4 * rg;
    const int c0 = blockIdx.y * CT;
    const bool do_v = blockIdx.y == 0;
    const long long n_tiles = (rows + kFreeRows - 1) / kFreeRows;

    // H[lc:lc+KC, c0:c0+CT] and (column tile 0) M[lc:lc+KC, :] into shared memory
    auto load_operators = [&](int lc) {
        for (int i = tid; i < KC * CT; i += nt) {
            const int l = i / CT;
            const int m = i - l * CT;
            Hs[i] = (lc + l < L && c0 + m < L) ? H[(size_t)(lc + l) * L + c0 + m] : 0.0f;
        }
        if (do_v)
            for (int i = tid; i < KC * N; i += nt)
                Ms[i] = lc + i / N < L ? M[(size_t)lc * N + i] : 0.0;
    };
    if (kResident) load_operators(0);

    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const long long r0 = tile * kFreeRows;
        float acc[4][4] = {};
        for (int lc = 0; lc < L; lc += KC) {
            __syncthreads();  // the previous chunk's reads of Hs, Ms and xt are done
            if (!kResident) load_operators(lc);
            for (int i = tid; i < kFreeRows * KC; i += nt) {
                const int r = i / KC;
                const int l = i - r * KC;
                const long long row = r0 + r;
                xt[l * kXT + r] = (row < rows && lc + l < L) ? xb[row * L + lc + l] : 0.0f;
            }
            __syncthreads();

#pragma unroll 4
            for (int l = 0; l < KC; ++l) {
                const float4 xv = *reinterpret_cast<const float4*>(xt + l * kXT + q0);
                const float4 hv = *reinterpret_cast<const float4*>(Hs + l * CT + m0);
                const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
                const float hc[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
                for (int a = 0; a < 4; ++a)
#pragma unroll
                    for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(xr[a], hc[b], acc[a][b]);
            }

            if (do_v) {
                for (int i = tid; i < kFreeRows * N; i += nt) {
                    const int r = i / N;
                    const int n = i - r * N;
                    double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
                    for (int l = 0; l < KC; l += 4) {  // rows of Ms past L are zero
                        a0 = fma((double)xt[(l + 0) * kXT + r], Ms[(l + 0) * N + n], a0);
                        a1 = fma((double)xt[(l + 1) * kXT + r], Ms[(l + 1) * N + n], a1);
                        a2 = fma((double)xt[(l + 2) * kXT + r], Ms[(l + 2) * N + n], a2);
                        a3 = fma((double)xt[(l + 3) * kXT + r], Ms[(l + 3) * N + n], a3);
                    }
                    const double part = (a0 + a1) + (a2 + a3);
                    if (kResident) {
                        if (r0 + r < rows) v[(r0 + r) * N + n] = part;
                    } else {  // entry i is only ever touched by this thread
                        vacc[i] = (lc == 0 ? 0.0 : vacc[i]) + part;
                    }
                }
            }
            if (kResident) break;
        }

        const int col = c0 + m0;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            const long long row = r0 + q0 + a;
            if (row >= rows || col >= L) continue;
            if ((L & 3) == 0) {  // the four columns exist, 16-byte aligned
                *reinterpret_cast<float4*>(y + row * L + col) =
                    make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
            } else {
#pragma unroll
                for (int b = 0; b < 4; ++b)
                    if (col + b < L) y[row * L + col + b] = acc[a][b];
            }
        }
        if (!kResident && do_v)
            for (int i = tid; i < kFreeRows * N; i += nt)
                if (r0 + i / N < rows) v[r0 * N + i] = vacc[i];
    }
}

// The chain kernels are templated on the state size: NN > 0 fixes N = NN
// at compile time (loops fully unrolled, no bound checks; on the H100 a
// float64 step with N = 8 takes ~115 cycles this way against ~430 with N
// read at run time); NN == 0 reads N at run time (N <= kMaxState).
template <int NN>
__host__ __device__ constexpr int loop_bound() { return NN > 0 ? NN : kMaxState; }

// One step of the boundary-state chain for the warp: lane n returns
// v[n] + sum_j s[j] A[j][n], with a[j] = A[j][lane] held in registers. Two
// partial sums halve the dependent FMA chain.
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

// Walk steps [k_begin, k_end) of one row (row[k * N + n] holds v_k) from
// state s; with `store`, overwrite each v_k with the state entering step k.
// Returns the state after the last step. The v_k of the next kStepAhead
// steps are loaded before the current ones are used (unconditional loads at
// clamped addresses, so the compiler cannot sink them into the steps), and
// the loads cannot move below the stores to the same row: each batch of
// steps waits for memory at most once, and usually not at all.
template <int NN>
__device__ __forceinline__ double chain_walk(double s, double* __restrict__ row,
                                             long long k_begin, long long k_end,
                                             const double (&a)[kMaxState], int N,
                                             bool store) {
    if (k_begin >= k_end) return s;
    const int lane = threadIdx.x & 31;
    const bool live = lane < N;
    const int ln = live ? lane : N - 1;  // idle lanes read a valid address
    const long long last = k_end - 1;
    double nxt[kStepAhead];
#pragma unroll
    for (int i = 0; i < kStepAhead; ++i) {
        const long long k = k_begin + i < last ? k_begin + i : last;
        nxt[i] = row[k * N + ln];
    }
    for (long long k0 = k_begin; k0 < k_end; k0 += kStepAhead) {
        double cur[kStepAhead];
#pragma unroll
        for (int i = 0; i < kStepAhead; ++i) {
            cur[i] = nxt[i];
            const long long k = k0 + kStepAhead + i < last ? k0 + kStepAhead + i : last;
            nxt[i] = row[k * N + ln];
        }
#pragma unroll
        for (int i = 0; i < kStepAhead; ++i) {
            if (k0 + i < k_end) {
                if (store && live) row[(k0 + i) * N + lane] = s;
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

// Pass 2a. One warp per (b, c), c < nc - 1: the end state w_c of chunk c
// walked from zero, written to carry[b, c].
template <int NN>
__global__ void chain_local_kernel(const double* __restrict__ A, double* __restrict__ vs,
                                   double* __restrict__ carry, long long B, long long K,
                                   int N, int F, int nc) {
    const int lane = threadIdx.x & 31;
    const long long w = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (w >= B * (nc - 1)) return;
    const long long b = w / (nc - 1);
    const long long c = w - b * (nc - 1);
    double a[kMaxState];
    load_column<NN>(A, N, a);
    const double s = chain_walk<NN>(0.0, vs + b * K * N, c * F, (c + 1) * F, a, N, false);
    if (lane < N) carry[(b * nc + c) * N + lane] = s;
}

// Pass 2b. One warp per row b: with P = A^F (built here, lane n holding
// column n), S_0 = s0 and S_{c+1} = S_c P + w_c; carry[b, c] <- S_c.
template <int NN>
__global__ void chain_carry_kernel(const double* __restrict__ A, const double* __restrict__ s0,
                                   double* __restrict__ carry, long long B, int N, int F,
                                   int nc) {
    const int lane = threadIdx.x & 31;
    const long long b = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (b >= B) return;
    double a[kMaxState], p[kMaxState];
    load_column<NN>(A, N, a);
    // p[i] = P[i][lane]; P <- P A, F times, from the identity
#pragma unroll
    for (int i = 0; i < loop_bound<NN>(); ++i) p[i] = (i == lane && lane < N) ? 1.0 : 0.0;
    for (int t = 0; t < F; ++t) {
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
    double* row = carry + b * (long long)nc * N;
    const double s =
        chain_walk<NN>(lane < N ? s0[b * N + lane] : 0.0, row, 0, nc - 1, p, N, true);
    if (lane < N) row[(long long)(nc - 1) * N + lane] = s;
}

// Pass 2c. One warp per (b, c): walk chunk c from S_c = carry[b, c],
// overwriting v_k with s_k; the last chunk writes zf.
template <int NN>
__global__ void chain_expand_kernel(const double* __restrict__ A, const double* __restrict__ carry,
                                    double* __restrict__ vs, double* __restrict__ zf,
                                    long long B, long long K, int N, int F, int nc) {
    const int lane = threadIdx.x & 31;
    const long long w = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (w >= B * nc) return;
    const long long b = w / nc;
    const long long c = w - b * nc;
    double a[kMaxState];
    load_column<NN>(A, N, a);
    const long long k_end = (c + 1) * F < K ? (c + 1) * F : K;
    const double s0 = lane < N ? carry[(b * nc + c) * N + lane] : 0.0;
    const double s = chain_walk<NN>(s0, vs + b * K * N, c * F, k_end, a, N, true);
    if (c == nc - 1 && lane < N) zf[b * N + lane] = s;
}

// Pass 2 for one state size: the three chain launches.
template <int NN>
cudaError_t launch_chain(const double* A, const double* s0, double* vs, double* carry,
                         double* zf, long long B, long long K, int N, int F, int nc,
                         cudaStream_t st) {
    constexpr int kWarps = 4;  // warps per block
    auto blocks = [](long long warps) { return (unsigned)((warps + kWarps - 1) / kWarps); };
    cudaError_t err;
    if (nc > 1) {
        chain_local_kernel<NN><<<blocks(B * (nc - 1)), 32 * kWarps, 0, st>>>(A, vs, carry, B, K,
                                                                             N, F, nc);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    chain_carry_kernel<NN><<<blocks(B), 32 * kWarps, 0, st>>>(A, s0, carry, B, N, F, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    chain_expand_kernel<NN><<<blocks(B * nc), 32 * kWarps, 0, st>>>(A, carry, vs, zf, B, K, N, F,
                                                                    nc);
    return cudaGetLastError();
}

// Pass 3. Block (r, c) adds to columns [c*CT, c*CT + CT) of kOutRows rows,
// CT == blockDim.x: y[row, m] += sum_n s[row, n] G[n, m].
__global__ void lead_out_kernel(const double* __restrict__ G, const double* __restrict__ ss,
                                float* __restrict__ y, long long rows, int L, int N) {
    extern __shared__ double2 smem2[];
    const int CT = blockDim.x;
    double* Gs = reinterpret_cast<double*>(smem2);  // (N, CT)
    double* sr = Gs + (size_t)N * CT;                 // (kOutRows, N)
    const int tid = threadIdx.x;
    const long long r0 = (long long)blockIdx.x * kOutRows;
    const int c0 = blockIdx.y * CT;
    for (int i = tid; i < N * CT; i += CT) {
        const int n = i / CT;
        const int m = i - n * CT;
        Gs[i] = c0 + m < L ? G[(size_t)n * L + c0 + m] : 0.0;
    }
    for (int i = tid; i < kOutRows * N; i += CT) {
        const long long row = r0 + i / N;
        sr[i] = row < rows ? ss[r0 * N + i] : 0.0;
    }
    __syncthreads();
    const int col = c0 + tid;
    if (col >= L) return;
    for (int r = 0; r < kOutRows; ++r) {
        const long long row = r0 + r;
        if (row >= rows) break;
        double a = y[row * L + col];
        for (int n = 0; n < N; ++n) a = fma(sr[r * N + n], Gs[n * CT + tid], a);
        y[row * L + col] = (float)a;
    }
}

}  // namespace

// Any L; N <= 32 (longer cascades are run as a series of shorter ones).
// xb (B, K, L) and H (L, L) fp32; G (N, L), A (N, N), M (L, N) and s0 (B, N) fp64
// -> y (B, K, L) fp32, zf (B, N) fp64. Scratch, fp64: vs (B, K, N) and carry
// (B, nc, N) with nc = ceil(K / F), F the chunk length of pass 2. All
// contiguous, on one device. Returns the first CUDA error code met (0 on
// success).
extern "C" int dsptb_iir_lead_f32(const float* xb, const float* H, const double* G,
                                  const double* A, const double* M, const double* s0,
                                  float* y, double* vs, double* carry, double* zf,
                                  long long B, long long K, int L, int N, int F,
                                  void* stream) {
    if (B <= 0 || K <= 0 || L <= 0 || N <= 0 || N > kMaxState || F <= 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const long long rows = B * K;
    const long long nc = (K + F - 1) / F;
    if (B * nc > 2147483647LL / 32) return (int)cudaErrorInvalidValue;

    int device = 0, sms = 0, smem_max = 0, per_sm = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
        return (int)err;
    if ((err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                      device)) != cudaSuccess)
        return (int)err;

    // pass 1: column tiles of CT, l in one chunk when H's slab fits (H then
    // stays in shared memory for the block's life), else in chunks of kChunk
    const int Lp = (L + 3) & ~3;
    const int CT = Lp < kColTile ? Lp : kColTile;
    const int n_col = (Lp + CT - 1) / CT;
    auto smem_for = [&](int KC) {
        return sizeof(double) * ((size_t)KC * N + (size_t)kFreeRows * N) +
               sizeof(float) * ((size_t)KC * CT + (size_t)KC * kXT);
    };
    const bool resident = smem_for(Lp) <= (size_t)smem_max;
    const int KC = resident ? Lp : kChunk;
    const size_t smem1 = smem_for(KC);
    auto free_kernel = resident ? lead_free_kernel<true> : lead_free_kernel<false>;
    err = cudaFuncSetAttribute(free_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem1);
    if (err != cudaSuccess) return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, free_kernel, 2 * CT,
                                                             smem1)) != cudaSuccess)
        return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    // as many blocks as fit on the card at once
    const long long tiles = (rows + kFreeRows - 1) / kFreeRows;
    long long fit = (long long)sms * per_sm / n_col;
    if (fit < 1) fit = 1;
    const dim3 grid1((unsigned)(tiles < fit ? tiles : fit), (unsigned)n_col);
    free_kernel<<<grid1, 2 * CT, smem1, st>>>(xb, H, M, y, vs, rows, L, N, KC, CT);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    // N = 2 * sections: the common sizes get a compile-time state size
    switch (N) {
        case 2: err = launch_chain<2>(A, s0, vs, carry, zf, B, K, N, F, (int)nc, st); break;
        case 4: err = launch_chain<4>(A, s0, vs, carry, zf, B, K, N, F, (int)nc, st); break;
        case 6: err = launch_chain<6>(A, s0, vs, carry, zf, B, K, N, F, (int)nc, st); break;
        case 8: err = launch_chain<8>(A, s0, vs, carry, zf, B, K, N, F, (int)nc, st); break;
        case 10: err = launch_chain<10>(A, s0, vs, carry, zf, B, K, N, F, (int)nc, st); break;
        case 12: err = launch_chain<12>(A, s0, vs, carry, zf, B, K, N, F, (int)nc, st); break;
        case 14: err = launch_chain<14>(A, s0, vs, carry, zf, B, K, N, F, (int)nc, st); break;
        case 16: err = launch_chain<16>(A, s0, vs, carry, zf, B, K, N, F, (int)nc, st); break;
        default: err = launch_chain<0>(A, s0, vs, carry, zf, B, K, N, F, (int)nc, st); break;
    }
    if (err != cudaSuccess) return (int)err;

    // pass 3: column tiles of up to kColTile threads
    const int CT3 = L < kColTile ? L : kColTile;
    const long long grid3 = (rows + kOutRows - 1) / kOutRows;
    if (grid3 > 2147483647LL) return (int)cudaErrorInvalidValue;
    const size_t smem3 = sizeof(double) * ((size_t)N * CT3 + (size_t)kOutRows * N);
    err = cudaFuncSetAttribute(lead_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem3);
    if (err != cudaSuccess) return (int)err;
    lead_out_kernel<<<dim3((unsigned)grid3, (unsigned)((L + CT3 - 1) / CT3)), CT3, smem3, st>>>(
        G, vs, y, rows, L, N);
    return (int)cudaGetLastError();
}
