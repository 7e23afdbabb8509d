// Blocked IIR: B same-order SOS cascades on one shared input, in L-sample
// blocks. Replaces two Pallas kernels:
//   - the filter bank `sosfilt_bank_pallas` / `_bank_kernel_real` /
//     `_bank_kernel_cplx` (dsptoolbox_tpu/ops/pallas_iir_bank.py), zero start
//     state, B bands;
//   - the blocked-IIR lead `sosfilt_pallas` / `_iir_kernel`
//     (dsptoolbox_tpu/ops/pallas_iir.py), which is this function with one band
//     and one plane, its batch as the rows and a start state s0.
//
// The input x (R rows, row stride ldx) is real and shared by every band.
// Per band b and L-sample block k of row r, in the real form of the
// operators (a complex cascade with N complex states runs as Ns = 2N real
// state lanes [Re s, Im s] and P = 2 output planes, a real one as Ns = N
// lanes and P = 1 plane):
//     y_p[b,k] = x_k h_{p,b} + s[b,k] G_{p,b}        (h: in-block impulse response)
//     s[b,k+1] = s[b,k] A_b + x_k M_b,  s[b,0] = s0[b] (zero for the bank),
//     s[b,K] is returned as zf.
//
// Precision: x_k h (the lower-triangular Toeplitz product of the in-block
// impulse response) in fp32 accuracy: on the tensor cores as three TF32
// products of a hi/lo split (x_lo h_hi + x_hi h_lo + x_hi h_hi, each part
// rounded with cvt.rna; never a single TF32 product), or in fp32 FFMA. The
// whole state path (v = x M, the chain, s G) runs in fp64: for low-frequency
// cascades (the 40-50 Hz third-octave bands, the 250 Hz crossover bands) G
// reaches 1e4-1e5 against O(1) outputs, and fp32 rounding of the state is
// amplified by that cancellation.
//
// Bound on the H100: for the bank, y dominates the bytes (16 complex bands
// write 32 floats per input float), and the work is ~L/2 fp32 FMAs per
// output sample for x h plus ~Ns fp64 FMAs per output sample for s G and
// per band-lane for x M. For the lead (one band, 4-32 lanes) the function
// moves x in and y out once (4 + 4 bytes per sample) for ~L/2 + 2 Ns FMAs
// per sample: bound by the bytes with x h on the tensor cores, while its
// chain is K serial Ns x Ns steps per row, bound by latency. The TPU kernels
// carried the state across a sequential grid in VMEM; here, in three passes
// (five launches), which write y once and keep the state in fp64:
//   1. inject: parallel over tiles of 64 rows (r,k): v = x M for every band,
//              stored as (rows, B*Ns). At 64 band-lanes and more (banks with
//              blocks longer than 128) x's tile is staged once in shared
//              memory and M streamed through it in chunks of 64 lanes on the
//              CUDA cores (`bank_inject_kernel`); below that (the lead, the
//              chain's 4-band bank) a chunk of 64 would leave most FMAs on
//              zero lanes, so the lanes are cut into 8-lane tiles for fp64
//              m16n8k4 mma.sync (`bank_inject_mma_kernel`), about x's read;
//   2. chain:  s_{k+1} = s_k A_b + v_k per (band, row), one warp per walk,
//              cut into chunks of ~sqrt(K/2) steps walked in parallel with
//              one serial carry over the chunk starts, which begins at s0;
//              v_k is overwritten with the state entering block k;
//   3. out:    y = x h + s G for every band and plane, y stored once.
//      L <= 128 (every block the package builds) takes the tensor cores
//      (`bank_out_mma_kernel`). It replaces an FFMA pass whose x h alone
//      needed ~1.7 ms per config-3 bank at the FFMA peak, with s G as dense
//      fp64 on the CUDA cores, and whose inner loop was held by shared-memory
//      loads as much as by the FMAs (6.99 / 6.53 ms on the H100); for the
//      lead it replaces an fp32 FFMA pass for x H (87-91 us per crossover
//      band, 1.8x a cuBLAS GEMM of the dense shape) that wrote y, and a
//      second pass that read y back to add s G. A warp
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
// Calls given W (the wrapper gives it at L <= 128 with 8 lanes a band and 16
// in all, or more: the filter banks, the chain's crossover, leads of 8
// sections or more) take another route
// (namespace `tiles`, three launches), on which vs is never written: at 64
// rows x 3445 blocks the two config-3 banks' vs is 1.04 GB, written by pass
// 1, read by 2a, read and written by 2c and read by 3, ~5.2 GB of traffic
// a call. There each tile of 64 consecutive blocks of one
// row keeps its states in shared memory: a tile-state pass walks every full
// tile from zero (x M on the fp64 tensor cores), the carry runs over the
// tile starts (A^64), and the output pass recomputes x M from the x tile it
// holds anyway and walks the tile from its start before the products, a
// group of bands side by side. Both walks step super-blocks of 4 blocks
// (A^4, 16 steps a tile). Fewer lanes (short leads, banks of 4-6 lanes a
// band) keep the three passes: there each tile's walk has little work
// beside it, and the wide route ran up to 19 % slower on the H100 at many
// rows.
// Host cost per call: the shared-memory opt-in of every kernel is set once
// per device, so a call is five launches (three on the wide route) and no
// attribute queries.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;        // rows (r,k) per block in passes 1 and 3
constexpr int kLChunk = 128;         // l per shared-memory chunk of x
constexpr int kXS = kTileRows + 4;   // row stride of the transposed x tile xt[l][row]
constexpr int kLaneChunk = 64;       // band-lanes (b,n) per step of pass 1 on the CUDA cores
constexpr int kColTile = 128;        // columns of y per block in pass 3
constexpr int kStepAhead = 16;       // v_k loaded ahead in pass 2
constexpr int kMaxState = 32;        // Ns <= one warp
constexpr int kYS = kColTile + 1;    // row stride of pass 3's output tile

constexpr int kMmaWarps = 4;                 // warps per block: 16 rows each
constexpr size_t kSmemThird = 76800;         // shared memory a block of three an SM
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kTiles = kColTile / 8;         // 8-column tiles of a block's columns
constexpr int kXR = kColTile + 4;            // row stride of xs: conflict-free A fragments
constexpr int kGR = kColTile + 8;            // row stride (doubles) of Gs: conflict-free B fragments
constexpr int kHZ = kColTile + 8;            // hz[u] = h[u - 8], zero outside [0, L)

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

// The parts of fp32 x and h for three TF32 products: v = hi + lo, both
// rounded with cvt.rna (hi + lo carries 22 of v's 24 bits; x_lo h_lo is
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

// c += a b, m16n8k4 in fp64 (sm_90): a = A[gid, tig], A[gid + 8, tig]; b =
// B[tig, gid]; c in the lanes and order of mma_tf32's.
__device__ __forceinline__ void mma_f64(double (&c)[4], double a0, double a1, double b) {
    asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
        "{%0, %1, %2, %3};"
        : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
        : "d"(a0), "d"(a1), "d"(b));
}

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

// Pass 1 on the CUDA cores, BN >= 64. vs[row, j] = sum_l x[row, l] M[l, j],
// j = b*Ns + n < BN, in fp64. Thread (tg, lg) owns rows 4tg..4tg+3 and lanes
// 4lg..4lg+3 of a 64-lane chunk: per l one float4 of x (broadcast to the 16
// threads of a row group) and two double2 of M for 16 fp64 FMAs. When one
// l-chunk covers L (L <= 128), x's tile is loaded once for all lane chunks.
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

// Pass 1 on the fp64 tensor cores, BN < 64, 8 NT >= BN. Block: 64 rows
// (r,k); warp w owns rows 16w..16w+15 and NT 8-lane tiles of v. Per chunk of
// 128 l, x's tile (fp32, exact in fp64) and M's rows arrive by cp.async,
// zero past L and past BN; per 4 l the warp reads one A fragment of x and
// adds it to each lane tile with one m16n8k4 fp64 mma.sync, M's B fragment
// read from shared memory. The sums stay in registers across the chunks;
// each lane stores its lane pairs of its two rows.
template <int NT>
__global__ void __launch_bounds__(kMmaThreads)
bank_inject_mma_kernel(const float* __restrict__ x, const double* __restrict__ M,
                       double* __restrict__ vs, long long RK, long long K, int L, int BN,
                       long long ldx) {
    constexpr int kLanes = 8 * NT;
    constexpr int kMS = kLanes + 4;  // row stride (doubles) of Ms: conflict-free B fragments
    extern __shared__ double2 smem5[];
    double* Ms = reinterpret_cast<double*>(smem5);                 // (kLChunk, kMS)
    long long* rowoff = reinterpret_cast<long long*>(Ms + kLChunk * kMS);
    float* xs = reinterpret_cast<float*>(rowoff + kTileRows);       // (kTileRows, kXR)
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    const int wr = 16 * (tid >> 5);  // the warp's first row in the tile
    const long long row0 = (long long)blockIdx.x * kTileRows;
    row_offsets(rowoff, nullptr, row0, RK, K, L, ldx, 0);

    double acc[NT][4] = {};
    for (int lc = 0; lc < L; lc += kLChunk) {
        const int kc = L - lc < kLChunk ? L - lc : kLChunk;
        __syncthreads();  // rowoff is written; the previous chunk's reads are done
        for (int i = tid; i < kTileRows * kLChunk; i += kMmaThreads) {
            const int r = i / kLChunk;
            const int l = i - r * kLChunk;
            const long long off = rowoff[r];
            const bool valid = off >= 0 && l < kc;
            cp4(xs + r * kXR + l, valid ? x + off + lc + l : x, valid);
        }
        for (int i = tid; i < kLChunk * kLanes; i += kMmaThreads) {
            const int l = i / kLanes;
            const int j = i - l * kLanes;
            const bool valid = l < kc && j < BN;
            cp8(Ms + l * kMS + j, valid ? M + (size_t)(lc + l) * BN + j : M, valid);
        }
        cp_commit();
        cp_wait_all();
        __syncthreads();
        const float* xa = xs + (wr + gid) * kXR + tig;
        const double* mb = Ms + tig * kMS + gid;
        for (int l0 = 0; l0 < kc; l0 += 4) {  // l past kc: zero x and M
            const double a0 = xa[l0];
            const double a1 = xa[8 * kXR + l0];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_f64(acc[nt], a0, a1, mb[l0 * kMS + 8 * nt]);
        }
    }
    // BN is even, so a lane pair never straddles its end and the double2
    // stores are aligned
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const long long row = row0 + wr + 8 * half + gid;
        if (row >= RK) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            const int j = 8 * nt + 2 * tig;
            if (j < BN)
                *reinterpret_cast<double2*>(vs + row * BN + j) =
                    make_double2(acc[nt][2 * half], acc[nt][2 * half + 1]);
        }
    }
}

// The chain kernels are templated on the state size: NN > 0 fixes Ns = NN
// at compile time (loops unrolled, no bound checks; on the H100 a fp64
// step with Ns = 8 takes ~115 cycles this way against ~430 with Ns read at
// run time); NN == 0 reads it at run time (Ns <= kMaxState).
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
// S_0 = s0[w] (zero when s0 is null) and S_{c+1} = S_c P + w_c;
// carry[w, c] <- S_c. P is read from PF + band * pf_ld where PF is given
// (the wide route's A^64), else formed here by F products.
template <int NN>
__global__ void chain_carry_kernel(const double* __restrict__ A, const double* __restrict__ s0,
                                   double* __restrict__ carry, ChainShape cs,
                                   const double* __restrict__ PF, long long pf_ld) {
    const int lane = threadIdx.x & 31;
    const long long w = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (w >= cs.W) return;
    const int N = cs.N;
    double a[kMaxState], p[kMaxState];
    load_column<NN>(A + (w / cs.R) * N * N, N, a);
#pragma unroll
    for (int i = 0; i < loop_bound<NN>(); ++i) p[i] = (i == lane && lane < N) ? 1.0 : 0.0;
    if (PF != nullptr) load_column<NN>(PF + (w / cs.R) * pf_ld, N, p);
    for (int t = 0; PF == nullptr && t < cs.F; ++t) {
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
    const double start = (s0 != nullptr && lane < N) ? s0[w * N + lane] : 0.0;
    const double s = chain_walk<NN>(start, row, N, 0, cs.nc - 1, p, N, true);
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
cudaError_t launch_chain(const double* A, const double* s0, double* vs, double* carry,
                         double* zf, const ChainShape& cs, cudaStream_t st) {
    constexpr int kWarps = 4;  // warps per block
    auto blocks = [](long long warps) { return (unsigned)((warps + kWarps - 1) / kWarps); };
    cudaError_t err;
    if (cs.nc > 1) {
        chain_local_kernel<NN><<<blocks(cs.W * (cs.nc - 1)), 32 * kWarps, 0, st>>>(A, vs, carry, cs);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    chain_carry_kernel<NN><<<blocks(cs.W), 32 * kWarps, 0, st>>>(A, s0, carry, cs, nullptr, 0);
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

// queue plane (b, p)'s G slab (lanes padded to N4 with zeros) into Gs
__device__ __forceinline__ void queue_g(const double* __restrict__ G, double* Gs, long long band,
                                        int L, int N, int N4) {
    for (int i = threadIdx.x; i < N4 * kColTile; i += kMmaThreads) {
        const int n = i / kColTile;
        const int m = i - n * kColTile;
        const bool valid = n < N && m < L;
        cp8(Gs + n * kGR + m, valid ? G + (band * N + n) * L + m : G, valid);
    }
}

// queue plane (b, p)'s zero-padded h into hz
__device__ __forceinline__ void queue_h(const float* __restrict__ h, float* hz, long long band,
                                        int L) {
    for (int u = threadIdx.x; u < kHZ; u += kMmaThreads) {
        const bool valid = u >= 8 && u - 8 < L;
        cp4(hz + u, valid ? h + band * L + u - 8 : h, valid);
    }
}

// queue plane (b, p)'s G slab and h into one of the two stages
__device__ __forceinline__ void queue_plane(const float* __restrict__ h,
                                            const double* __restrict__ G, double* Gs, float* hz,
                                            long long band, int L, int N, int N4) {
    queue_g(G, Gs, band, L, N, N4);
    queue_h(h, hz, band, L);
}

// One plane of a 64-row tile on the tensor cores, for the warp's 16 rows:
// y = x h + s G, in two parts so that a caller may wait for s or G between
// them. `plane_xh`: acc <- x h. xw: the warp's rows of x's tile (xs + wr *
// kXR + tig); hq: the plane's zero-padded h. The warp keeps h's 16 Toeplitz
// tiles as B fragments (hi and lo: 64 registers) and its 16 column tiles'
// sums (64 registers); for each l tile lt it splits its A fragment of x once
// and adds it to the column tiles nt >= lt: x_lo h_hi, x_hi h_lo, x_hi h_hi.
__device__ __forceinline__ void plane_xh(float (&acc)[kTiles][4], const float* xw,
                                         const float* hq, int nT) {
    const int lane = threadIdx.x & 31;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    // tile d: b0 = h[8d + gid - tig], b1 = h[8d + gid - tig - 4]
    uint32_t hb[kTiles][2][2];  // [d][b0, b1][hi, lo]
#pragma unroll
    for (int d = 0; d < kTiles; ++d) {
        split_tf32(hq[8 * d + gid - tig + 8], hb[d][0][0], hb[d][0][1]);
        split_tf32(hq[8 * d + gid - tig + 4], hb[d][1][0], hb[d][1][1]);
    }
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
}

// `plane_sg`: adds s G to acc per column tile on the fp64 tensor cores in
// KS k-steps of 4 lanes and stores each lane's column pairs of its two rows.
// sa: s's A fragments of the warp's rows (zero past Ns); Gq: the plane's G
// slab; y0 / y1: the output rows gid and gid + 8 (null past the end).
template <int KS>
__device__ __forceinline__ void plane_sg(const float (&acc)[kTiles][4], const double (&sa)[2][KS],
                                         const double* Gq, int N4, int L, float* y0, float* y1) {
    const int lane = threadIdx.x & 31;
    const int gid = lane >> 2;
    const int tig = lane & 3;
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

// Pass 3 on the tensor cores, for L <= 128 (one column tile). Block: 64
// rows (r,k); warp w owns rows 16w..16w+15 and all columns. x's
// tile (rows x 128, zero past L) stays in shared memory for every band and
// plane; each plane's G slab and h arrive by cp.async in one of two stages
// while the previous plane is computed (`plane_xh`, `plane_sg`; s's A
// fragments read from vs once per band, before the x h loop).
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
        float* yb = y + band * R * ldy;
        float acc[kTiles][4];
        plane_xh(acc, xw, hz + (q & 1) * kHZ, nT);
        plane_sg<KS>(acc, sa, Gs + (q & 1) * (size_t)N4 * kGR, N4, L,
                     off0 >= 0 ? yb + off0 : nullptr, off1 >= 0 ? yb + off1 : nullptr);
    }
}

// ---------------------------------------------------------------------------
// The wide route: L <= 128, taken when the caller gives W (the wrapper does
// at 8 lanes a band and 16 in all, or more). A block's state
// never goes to device memory: a tile is 64 consecutive blocks of one row
// (the last tile of a row is ragged), and only the state entering each tile
// does, about 1/64 of the three-pass route's vs. Three launches:
//   1. tile states (`tiles::chain_local_kernel`): per full tile and band,
//      V = X M_b on fp64 m16n8k4 mma.sync, the injections of its 16
//      super-blocks of 4 blocks (V P4, P4 = [A^3; A^2; A; I]) walked from
//      zero with A^4 in 16 steps; the end state to carry[b R + r, t];
//   2. carry (`chain_carry_kernel`, F = 64, A^64 given): S_{t+1} = S_t
//      A^64 + end_t from s0, carry[., t] <- S_t;
//   3. output (`tiles::bank_out_mma_kernel`): per group of up to four
//      bands, the block's warps recompute V from the resident x tile on
//      the fp64 tensor cores; a warp a band walks the 16 super-blocks from
//      S_t and fills in the states inside them (`fill_states`, three
//      steps of all 16 at once on the tensor cores), into an fp64 tile in
//      shared memory (the last tile writes zf); then the group's planes
//      (`plane_xh`, `plane_sg`).
// The output pass keeps the three-pass route's occupancy (three blocks of
// four warps an SM, ~168 registers a thread): a fifth warp that walked a
// band ahead of the products left two blocks an SM and ran 1.85x the
// three-pass output pass. The walks read the state back from shared memory
// (`tile_walk`) where the three-pass chain shuffles it: an SM issues one
// warp shuffle a clock, and the shuffles alone of both walks of the
// config-3 banks would take ~2 ms.
namespace tiles {

struct TileShape {
    long long R;   // rows
    long long K;   // blocks of a row
    long long KT;  // tiles of a row: ceil(K / 64)
    int L;         // block length, <= kColTile
    int B;         // bands
    int N;         // state lanes Ns
    long long ldx;
};

// xs[i][l] <- the tile's x (64 L contiguous floats from xt: block i, sample
// l) for i < nv and l < L, zero elsewhere up to kColTile columns; issued by
// the block's first `threads` threads, committed by the caller
__device__ __forceinline__ void stage_x(const float* __restrict__ xt, float* xs, int L, int nv,
                                        int threads) {
    for (int i = threadIdx.x; i < kTileRows * kColTile; i += threads) {
        const int r = i / kColTile;
        const int l = i - r * kColTile;
        const bool valid = r < nv && l < L;
        cp4(xs + r * kXR + l, valid ? xt + (long long)r * L + l : xt, valid);
    }
}

// v[i][n] <- sum_l x[i][l] M_b[l][n] for the tile's 64 rows (xs: x's tile,
// row stride kXR, zero past L) and the NTW 8-lane tiles from lane n0, ns
// lanes apart (lanes below N only), on fp64 m16n8k4 mma.sync: per 4 l, one
// B fragment of M_b per lane tile (read through the read-only cache; zero
// past L and past N), used by all four row tiles. mb = M + b Ns, rows of
// BN; v: row stride vs doubles (even).
template <int NTW>
__device__ __forceinline__ void tile_v(const float* xs, const double* __restrict__ mb,
                                       long long BN, int L, int n0, int ns, int N, double* v,
                                       int vs) {
    const int lane = threadIdx.x & 31;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    double acc[4][NTW][4];
#pragma unroll
    for (int rt = 0; rt < 4; ++rt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[rt][nt][i] = 0.0;
    const float* xa = xs + gid * kXR + tig;
#pragma unroll 4
    for (int l0 = 0; l0 < L; l0 += 4) {
        const int l = l0 + tig;
        double bm[NTW];
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
            const int n = n0 + ns * nt + gid;
            bm[nt] = (l < L && n < N) ? __ldg(mb + l * BN + n) : 0.0;
        }
#pragma unroll
        for (int rt = 0; rt < 4; ++rt) {
            const double a0 = xa[16 * rt * kXR + l0];
            const double a1 = xa[(16 * rt + 8) * kXR + l0];
#pragma unroll
            for (int nt = 0; nt < NTW; ++nt) mma_f64(acc[rt][nt], a0, a1, bm[nt]);
        }
    }
    // lane pairs (2 tig, 2 tig + 1) of rows gid and gid + 8; N is even, so a
    // pair never straddles it and the double2 stores are aligned
#pragma unroll
    for (int rt = 0; rt < 4; ++rt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
            const int n = n0 + ns * nt + 2 * tig;
            if (n < N) {
                double* row = v + (16 * rt + gid) * vs + n;
                *reinterpret_cast<double2*>(row) = make_double2(acc[rt][nt][0], acc[rt][nt][1]);
                *reinterpret_cast<double2*>(row + 8 * vs) =
                    make_double2(acc[rt][nt][2], acc[rt][nt][3]);
            }
        }
}

// The injections of the tile's 16 super-blocks of 4 blocks: w[m] = sum_j
// v[4m + j] A^(3 - j) = V4 P4, P4 = [A^3; A^2; A; I] ((4N, N), p4), from the
// rows of v (stride vs, lanes below N) on fp64 m16n8k4 mma.sync: c holds
// the NT lane tiles' C fragments (rows gid and gid + 8).
template <int NT>
__device__ __forceinline__ void super_v(double (&c)[NT][4], const double* v, int vs,
                                        const double* __restrict__ p4, int N) {
    const int lane = threadIdx.x & 31;
    const int gid = lane >> 2;
    const int tig = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[nt][i] = 0.0;
    for (int kk = 0; kk < N; ++kk) {  // the 4N rows of P4, 4 a k-step
        const int k = 4 * kk + tig;
        const int j = k / N;
        const int n = k - j * N;
        const double a0 = v[(4 * gid + j) * vs + n];
        const double a1 = v[(4 * gid + 32 + j) * vs + n];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            const int m = 8 * nt + gid;
            mma_f64(c[nt], a0, a1, m < N ? __ldg(p4 + k * N + m) : 0.0);
        }
    }
}

// row m of w (stride ws) <- the C fragments c of rows m = gid, gid + 8
template <int NT>
__device__ __forceinline__ void store_rows(double* w, int ws, const double (&c)[NT][4], int N) {
    const int lane = threadIdx.x & 31;
    const int gid = lane >> 2;
    const int tig = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
        const int n = 8 * nt + 2 * tig;
        if (n < N) {
            *reinterpret_cast<double2*>(w + gid * ws + n) = make_double2(c[nt][0], c[nt][1]);
            *reinterpret_cast<double2*>(w + (gid + 8) * ws + n) = make_double2(c[nt][2], c[nt][3]);
        }
    }
}

// The states inside the super-blocks: with s_{4m} in row m of w (stride
// ws) and v_k in row k of st (stride ss, lanes below N), row k of st <-
// s_k, the state entering block k, for all 64 k, in three steps s_{4m+j} =
// s_{4m+j-1} A + v_{4m+j-1} of the 16 super-blocks at once on the fp64
// tensor cores (A's B fragments through the read-only cache); w is
// overwritten.
template <int NT>
__device__ __forceinline__ void fill_states(double* st, int ss, double* w, int ws,
                                            const double* __restrict__ Ab, int N) {
    constexpr int KQ = 2 * NT;  // k-steps of 4 lanes: 8 NT >= N
    const int lane = threadIdx.x & 31;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    double bA[KQ][NT];  // A's B fragments, the same for the three steps
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            const int k = 4 * kk + tig;
            const int m = 8 * nt + gid;
            bA[kk][nt] = (k < N && m < N) ? __ldg(Ab + k * N + m) : 0.0;
        }
    for (int j = 1; j <= 3; ++j) {
        const int r0 = 4 * gid + j - 1;  // rows 4m + j - 1 for m = gid, gid + 8
        const int r1 = r0 + 32;
        double a0[KQ], a1[KQ];
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk) {
            const int n = 4 * kk + tig;
            a0[kk] = n < N ? w[gid * ws + n] : 0.0;
            a1[kk] = n < N ? w[(gid + 8) * ws + n] : 0.0;
        }
        double c[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            const int n = 8 * nt + 2 * tig;
            const bool live = n < N;
            c[nt][0] = live ? st[r0 * ss + n] : 0.0;
            c[nt][1] = live ? st[r0 * ss + n + 1] : 0.0;
            c[nt][2] = live ? st[r1 * ss + n] : 0.0;
            c[nt][3] = live ? st[r1 * ss + n + 1] : 0.0;
        }
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk) {
            if (4 * kk < N) {  // warp-uniform
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) mma_f64(c[nt], a0[kk], a1[kk], bA[kk][nt]);
            }
        }
        __syncwarp();  // every lane has read its rows of st and w
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk) {
            const int n = 4 * kk + tig;
            if (n < N) {
                st[r0 * ss + n] = a0[kk];
                st[r1 * ss + n] = a1[kk];
            }
        }
        store_rows<NT>(w, ws, c, N);
        if (j == 3) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                const int n = 8 * nt + 2 * tig;
                if (n < N) {
                    *reinterpret_cast<double2*>(st + (r0 + 1) * ss + n) =
                        make_double2(c[nt][0], c[nt][1]);
                    *reinterpret_cast<double2*>(st + (r1 + 1) * ss + n) =
                        make_double2(c[nt][2], c[nt][3]);
                }
            }
        }
        __syncwarp();
    }
}

// Walk steps [0, nv) of one band's state tile st (row k: v_k in lanes
// [0, N), row stride ss, even) from the state s of lane n < N, overwriting
// each v_k with the state entering step k; returns the state after the last
// step. Each step stores s to its row and reads the row back with
// broadcast loads, two lanes a load: a step of Ns = 16 costs nine shared-
// memory wavefronts where `chain_step`'s 16 fp64 shuffles cost 32 shuffle
// issues, and an SM issues one shuffle a clock. The v_k of the next 8 steps
// are loaded before the current ones are used; four partial sums.
template <int NN>
__device__ __forceinline__ double tile_walk(double s, double* st, int ss, int nv,
                                            const double (&a)[kMaxState], int N) {
    constexpr int kAhead = 8;
    const int lane = threadIdx.x & 31;
    const bool live = lane < N;
    const int ln = live ? lane : N - 1;  // idle lanes read a valid address
    const int last = nv - 1;
    double nxt[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) nxt[i] = st[(i < last ? i : last) * ss + ln];
    for (int k0 = 0; k0 < nv; k0 += kAhead) {
        double cur[kAhead];
#pragma unroll
        for (int i = 0; i < kAhead; ++i) {
            cur[i] = nxt[i];
            const int k = k0 + kAhead + i < last ? k0 + kAhead + i : last;
            nxt[i] = st[k * ss + ln];
        }
#pragma unroll
        for (int i = 0; i < kAhead; ++i) {
            if (k0 + i < nv) {  // warp-uniform
                double* row = st + (k0 + i) * ss;
                if (live) row[lane] = s;
                __syncwarp();
                double acc[4] = {cur[i], 0.0, 0.0, 0.0};
#pragma unroll
                for (int j = 0; j < loop_bound<NN>(); j += 2) {
                    if (NN == 0 && j >= N) break;
                    const double2 sj = *reinterpret_cast<const double2*>(row + j);
                    const int q = (j >> 1) & 1;
                    acc[2 * q] = fma(sj.x, a[j], acc[2 * q]);
                    acc[2 * q + 1] = fma(sj.y, a[j + 1], acc[2 * q + 1]);
                }
                s = (acc[0] + acc[1]) + (acc[2] + acc[3]);
            }
        }
    }
    return s;
}

// Pass 1 of the route. One block per full tile (r, t), t < KT - 1, x's
// span staged in shared memory. Warp w takes bands w, w + 4, ...: V = X M_b
// for the 64 blocks on the fp64 tensor cores into the warp's (64, Ns)
// slice, the injections of the 16 super-blocks of 4 blocks (`super_v`)
// into its first 16 rows, walked from zero with A^4 in 16 steps where the
// blocks take 64; the end state to carry[b R + r, t].
template <int NN, int NT>
__global__ void __launch_bounds__(kMmaThreads, 3)
chain_local_kernel(const float* __restrict__ x, const double* __restrict__ M,
                   const double* __restrict__ W, double* __restrict__ carry, TileShape ts) {
    constexpr int kVS = 8 * NT + 2;  // row stride (doubles) of a warp's slice
    extern __shared__ double2 smem6[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    double* vw = reinterpret_cast<double*>(smem6) + warp * kTileRows * kVS;   // (64, kVS)
    float* xs = reinterpret_cast<float*>(reinterpret_cast<double*>(smem6) +
                                         kMmaWarps * kTileRows * kVS);      // (64, kXR)
    const long long full = ts.KT - 1;
    const long long r = blockIdx.x / full;
    const long long t = blockIdx.x - r * full;
    const int L = ts.L;
    const int N = ts.N;
    const long long BN = (long long)ts.B * N;
    stage_x(x + r * ts.ldx + t * kTileRows * L, xs, L, kTileRows, kMmaThreads);
    cp_commit();
    cp_wait_all();
    __syncthreads();
    for (int b = warp; b < ts.B; b += kMmaWarps) {
        for (int c = 0; c < N; c += 16)
            tile_v<2>(xs, M + (long long)b * N, BN, L, c, 8, N, vw, kVS);
        __syncwarp();
        const double* wb = W + (long long)b * 6 * N * N;  // [A^3; A^2; A; I; A^4; A^64]
        double w4[NT][4];
        super_v<NT>(w4, vw, kVS, wb, N);
        __syncwarp();  // every lane has read V
        store_rows<NT>(vw, kVS, w4, N);
        double a[kMaxState];
        load_column<NN>(wb + 4 * N * N, N, a);
        __syncwarp();
        const double s = tile_walk<NN>(0.0, vw, kVS, 16, a, N);
        if (lane < N) carry[(((long long)b * ts.R + r) * ts.KT + t) * N + lane] = s;
        __syncwarp();  // the walk's reads are done before the next band's V
    }
}

// Pass 3 of the route. One block per tile (r, t), four warps (rows
// 16w..16w+15, as `bank_out_mma_kernel`), three blocks an SM at Ns <= 16.
// The bands go in groups of GB (as many as the shared-memory budget of
// three blocks holds, at most 4): each warp puts V = X M of the group's
// bands, its rows, into the group's state tile; warp g < GB walks band
// b0 + g in place from S_t = carry[b R + r, t], the walks of a group side
// by side (the last tile writes zf); then the group's planes. G has one
// stage, loaded while x h runs (`plane_xh`) and waited for before s G
// (`plane_sg`); h has two, a plane ahead.
template <int KS, int NN>
__global__ void __launch_bounds__(kMmaThreads, KS <= 4 ? 3 : 2)
bank_out_mma_kernel(const float* __restrict__ x, const float* __restrict__ h,
                    const double* __restrict__ G, const double* __restrict__ M,
                    const double* __restrict__ A, const double* __restrict__ W,
                    const double* __restrict__ carry,
                    float* __restrict__ y, double* __restrict__ zf, TileShape ts, int P, int GB,
                    long long ldy) {
    constexpr int NT = KS / 2;  // 8-lane tiles of a band's state: 8 NT >= Ns
    extern __shared__ double2 smem7[];
    const int N = ts.N;
    const int L = ts.L;
    const int B = ts.B;
    const int N4 = (N + 3) & ~3;
    const int SS = GB * N + 2;  // row stride (doubles) of the state tile
    double* Gs = reinterpret_cast<double*>(smem7);                  // (N4, kGR)
    double* st = Gs + (size_t)N4 * kGR;                             // (kTileRows, SS)
    long long* yoff = reinterpret_cast<long long*>(st + (size_t)kTileRows * SS);
    float* xs = reinterpret_cast<float*>(yoff + kTileRows);         // (kTileRows, kXR)
    float* hz = xs + kTileRows * kXR;                               // 2 stages of (kHZ)
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int gid = lane >> 2;
    const int tig = lane & 3;
    const long long r = blockIdx.x / ts.KT;
    const long long t = blockIdx.x - r * ts.KT;
    const long long k0 = t * kTileRows;
    const int nv = ts.K - k0 < kTileRows ? (int)(ts.K - k0) : kTileRows;  // blocks in the tile
    const long long BN = (long long)B * N;
    const int wr = 16 * warp;
    const int nT = (L + 7) >> 3;
    const int planes = B * P;
    for (int i = tid; i < kTileRows; i += kMmaThreads)
        yoff[i] = i < nv ? r * ldy + (k0 + i) * L : -1;
    stage_x(x + r * ts.ldx + k0 * L, xs, L, nv, kMmaThreads);
    queue_h(h, hz, 0, L);
    cp_commit();
    cp_wait_all();
    __syncthreads();  // x's tile, h of plane 0 and yoff are visible
    const long long off0 = yoff[wr + gid];
    const long long off1 = yoff[wr + gid + 8];
    int q = 0;  // planes run, in the order (b, p)
    for (int b0 = 0; b0 < B; b0 += GB) {
        const int gn = B - b0 < GB ? B - b0 : GB;  // bands in the group
        // V = X M of the group's bands: the 64 rows, warp w the lane tiles
        // w and w + 4 (at most 8: gn Ns <= 48) side by side, each B fragment
        // of M read once a block
        for (int c = 8 * warp; c < gn * N; c += 64) {
            if (c + 32 < gn * N)
                tile_v<2>(xs, M + (long long)b0 * N, BN, L, c, 32, gn * N, st, SS);
            else
                tile_v<1>(xs, M + (long long)b0 * N, BN, L, c, 32, gn * N, st, SS);
        }
        __syncthreads();  // the group's V is in place
        if (warp < gn) {
            // band b0 + warp: its super-blocks' injections into its rows of
            // Gs (free between planes), the 16 steps with A^4 from S_t, and
            // the states inside the super-blocks
            const int b = b0 + warp;
            double* sv = st + warp * N;
            double* wb = Gs + warp * 16 * (N + 2);
            const double* ops4 = W + (long long)b * 6 * N * N;  // [A^3; A^2; A; I; A^4; A^64]
            double w4[NT][4];
            super_v<NT>(w4, sv, SS, ops4, N);
            store_rows<NT>(wb, N + 2, w4, N);
            double a[kMaxState];
            load_column<NN>(ops4 + 4 * N * N, N, a);
            const long long w = (long long)b * ts.R + r;
            const double s0 = lane < N ? carry[(w * ts.KT + t) * N + lane] : 0.0;
            __syncwarp();
            const double s = tile_walk<NN>(s0, wb, N + 2, 16, a, N);
            __syncwarp();
            fill_states<NT>(sv, SS, wb, N + 2, A + (long long)b * N * N, N);
            // rows past the tile's nv blocks walked on from zero input: row
            // nv holds the state after block nv - 1
            if (t == ts.KT - 1 && lane < N) zf[w * N + lane] = nv < kTileRows ? sv[nv * SS + lane] : s;
        }
        __syncthreads();  // the group's states are in place
        for (int g = 0; g < gn; ++g) {
            const int b = b0 + g;
            // s's A fragments: sa[half][ks] = s[row wr + 8 half + gid][lane 4 ks + tig]
            double sa[2][KS];
#pragma unroll
            for (int half = 0; half < 2; ++half)
#pragma unroll
                for (int ks = 0; ks < KS; ++ks) {
                    const int n = 4 * ks + tig;
                    sa[half][ks] = n < N ? st[(wr + 8 * half + gid) * SS + g * N + n] : 0.0;
                }
            for (int p = 0; p < P; ++p, ++q) {
                const long long band = (long long)p * B + b;
                // G of plane q into its stage (every read of the last plane's
                // is done), h of plane q + 1 into the other h stage
                queue_g(G, Gs, band, L, N, N4);
                if (q + 1 < planes) {
                    const int b1 = (q + 1) / P;
                    queue_h(h, hz + ((q + 1) & 1) * kHZ, (long long)(q + 1 - b1 * P) * B + b1, L);
                }
                cp_commit();
                float acc[kTiles][4];
                plane_xh(acc, xs + wr * kXR + tig, hz + (q & 1) * kHZ, nT);
                cp_wait_all();
                __syncthreads();  // G of plane q and h of plane q + 1 are visible
                float* yb = y + band * ts.R * ldy;
                plane_sg<KS>(acc, sa, Gs, N4, L, off0 >= 0 ? yb + off0 : nullptr,
                             off1 >= 0 ? yb + off1 : nullptr);
                __syncthreads();  // Gs and h stage q & 1 are free
            }
        }
    }
}

}  // namespace tiles

// The opt-in shared-memory limit of each device, stored once every kernel
// here may use it (0: not yet). Setting the limit is idempotent, so two
// threads that race on a device's first call both succeed.
constexpr int kMaxDevices = 64;
std::atomic<int> g_smem_max[kMaxDevices];

cudaError_t device_setup(int* smem_max) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    int v = g_smem_max[device].load(std::memory_order_acquire);
    if (v == 0) {
        if ((err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
            cudaSuccess)
            return err;
        const void* kernels[] = {
            reinterpret_cast<const void*>(&bank_inject_kernel),
            reinterpret_cast<const void*>(&bank_inject_mma_kernel<1>),
            reinterpret_cast<const void*>(&bank_inject_mma_kernel<2>),
            reinterpret_cast<const void*>(&bank_inject_mma_kernel<4>),
            reinterpret_cast<const void*>(&bank_inject_mma_kernel<8>),
            reinterpret_cast<const void*>(&bank_out_mma_kernel<4>),
            reinterpret_cast<const void*>(&bank_out_mma_kernel<8>),
            reinterpret_cast<const void*>(&bank_out_kernel),
            reinterpret_cast<const void*>(&tiles::chain_local_kernel<8, 2>),
            reinterpret_cast<const void*>(&tiles::chain_local_kernel<12, 2>),
            reinterpret_cast<const void*>(&tiles::chain_local_kernel<16, 2>),
            reinterpret_cast<const void*>(&tiles::chain_local_kernel<0, 4>),
            reinterpret_cast<const void*>(&tiles::bank_out_mma_kernel<4, 8>),
            reinterpret_cast<const void*>(&tiles::bank_out_mma_kernel<4, 12>),
            reinterpret_cast<const void*>(&tiles::bank_out_mma_kernel<4, 16>),
            reinterpret_cast<const void*>(&tiles::bank_out_mma_kernel<8, 0>),
        };
        for (const void* k : kernels)
            if ((err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, v)) !=
                cudaSuccess)
                return err;
        g_smem_max[device].store(v, std::memory_order_release);
    }
    *smem_max = v;
    return cudaSuccess;
}

// Pass 1: the FFMA pass at 64 band-lanes and more, else the fp64 tensor
// cores with the fewest 8-lane tiles that cover BN
cudaError_t launch_inject(const float* x, const double* M, double* vs, long long RK, long long K,
                          int L, int BN, long long ldx, unsigned tiles, int smem_max,
                          cudaStream_t st) {
    if (BN >= kLaneChunk) {
        const size_t smem = sizeof(double) * kLChunk * kLaneChunk +
                            sizeof(long long) * kTileRows + sizeof(float) * kLChunk * kXS;
        bank_inject_kernel<<<tiles, kThreads, smem, st>>>(x, M, vs, RK, K, L, BN, ldx);
        return cudaGetLastError();
    }
    const int nt = BN <= 8 ? 1 : BN <= 16 ? 2 : BN <= 32 ? 4 : 8;
    const size_t smem = sizeof(double) * kLChunk * (8 * nt + 4) +
                        sizeof(long long) * kTileRows + sizeof(float) * kTileRows * kXR;
    if (smem > (size_t)smem_max) return cudaErrorInvalidValue;
    auto kernel = nt == 1 ? bank_inject_mma_kernel<1>
                  : nt == 2 ? bank_inject_mma_kernel<2>
                  : nt == 4 ? bank_inject_mma_kernel<4>
                            : bank_inject_mma_kernel<8>;
    kernel<<<tiles, kMmaThreads, smem, st>>>(x, M, vs, RK, K, L, BN, ldx);
    return cudaGetLastError();
}
// The wide banks' route (NN: the walks' compile-time state size, 0 for
// any; NT: V's 8-lane tiles, 8 NT >= Ns): tile states, carry, output
template <int NN, int NT>
cudaError_t launch_tiles(const float* x, const float* h, const double* M, const double* A,
                         const double* G, const double* s0, float* y, double* carry, double* zf,
                         const double* W, const tiles::TileShape& ts, int P, long long ldy,
                         int smem_max, cudaStream_t st) {
    const int N = ts.N;
    const size_t smem1 = sizeof(double) * kMmaWarps * kTileRows * (8 * NT + 2) +
                         sizeof(float) * kTileRows * kXR;
    // bands a group of the output pass: the most (up to its 4 warps) whose
    // state tile leaves three blocks an SM (228 KB an SM on the H100, 1 KB
    // of it reserved a block), else 1
    const size_t base3 = sizeof(double) * (size_t)((N + 3) & ~3) * kGR +
                         sizeof(long long) * kTileRows +
                         sizeof(float) * ((size_t)kTileRows * kXR + 2 * kHZ);
    auto smem_of = [&](int gb) { return base3 + sizeof(double) * kTileRows * (gb * N + 2); };
    int GB = ts.B < kMmaWarps ? ts.B : kMmaWarps;
    while (GB > 1 && smem_of(GB) > kSmemThird) --GB;
    const size_t smem3 = smem_of(GB);
    if (smem1 > (size_t)smem_max || smem3 > (size_t)smem_max) return cudaErrorInvalidValue;
    cudaError_t err;
    if (ts.KT > 1) {
        tiles::chain_local_kernel<NN, NT>
            <<<(unsigned)(ts.R * (ts.KT - 1)), kMmaThreads, smem1, st>>>(x, M, W, carry, ts);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    constexpr int kWarps = 4;  // warps per block of the carry
    const ChainShape cs{(long long)ts.B * ts.R, ts.R, ts.K, ts.B * N, N, kTileRows, (int)ts.KT};
    chain_carry_kernel<NN><<<(unsigned)((cs.W + kWarps - 1) / kWarps), 32 * kWarps, 0, st>>>(
        A, s0, carry, cs, W + 5 * N * N, 6LL * N * N);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    tiles::bank_out_mma_kernel<2 * NT, NN>
        <<<(unsigned)(ts.R * ts.KT), kMmaThreads, smem3, st>>>(x, h, G, M, A, W, carry, y, zf,
                                                               ts, P, GB, ldy);
    return cudaGetLastError();
}
}  // namespace

// x (R rows of stride ldx; the first K*L samples of each are filtered), fp32;
// h (P, B, L) fp32; M (L, B*Ns), A (B, Ns, Ns), G (P, B, Ns, L) fp64, the
// operators' real form; s0 (B, R, Ns) fp64, the state before block 0, or
// null for zero -> y (P, B, R rows of stride ldy), columns [0, K*L) written,
// fp32; zf (B, R, Ns) fp64, the state after block K. W (B, 6 Ns, Ns) fp64 =
// [A^3; A^2; A; I; A^4; A^64] per band, or null, picks the route: given
// (L <= 128), the wide banks' route, which reads no vs (it may be null) and
// chains over tiles of 64 blocks, F ignored; null, the three passes with
// chunks of F blocks. Scratch, fp64: vs (R*K, B*Ns) and carry (B*R,
// ceil(K/F), Ns), F = 64 on the wide route. Ns <= 32 and even; all on one
// device. The lead is B = P = 1 with its batch as the rows. Returns the
// first CUDA error code met (0 on success).
extern "C" int dsptb_iir_bank_f32(const float* x, const float* h, const double* M,
                                  const double* A, const double* G, const double* s0, float* y,
                                  double* vs, double* carry, double* zf, const double* W, int B,
                                  long long R, long long K, int L, int Ns, int P, int F,
                                  long long ldx, long long ldy, void* stream) {
    if (W != nullptr) F = kTileRows;
    if (B <= 0 || R <= 0 || K <= 0 || L <= 0 || Ns <= 0 || Ns > kMaxState || (Ns & 1) ||
        P < 1 || P > 2 || F <= 0 || ldx < K * L || ldy < K * L ||
        (W != nullptr && L > kColTile))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const long long RK = R * K;
    const long long tiles = (RK + kTileRows - 1) / kTileRows;
    const long long nc = (K + F - 1) / F;
    if (tiles > 2147483647LL || (long long)B * R * nc > 2147483647LL / 32)
        return (int)cudaErrorInvalidValue;

    int smem_max = 0;
    cudaError_t err;
    if ((err = device_setup(&smem_max)) != cudaSuccess) return (int)err;

    if (W != nullptr) {
        if (R * nc > 2147483647LL) return (int)cudaErrorInvalidValue;
        const tiles::TileShape ts{R, K, nc, L, B, Ns, ldx};
        switch (Ns) {
            case 8: err = launch_tiles<8, 2>(x, h, M, A, G, s0, y, carry, zf, W, ts, P, ldy,
                                               smem_max, st); break;
            case 12: err = launch_tiles<12, 2>(x, h, M, A, G, s0, y, carry, zf, W, ts, P, ldy,
                                               smem_max, st); break;
            case 16: err = launch_tiles<16, 2>(x, h, M, A, G, s0, y, carry, zf, W, ts, P, ldy,
                                               smem_max, st); break;
            default: err = launch_tiles<0, 4>(x, h, M, A, G, s0, y, carry, zf, W, ts, P, ldy,
                                               smem_max, st); break;
        }
        return (int)err;
    }

    // pass 1
    if ((err = launch_inject(x, M, vs, RK, K, L, B * Ns, ldx, (unsigned)tiles, smem_max, st)) !=
        cudaSuccess)
        return (int)err;

    // pass 2: Ns = 2 * sections (real) or 4 * sections (complex); the
    // sizes of the filter-bank path's banks and the chain's bands get a
    // compile-time state size
    const ChainShape cs{(long long)B * R, R, K, B * Ns, Ns, F, (int)nc};
    switch (Ns) {
        case 4: err = launch_chain<4>(A, s0, vs, carry, zf, cs, st); break;
        case 8: err = launch_chain<8>(A, s0, vs, carry, zf, cs, st); break;
        case 12: err = launch_chain<12>(A, s0, vs, carry, zf, cs, st); break;
        case 16: err = launch_chain<16>(A, s0, vs, carry, zf, cs, st); break;
        default: err = launch_chain<0>(A, s0, vs, carry, zf, cs, st); break;
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
    bank_out_kernel<<<dim3((unsigned)tiles, (unsigned)n_col), kThreads, smem3, st>>>(
        x, h, G, vs, y, B, R, K, L, Ns, P, ldx, ldy);
    return (int)cudaGetLastError();
}
