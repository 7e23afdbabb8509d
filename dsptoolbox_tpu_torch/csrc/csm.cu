// The Welch cross-spectral matrix's Gram product for Hopper (sm_90a), read
// from the rFFT's (C, K, F) layout where it lies:
//
//   Q[f, a, b] = (1/K) sum_k conj(X[a, k, f]) X[b, k, f]     X complex64 (C, K, F)
//
// with an exactly real diagonal and Q[f, b, a] = conj(Q[f, a, b]).
//
// Replaces no Pallas kernel: the JAX package leaves this step to XLA
// (`jnp.einsum("akf,bkf->fab", ...)`, dsptoolbox_tpu/ops/spectral.py:285).
// Before it the port copied X into (F, C, K) for cuBLAS, which reads and
// writes X once more than the product needs, and took both triangles.
//
// Bound on the H100: X's bytes and the upper triangle's fp32 FFMA work, of
// one order. At the session's (32, 5624, 513) X is 738.6 MB (0.22 ms at 3.35
// TB/s) and its 528 pairs take 12.2 GFLOP (0.18 ms at 67 TFLOP/s); at the
// camera's (64, 936, 513) 245.8 MB (0.073 ms) and 8.0 GFLOP (0.12 ms).
//
// Design (csm_gram_kernel):
//   - channels in tiles of 8, tiles in super-tiles of 4 (32 channels). A
//     block's group is a super-tile with itself (its 6 off-diagonal tile
//     pairs, and 2 warps of two diagonal tiles each, upper triangles only)
//     or one half (16 channels) of a super-tile against a later one (2 x 4
//     tile pairs): 8 warps, each 256 FFMA a frame, two a scheduler;
//   - a warp's lanes are 32 consecutive bins (a warp's loads are 256
//     contiguous bytes): each lane keeps its 64 or 72 pair sums in
//     registers and reads 16 channel values a frame from shared memory;
//   - the block stages the slab X[its 32 or 48 channels, 4 frames, 32 bins]
//     with 8-byte cp.async copies (F odd leaves rows on 8 bytes), three
//     stages deep, zero-filled outside X: device memory is read once per
//     group;
//   - teams of nG blocks (one block per group, launched side by side so
//     that their reads of one slab meet in L2), as many as fill the SMs in
//     one wave, share the (f-block, frame) plane in equal runs: most take
//     frames [s L, s L + L) of one f-block, all f-blocks' runs starting
//     together, so that the f-blocks' 256-byte pieces of a row of X are
//     read at about the same time (on an H100 that raised the loads' rate
//     from 2.0 to 2.3 TB/s); the rest split the last K - S L frames of
//     every f-block;
//   - each part of a team's run (one f-block's frames) leaves its sums in a
//     scratch slot of its own, and csm_reduce_kernel adds each bin's slots
//     in frame order, divides by K, sets the diagonal real and mirrors the
//     upper triangle. No atomics: a call repeats bit for bit.
// The loads alone and the FFMA work alone each take about two thirds of the
// kernel's time on an H100 (700 W); they overlap in part.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;     // a block: one group's 8 warp tasks
constexpr int kThreads = 32 * kWarps;
constexpr int kKC = 4;        // frames a stage
constexpr int kStages = 3;
constexpr int kSuper = 32;    // channels a super-tile (4 tiles of 8)
constexpr int kLocal = 72;    // sums a warp keeps: 8 x 8 pairs, or two tiles' 36
constexpr int kMaxRows = 48;  // staged channels of a group: 32, or 16 + 32
constexpr int kReduceThreads = 128;
static_assert(kWarps % kKC == 0, "a thread stages one frame of each of its rows");

constexpr int smem_bytes(int rows) { return kStages * rows * kKC * 32 * 8; }

// Teams: the first nFB * S take frames [s L, s L + L) of one f-block each
// (team fb * S + s); the other Trem share the last R = K - S L frames of
// every f-block as equal runs of the units (fb, k), fb-major.
struct Plan {
    long long C, K, F;
    long long L, R;
    int nFB, nS, nG, S, Trem;
};

// the index of pair (i, j), i <= j < 8, in a tile's upper triangle
__host__ __device__ constexpr int tri(int i, int j) { return 8 * i - i * (i - 1) / 2 + (j - i); }

// group g of nS super-tiles: staged rows [0, na) are channels a0 ..,
// [na, na + nb) channels b0 ..; g < nS is super-tile g with itself (nb 0),
// the rest the halves h of each pair I < J, in row order
struct Group {
    int a0, na, b0, nb;
};

__device__ __forceinline__ Group group_of(int g, int nS) {
    if (g < nS) return {g * kSuper, kSuper, 0, 0};
    int p = (g - nS) >> 1, I = 0;
    const int h = (g - nS) & 1;
    while (p >= nS - 1 - I) {
        p -= nS - 1 - I;
        ++I;
    }
    return {I * kSuper + 16 * h, 16, (I + 1 + p) * kSuper, kSuper};
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 8-byte async copy, zero-filled when !valid (src then only needs to be a
// valid address)
__device__ __forceinline__ void cp8(float2* dst, const float2* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// q += conj(a) b
__device__ __forceinline__ void cmac(float2& q, float2 a, float2 b) {
    q.x = fmaf(a.x, b.x, q.x);
    q.x = fmaf(a.y, b.y, q.x);
    q.y = fmaf(a.x, b.y, q.y);
    q.y = fmaf(-a.y, b.x, q.y);
}

// one stage of an off-diagonal tile pair: sa, sb the tiles' first staged
// rows at this lane; acc[8 i + j] += conj(x_{a+i}) x_{b+j}
__device__ __forceinline__ void gram_off(float2 (&acc)[kLocal], const float2* sa,
                                         const float2* sb) {
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
        float2 a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            a[i] = sa[(i * kKC + kk) * 32];
            b[i] = sb[(i * kKC + kk) * 32];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) cmac(acc[i * 8 + j], a[i], b[j]);
    }
}

// one frame of a diagonal tile's upper triangle into acc[O + tri(i, j)];
// the diagonal's real part only (its imaginary part is 0)
template <int O>
__device__ __forceinline__ void gram_tri(float2 (&acc)[kLocal], const float2* s, int kk) {
    float2 x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = s[(i * kKC + kk) * 32];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        acc[O + tri(i, i)].x = fmaf(x[i].x, x[i].x, acc[O + tri(i, i)].x);
        acc[O + tri(i, i)].x = fmaf(x[i].y, x[i].y, acc[O + tri(i, i)].x);
#pragma unroll
        for (int j = i + 1; j < 8; ++j) cmac(acc[O + tri(i, j)], x[i], x[j]);
    }
}

// one stage of two diagonal tiles (staged rows from sa and sb)
__device__ __forceinline__ void gram_diag(float2 (&acc)[kLocal], const float2* sa,
                                          const float2* sb) {
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
        gram_tri<0>(acc, sa, kk);
        gram_tri<36>(acc, sb, kk);
    }
}

// Block: group g of team `team`. Warp w's tiles (staged rows ra, rb): in a
// self group w < 6 the off-diagonal pairs (0,1) (0,2) (0,3) (1,2) (1,3)
// (2,3), w = 6 the diagonal tiles 0 and 1, w = 7 tiles 2 and 3; in a pair
// group tile w / 4 of the first half against tile w % 4 of the second. The
// sums of each part of the team's run go to its `slot` of `part`:
// part[slot][g][w][local][lane] (an aligned team's slot is the team, a
// remainder team r's part on f-block fb is slot nFB S + r + fb).
__global__ void __launch_bounds__(kThreads, 1)
csm_gram_kernel(const float2* __restrict__ X, float2* __restrict__ part, Plan p) {
    extern __shared__ __align__(16) float2 slab[];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int team = blockIdx.x / p.nG, g = blockIdx.x % p.nG;
    const Group gr = group_of(g, p.nS);
    const int rows = gr.na + gr.nb;
    const int stage = rows * kKC * 32;  // float2 a stage
    int ra, rb;
    bool diag = false;
    if (gr.nb != 0) {
        ra = 8 * (w >> 2);
        rb = 16 + 8 * (w & 3);
    } else if (w < 6) {
        const int u = w < 3 ? 0 : (w < 5 ? 1 : 2);
        ra = 8 * u;
        rb = 8 * (w < 3 ? w + 1 : (w < 5 ? w - 1 : 3));
    } else {
        ra = 16 * (w - 6);
        rb = ra + 8;
        diag = true;
    }
    auto chan = [&](int r) { return r < gr.na ? gr.a0 + r : gr.b0 + (r - gr.na); };
    const bool active = chan(ra) < p.C && (diag || chan(rb) < p.C);

    // this thread stages frame kk of rows r0, r0 + kRowStep, ... (row-frame
    // pairs w, w + kWarps, ... of the stage)
    const int kk = w % kKC, r0 = w / kKC;
    constexpr int kRowStep = kWarps / kKC;
    const long long KF = p.K * p.F;
    const int aligned = p.nFB * p.S;
    const long long Urem = (long long)p.nFB * p.R;
    long long u, hi;  // the team's run of units
    if (team < aligned) {
        u = (long long)(team / p.S) * p.K + (team % p.S) * p.L;
        hi = u + p.L;
    } else {
        u = (long long)(team - aligned) * Urem / p.Trem;
        hi = (long long)(team - aligned + 1) * Urem / p.Trem;
    }
    float2 acc[kLocal];
    while (u < hi) {
        int fb;
        long long k0, k1, slot;
        if (team < aligned) {
            fb = team / p.S;
            k0 = u - (long long)fb * p.K;
            k1 = k0 + p.L;
            u = hi;
            slot = team;
        } else {
            fb = (int)(u / p.R);
            k0 = p.S * p.L + u % p.R;
            k1 = k0 + (hi - u) < p.S * p.L + p.R ? k0 + (hi - u) : p.S * p.L + p.R;
            u += k1 - k0;
            slot = aligned + (team - aligned) + fb;
        }
        const long long f = (long long)fb * 32 + lane;
        const bool fin = f < p.F;
        const int chunks = (int)((k1 - k0 + kKC - 1) / kKC);
        auto load = [&](int c) {
            if (c < chunks) {
                float2* dst = slab + (c % kStages) * stage + (r0 * kKC + kk) * 32 + lane;
                const long long k = k0 + (long long)c * kKC + kk;
                const bool kin = fin && k < k1;
                const float2* src = X + k * p.F + f;
#pragma unroll 4
                for (int n = 0; n < rows / kRowStep; ++n) {
                    const int ch = chan(r0 + kRowStep * n);
                    const bool ok = kin && ch < p.C;
                    cp8(dst + n * kRowStep * kKC * 32, ok ? src + ch * KF : X, ok);
                }
            }
            cp_commit();  // an empty group past the end keeps the count
        };
#pragma unroll
        for (int i = 0; i < kLocal; ++i) acc[i] = make_float2(0.f, 0.f);
#pragma unroll
        for (int c = 0; c < kStages - 1; ++c) load(c);
        for (int c = 0; c < chunks; ++c) {
            cp_wait<kStages - 2>();  // chunk c has landed (this thread's copies)
            __syncthreads();         // everyone's copies; stage c - 1 is free
            load(c + kStages - 1);
            if (active) {
                const float2* s = slab + (c % kStages) * stage + lane;
                if (diag)
                    gram_diag(acc, s + ra * kKC * 32, s + rb * kKC * 32);
                else
                    gram_off(acc, s + ra * kKC * 32, s + rb * kKC * 32);
            }
        }
        cp_wait<0>();
        __syncthreads();  // the next part's first loads overwrite stages 0, 1
        float2* out = part + ((slot * p.nG + g) * kWarps + w) * kLocal * 32 + lane;
#pragma unroll
        for (int i = 0; i < kLocal; ++i) out[i * 32] = acc[i];
    }
}

// the remainder team (0 ..) whose run holds remainder unit x: runs start at
// floor(r Urem / Trem)
__device__ __forceinline__ int rem_team_of(long long x, long long Urem, const Plan& p) {
    return (int)(((x + 1) * p.Trem - 1) / Urem);
}

// where csm_gram_kernel keeps pair a <= b: group g, warp w, sum `local`
__device__ __forceinline__ void locate(int a, int b, int nS, int& g, int& w, int& local) {
    const int I = a / kSuper, J = b / kSuper, ia = a % kSuper, ib = b % kSuper;
    if (I == J) {
        g = I;
        const int u = ia >> 3, v = ib >> 3;
        if (u == v) {
            w = 6 + (u >> 1);
            local = (u & 1) * 36 + tri(ia & 7, ib & 7);
        } else {
            w = u == 0 ? v - 1 : (u == 1 ? v + 1 : 5);
            local = (ia & 7) * 8 + (ib & 7);
        }
        return;
    }
    int q = J - I - 1;
    for (int i = 0; i < I; ++i) q += nS - 1 - i;
    g = nS + 2 * q + (ia >> 4);
    w = ((ia >> 3) & 1) * 4 + (ib >> 3);
    local = (ia & 7) * 8 + (ib & 7);
}

// Thread: bin f (x), pairs q = b (b + 1) / 2 + a, a <= b (y, strided by the
// grid): the slots of the teams that ran f's f-block, added in frame order,
// divided by K; Q[f, a, b] and its mirror Q[f, b, a] = conj.
__global__ void __launch_bounds__(kReduceThreads)
csm_reduce_kernel(const float2* __restrict__ part, float2* __restrict__ Q, Plan p) {
    const long long f = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
    if (f >= p.F) return;
    const int fb = (int)(f >> 5), lane = (int)(f & 31);
    const int aligned = p.nFB * p.S;
    const long long Urem = (long long)p.nFB * p.R;
    const int r0 = p.R > 0 ? rem_team_of((long long)fb * p.R, Urem, p) : 0;
    const int r1 = p.R > 0 ? rem_team_of((long long)fb * p.R + p.R - 1, Urem, p) : -1;
    const long long pairs = p.C * (p.C + 1) / 2;
    const float K = (float)p.K;
    float2* row = Q + f * p.C * p.C;
    for (long long q = blockIdx.y; q < pairs; q += gridDim.y) {
        long long b = (long long)((sqrt(8.0 * (double)q + 1.0) - 1.0) * 0.5);
        while (b * (b + 1) / 2 > q) --b;
        while ((b + 1) * (b + 2) / 2 <= q) ++b;
        const long long a = q - b * (b + 1) / 2;
        int g, w, local;
        locate((int)a, (int)b, p.nS, g, w, local);
        float2 s = make_float2(0.f, 0.f);
        auto add = [&](long long slot) {
            const float2 v = part[(((slot * p.nG + g) * kWarps + w) * kLocal + local) * 32 + lane];
            s.x += v.x;
            s.y += v.y;
        };
        for (int t = fb * p.S; t < (fb + 1) * p.S; ++t) add(t);
        for (int r = r0; r <= r1; ++r) add(aligned + r + fb);
        if (a == b) {
            row[a * p.C + a] = make_float2(s.x / K, 0.f);
        } else {
            row[a * p.C + b] = make_float2(s.x / K, s.y / K);
            row[b * p.C + a] = make_float2(s.x / K, -s.y / K);
        }
    }
}

// the plan of `teams` teams (1 .. nFB K): runs of L = ceil(nFB K / teams)
// frames, S of them in each f-block from its start; the remaining teams
// share the last R frames of every f-block
Plan make_plan(long long C, long long K, long long F, long long teams) {
    Plan p;
    p.C = C;
    p.K = K;
    p.F = F;
    p.nFB = (int)((F + 31) / 32);
    const long long nT = (C + 7) / 8;
    p.nS = (int)((nT + 3) / 4);
    p.nG = p.nS * p.nS;
    const long long U = (long long)p.nFB * K;
    p.L = (U + teams - 1) / teams;
    p.S = (int)(K / p.L);
    p.R = K - p.S * p.L;
    const long long rest = teams - (long long)p.nFB * p.S, Urem = (long long)p.nFB * p.R;
    p.Trem = p.R == 0 ? 0 : (int)(rest < Urem ? rest : Urem);
    return p;
}

long long teams_of(const Plan& p) { return (long long)p.nFB * p.S + p.Trem; }

long long slots_of(const Plan& p) {
    return (long long)p.nFB * p.S + (p.Trem > 0 ? p.Trem + p.nFB - 1 : 0);
}

bool shape_ok(long long C, long long K, long long F) {
    // the reduce pass's pair decode (sqrt in double) and 32-bit channel
    // and grid indices
    return C > 0 && K > 0 && F > 0 && C <= 46340 && (F + 31) / 32 <= 2147483647LL;
}

}  // namespace

// The launch plan of a (C, K, F) product on the current device: out[0] the
// teams (SMs x csm_gram_kernel blocks an SM / blocks a team, at least 1, at
// most the (f-block, frame) units), out[1] the scratch `part` in complex64
// values. Returns the CUDA error code (0 on success).
extern "C" int dsptb_csm_plan(long long C, long long K, long long F, long long* out) {
    if (!shape_ok(C, K, F)) return (int)cudaErrorInvalidValue;
    Plan p = make_plan(C, K, F, 1);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(csm_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes(kMaxRows));
    const int smem = smem_bytes(p.nS > 1 ? kMaxRows : kSuper);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, csm_gram_kernel, kThreads,
                                                            smem);
    if (err != cudaSuccess) return (int)err;
    long long teams = (long long)sms * per_sm / p.nG;
    const long long U = (long long)p.nFB * K;
    teams = teams < 1 ? 1 : (teams > U ? U : teams);
    p = make_plan(C, K, F, teams);
    out[0] = teams;
    out[1] = slots_of(p) * p.nG * kWarps * kLocal * 32;
    return 0;
}

// X (C, K, F) complex64, contiguous, on 8 bytes; Q (F, C, C) complex64,
// contiguous; part the scratch of `part_size` complex64 values and
// `teams` the teams, both from dsptb_csm_plan. Launches the Gram pass and
// the reduce pass on `stream`. Returns the CUDA error code of the launches
// (0 on success).
extern "C" int dsptb_csm_gram_c64(const float2* X, float2* Q, float2* part, long long C,
                                  long long K, long long F, long long teams,
                                  long long part_size, void* stream) {
    if (!shape_ok(C, K, F) || teams < 1 || teams > (F + 31) / 32 * K ||
        reinterpret_cast<uintptr_t>(X) % 8 != 0)
        return (int)cudaErrorInvalidValue;
    const Plan p = make_plan(C, K, F, teams);
    const long long blocks = teams_of(p) * p.nG;
    if (slots_of(p) * p.nG * kWarps * kLocal * 32 > part_size || blocks > 2147483647LL)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int smem = smem_bytes(p.nS > 1 ? kMaxRows : kSuper);
    csm_gram_kernel<<<(unsigned)blocks, kThreads, smem, st>>>(X, part, p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long pairs = C * (C + 1) / 2;
    const dim3 grid((unsigned)((F + kReduceThreads - 1) / kReduceThreads),
                    (unsigned)(pairs < 65535 ? pairs : 65535));
    csm_reduce_kernel<<<grid, kReduceThreads, 0, st>>>(part, Q, p);
    return (int)cudaGetLastError();
}
