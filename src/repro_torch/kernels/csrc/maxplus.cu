// Tropical (max, +) matrix product for Hopper (sm_90a):
// out[i, j] = max(NEG_INF, max_k a[i, k] + b[k, j]), all float32.
//
// Replaces the Pallas TPU kernel `repro/kernels/maxplus.py:40 maxplus`
// (body `_maxplus_kernel`), which ran on the TPU's vector unit because the
// MXU has no (max, +) semiring.  Hopper's tensor cores have none either, so
// this is a CUDA-core kernel.  Hopper's DPX instructions (`__viaddmax_s32`
// and its kin) fuse an add and a max, but on integers only: a float32 sum
// rounded once cannot be had from them, and mapping floats to ordered
// integers costs the instruction they would save.  So every candidate is
// one `__fadd_rn` and one `fmaxf`.
//
// What bounds it.  `ops.longest_paths` squares the 801 x 801 weight matrix
// of megatron-462b 5 times.  One product is m k n = 514 M float32 adds and
// as many maxes, two instructions that do not fuse: ~31 us at the card's
// ~33.5 T float32 instructions/s (the 67 TFLOP/s peak counts an FMA as
// two), against ~2 us for its 7.7 MB in and out at 3.35 TB/s.  So it is
// bound by operations: the design keeps the issue slots busy with sums and
// maxes and spreads them evenly over every SM.
//
// Design.
//   Tiles.  The result is cut into 128 x 128 tiles and k into chunks of 16.
//   A work unit is one (tile, k-chunk) pair; a tile's units are
//   consecutive, so the units are numbered tile by tile.  Out-of-range rows,
//   columns and k load as NEG_INF (NEG_INF + x never beats the NEG_INF the
//   maxima start from).
//   Schedule (stream-K).  A persistent grid of `blocks` blocks (one per SM,
//   set by the caller) takes the units in equal contiguous ranges: block g
//   owns units [g U / G, (g + 1) U / G).  At 801^3 that is 2,499 units
//   (49 tiles x 51 chunks) on 132 blocks, 18 or 19 each, where a grid of one
//   block per tile would leave 83 of 132 SMs idle.  A range may end inside
//   a tile and start the next one: each piece of a tile that a block owns is
//   a partial maximum, written whole to the workspace `ws`.
//   Combine.  A second small kernel takes, for each entry of the result, the
//   fmaxf of the partials that the blocks owning its tile wrote.  Every
//   candidate a + b is rounded once and a max does not depend on order, so
//   the split changes no bit; no atomics are used.
//   Pipeline.  Each block keeps three stages of (a tile of a transposed,
//   a tile of b) in shared memory (49,920 bytes) and loads unit u + 2 with
//   `cp.async` while it computes unit u, one barrier per unit.  The copies
//   are 4 bytes each: a row of 801 floats (3,204 bytes) is not 16-byte
//   aligned, so a 16-byte copy or a TMA tensor map would refuse it, and a
//   4-byte copy can also transpose a into a_s[k][r].  A warp copies 4 rows
//   x 8 k of a, so its global reads are four full 32-byte sectors and its
//   shared writes (row stride 132 words) land on 32 distinct banks.  The
//   copies are 16 per thread and unit, against 1,024 sums and 1,024 maxes.
//   An entry out of range is not copied (a copy of source size 0 would
//   write 0.0, and 0 + 0 beats every "no path"): the thread stores NEG_INF.
//   Compute.  256 threads, each an 8 x 8 register block of the tile: rows
//   4 ty + r and 64 + 4 ty + r, columns 4 tx + c and 64 + 4 tx + c.  For
//   each k a thread reads its 8 a values and 8 b values with four 16-byte
//   shared loads (one per 16 candidates; the a loads are broadcasts, the b
//   loads cover 256 consecutive bytes, no bank conflicts).
//   What limits it (measured on the H100 by kernel_variants.py, PERF.md):
//   the hot loop holds only the adds, the maxes and the shared loads; the
//   maxes (FMNMX) run on a pipe of half the adds' rate, but turning them
//   into adds saves only 5%; with no loads the loop takes 83% of the
//   kernel's time, and that at ~74% of the issue bound of its padded
//   work.  Latency and the per-unit barrier, not a pipe, bound it.
// Every sum is `__fadd_rn` (never contracted) and every max `fmaxf`, from
// NEG_INF: the result is bit-identical to the plain version and run to run.

#include <cuda_runtime.h>
#include <stdint.h>


namespace {

constexpr float kNegInf = -1e30f;   // repro_torch.kernels.ref.NEG_INF
constexpr int kBM = 128;            // tile rows
constexpr int kTN = 8;              // columns per thread
constexpr int kBN = 16 * kTN;       // tile columns
constexpr int kBK = 16;             // k per work unit
constexpr int kThreads = 256;       // 16 x 16 threads
constexpr int kStages = 3;
constexpr int kAStride = kBM + 4;   // a_s row stride: conflict-free writes

struct Stage {
    float a[kBK][kAStride];         // a tile, transposed: a[k][row]
    float b[kBK][kBN];
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_stages() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2) : "memory");
}

// first unit of block g: g U / G (so every block owns at least one unit
// when G <= U)
__device__ __forceinline__ int unit_start(int g, int units, int blocks) {
    return static_cast<int>(static_cast<long long>(g) * units / blocks);
}

// A place in the unit order: tile (tm, tn), k-chunk c.  Stepping it costs
// no division.
struct Cursor {
    int tm, tn, c;
    __device__ __forceinline__ void next(int kc, int tiles_n) {
        if (++c == kc) {
            c = 0;
            if (++tn == tiles_n) {
                tn = 0;
                ++tm;
            }
        }
    }
};

// Load the unit at `q` into stage s.  Thread t copies a rows
// row0 + t / 8 + 32 j (j < 4) at k = k0 + t % 8 + 8 h (h < 2): a warp takes
// 4 rows x 8 k; and b rows k0 + t / 64 + 4 j at column col0 + t % 64.
__device__ __forceinline__ void load_unit(
        Stage& s, const float* __restrict__ a, const float* __restrict__ b,
        const Cursor& q, int M, int K, int N) {
    const int k0 = q.c * kBK;
    const int ar = threadIdx.x / 8, ak = threadIdx.x % 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int r = ar + 32 * j;
        const int gi = q.tm * kBM + r;
        const float* src = a + static_cast<long long>(gi) * K + k0 + ak;
#pragma unroll
        for (int h = 0; h < kBK / 8; ++h) {
            const int k = ak + 8 * h;
            if (gi < M && k0 + k < K) {
                cp_async4(&s.a[k][r], src + 8 * h);
            } else {
                s.a[k][r] = kNegInf;
            }
        }
    }
    const int bc = threadIdx.x % kBN, bk = threadIdx.x / kBN;
    const int gj = q.tn * kBN + bc;
#pragma unroll
    for (int j = 0; j < kBK * kBN / kThreads; ++j) {
        const int k = bk + (kThreads / kBN) * j;
        if (k0 + k < K && gj < N) {
            cp_async4(&s.b[k][bc],
                      b + static_cast<long long>(k0 + k) * N + gj);
        } else {
            s.b[k][bc] = kNegInf;
        }
    }
}

__global__ void __launch_bounds__(kThreads, 1)
maxplus_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ ws, int M, int K, int N, int kc,
               int tiles_n, int units, int max_seg) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Stage* st = reinterpret_cast<Stage*>(smem_raw);
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    const int u0 = unit_start(blockIdx.x, units, gridDim.x);
    const int count = unit_start(blockIdx.x + 1, units, gridDim.x) - u0;
    const int tile0 = u0 / kc;
    Cursor ld = {tile0 / tiles_n, tile0 % tiles_n, u0 % kc};   // to load
    Cursor cu = ld;                                            // to compute

    float acc[8][kTN];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < kTN; ++c) acc[r][c] = kNegInf;
    }
    // prologue: the first kStages - 1 units in flight (a group per stage,
    // empty past the range, so that the group count stays in step)
#pragma unroll
    for (int p = 0; p < kStages - 1; ++p) {
        if (p < count) {
            load_unit(st[p], a, b, ld, M, K, N);
            ld.next(kc, tiles_n);
        }
        cp_async_commit();
    }
    int cs = 0, ls = kStages - 1;          // stages to compute and to load
    for (int it = 0; it < count; ++it) {
        cp_async_wait_stages();            // unit it has landed (this thread)
        __syncthreads();                   // ... for every thread; and the
                                           // stage of unit it - 1 is free
        if (it + kStages - 1 < count) {
            load_unit(st[ls], a, b, ld, M, K, N);
            ld.next(kc, tiles_n);
        }
        cp_async_commit();
        ls = ls + 1 == kStages ? 0 : ls + 1;
        const Stage& s = st[cs];
        cs = cs + 1 == kStages ? 0 : cs + 1;
#pragma unroll
        for (int k = 0; k < kBK; ++k) {
            const float4 a0 =
                *reinterpret_cast<const float4*>(&s.a[k][4 * ty]);
            const float4 a1 =
                *reinterpret_cast<const float4*>(&s.a[k][64 + 4 * ty]);
            float bv[kTN];
#pragma unroll
            for (int h = 0; h < kTN / 4; ++h) {
                const float4 b0 =
                    *reinterpret_cast<const float4*>(&s.b[k][64 * h + 4 * tx]);
                bv[4 * h] = b0.x;
                bv[4 * h + 1] = b0.y;
                bv[4 * h + 2] = b0.z;
                bv[4 * h + 3] = b0.w;
            }
            const float av[8] = {a0.x, a0.y, a0.z, a0.w,
                                 a1.x, a1.y, a1.z, a1.w};
#pragma unroll
            for (int r = 0; r < 8; ++r) {
#pragma unroll
                for (int c = 0; c < kTN; ++c) {
                    acc[r][c] = fmaxf(acc[r][c], __fadd_rn(av[r], bv[c]));
                }
            }
        }
        // the tile's last chunk, or the block's last unit: write the
        // partial maximum of this piece of the tile and start afresh
        if (cu.c == kc - 1 || it + 1 == count) {
            const int seg = cu.tm * tiles_n + cu.tn - tile0;
            float* p = ws + (static_cast<long long>(blockIdx.x) * max_seg
                             + seg) * (kBM * kBN);
#pragma unroll
            for (int r = 0; r < 8; ++r) {
                const int row = (r < 4 ? 0 : 64) + 4 * ty + (r % 4);
#pragma unroll
                for (int h = 0; h < kTN / 4; ++h) {
                    *reinterpret_cast<float4*>(p + row * kBN + 64 * h + 4 * tx)
                        = make_float4(acc[r][4 * h], acc[r][4 * h + 1],
                                      acc[r][4 * h + 2], acc[r][4 * h + 3]);
                }
#pragma unroll
                for (int c = 0; c < kTN; ++c) acc[r][c] = kNegInf;
            }
        }
        cu.next(kc, tiles_n);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

constexpr int kCombineRows = kThreads / (kBN / 4);   // rows per block

// One block per kCombineRows rows of a tile (grid tiles x kBM /
// kCombineRows): each thread takes
// 4 neighbouring entries, the fmaxf of the partials that the blocks owning
// the tile wrote, and stores those in range.
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ ws, float* __restrict__ out, int M,
               int N, int kc, int tiles_n, int units, int blocks,
               int max_seg) {
    const int t = blockIdx.x;
    const int lr = blockIdx.y * kCombineRows + threadIdx.x / (kBN / 4);
    const int lc = 4 * (threadIdx.x % (kBN / 4));
    // the blocks owning units t kc .. (t + 1) kc - 1: block g owns unit u
    // when g U / G <= u < (g + 1) U / G, i.e. g = ((u + 1) G - 1) / U
    const long long first = static_cast<long long>(t) * kc;
    const int g0 = static_cast<int>(((first + 1) * blocks - 1) / units);
    const int g1 = static_cast<int>(((first + kc) * blocks - 1) / units);
    float4 v = make_float4(kNegInf, kNegInf, kNegInf, kNegInf);
    for (int g = g0; g <= g1; ++g) {
        const int seg = t - unit_start(g, units, blocks) / kc;
        const float4 x = *reinterpret_cast<const float4*>(
            ws + ((static_cast<long long>(g) * max_seg + seg) * kBM + lr) * kBN
            + lc);
        v = make_float4(fmaxf(v.x, x.x), fmaxf(v.y, x.y), fmaxf(v.z, x.z),
                        fmaxf(v.w, x.w));
    }
    const int i = (t / tiles_n) * kBM + lr;
    const int j = (t % tiles_n) * kBN + lc;
    if (i >= M) return;
    float* o = out + static_cast<long long>(i) * N + j;
    const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        if (j + c < N) o[c] = vals[c];
    }
}

}  // namespace

// out (M, N) = max-plus product of a (M, K) and b (K, N), clamped at
// NEG_INF; all float32, contiguous, row-major.  `blocks` is the persistent
// grid (1 <= blocks <= units); `ws` is scratch of blocks * max_seg tiles of
// 128 x 64 float32, where max_seg bounds the tiles one block's range
// touches (repro_torch.kernels.maxplus.plan computes both).  Launches the
// product and the combine on `stream` and returns cudaGetLastError() (0 on
// success) without synchronising.
extern "C" int maxplus(const float* a, const float* b, float* out, float* ws,
                       int M, int K, int N, int blocks, int max_seg,
                       void* stream) {
    if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
    const int tiles_n = (N + kBN - 1) / kBN;
    const long long tiles = static_cast<long long>((M + kBM - 1) / kBM)
                            * tiles_n;
    const int kc = K > 0 ? (K + kBK - 1) / kBK : 1;
    const long long units = tiles * kc;
    if (units >= (1LL << 31) || blocks < 1 || blocks > units || max_seg < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    auto s = static_cast<cudaStream_t>(stream);
    const size_t smem = sizeof(Stage) * kStages;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            maxplus_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    maxplus_kernel<<<blocks, kThreads, smem, s>>>(
        a, b, ws, M, K, N, kc, tiles_n, static_cast<int>(units), max_seg);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    combine_kernel<<<dim3(static_cast<unsigned>(tiles), kBM / kCombineRows),
                     kThreads,
                     0, s>>>(ws, out, M, N, kc, tiles_n,
                             static_cast<int>(units), blocks, max_seg);
    return static_cast<int>(cudaGetLastError());
}
