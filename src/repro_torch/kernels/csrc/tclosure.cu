// One step of boolean transitive closure for Hopper (sm_90a):
// out = A | (A . A), the OR-AND product of a square 0/1 matrix with itself.
//
// Replaces the Pallas TPU kernel `repro/kernels/tclosure.py:41
// tclosure_step` (body `_tclosure_kernel`), which counted paths with an f32
// MXU matmul padded to 128 and thresholded the count at 0.5.  The count is
// not needed, only whether it is non-zero, so this kernel works on bits.
//
// What bounds it.  Alg. 2's closure of megatron-462b is n = 801 tasks and
// 3 squaring steps.  Counted as the dense int8 product that an exact
// tensor-core version would run, a step is 2 n^3 = 1.03 G operations:
// ~0.52 us at 1,979 int8 TOP/s, against ~0.38 us for its 1.28 MB of bool in
// and out at 3.35 TB/s.  Both are far below one launch, so at this size
// latency bounds the step: the launches, the copies each block waits on,
// and the chains of dependent loads in each warp.  The design keeps those
// few and short.
//
// Design.  Two launches on one stream:
//   1. pack: each row becomes `ws` 32-bit words, ws = ceil(n / 32) rounded
//      up to a multiple of 4 (28 at n = 801), so that a row is a whole
//      number of 16-byte chunks.  One warp packs 4 words (128 columns) of a
//      row: each lane reads 4 elements (any of bool, int8, int32, float32:
//      nonzero is set), columns lane + 32 j, all 4 loads in flight, and one
//      `__ballot_sync` per element gives each word.  Columns past n and the
//      padding words are zero bits.  Lane 0 stores the 4 words as 16 bytes.
//   2. square, by size:
//      resident (the packed matrix, an mbarrier and the block's row
//        accumulators fit in a block's shared memory, n <= ~1,310): one
//        block per SM (at most one per row) copies the whole packed matrix
//        into shared memory with `cp.async.bulk` (the TMA's one-dimensional
//        copy, one per 32-row slab, issued by the lanes of one warp
//        together, all completing on one mbarrier; 89,712 bytes at
//        n = 801) and owns rows b, b + G, ...  Its work is cut into items
//        of (row, 2 words of the row): its warps take the items in turn, so
//        that each row's walk is spread over several warps (at n = 801, 6
//        or 7 rows, 78 or 91 items, on 32 warps).  For every set bit k of
//        its words an item ORs row k into its accumulator, one lane per word
//        (a second word per lane above 32 words), a byte of set bits at a
//        time with their loads in flight together, then ORs its result into
//        the row's accumulator in shared memory (`atomicOr`; OR does not
//        depend on order, so the bits are the same run to run).  A barrier,
//        and each warp unpacks whole rows.  Measured variants (PERF.md): a
//        cluster of 2 or 4 blocks sharing each copy by TMA multicast, an
//        mbarrier per slab (to start walking before the whole copy lands),
//        items of 1 or 4 words, a thread per column in the unpack, and the
//        set bits taken one by one (`__ffs`) were each slower.
//      streamed (larger n): a block owns 8 rows x 32 words (1,024 columns)
//        of the result; it reads its rows' words once, marks the 32-row
//        slabs of A that some row reaches, and walks only those, with the
//        next marked slab's 32 x 32 words on their way into the other half
//        of a double-buffered ring (16-byte `cp.async`) while it ORs in the
//        current one.
//      Either path ORs in A's own words and unpacks rows into bool bytes, a
//      warp writing 32 consecutive columns at a time from a word that a
//      shuffle broadcasts; columns past n are never written.
// The work is one 32-bit OR per set bit of A and word of the row: nnz(A)
// ws (2.5 M at the first step of n = 801), exact for any n.  A binary
// tensor-core version (mma.sync .b1 with .and.popc) is later work, for
// large, dense matrices.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPackWarps = 8;      // pack: 8 groups of 4 words per block
constexpr int kRows = 8;           // streamed: rows of the result per block
constexpr int kTileWords = 32;     // streamed: 32-bit words of it per block
constexpr int kChunkWords = 2;     // resident: words of a row per item

template <typename T>
__global__ void __launch_bounds__(kWarp * kPackWarps)
pack_kernel(const T* __restrict__ a, uint32_t* __restrict__ bits, int n,
            int ws) {
    const int lane = threadIdx.x % kWarp;
    const int groups = ws / 4;
    const long long g = static_cast<long long>(blockIdx.x) * kPackWarps
                        + threadIdx.x / kWarp;
    if (g >= static_cast<long long>(n) * groups) return;   // warp-uniform
    const int row = static_cast<int>(g / groups);
    const int col0 = static_cast<int>(g % groups) * 4 * kWarp + lane;
    const T* arow = a + static_cast<long long>(row) * n;
    T v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int c = col0 + j * kWarp;
        v[j] = c < n ? arow[c] : static_cast<T>(0);
    }
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        w[j] = __ballot_sync(kFull, v[j] != static_cast<T>(0));
    }
    if (lane == 0) {
        *reinterpret_cast<uint4*>(bits + static_cast<long long>(row) * ws
                                  + (g % groups) * 4) =
            make_uint4(w[0], w[1], w[2], w[3]);
    }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Writes row i of the result from the words a warp holds, word w in lane
// w % 32 of `lo` (w < 32) or `hi` (w >= 32), for words w0 .. w0 + count - 1.
__device__ __forceinline__ void unpack_row(bool* __restrict__ out, int n,
                                           int i, int w0, int count,
                                           uint32_t lo, uint32_t hi) {
    const int lane = threadIdx.x % kWarp;
    bool* orow = out + static_cast<long long>(i) * n;
    for (int w = 0; w < count; ++w) {
        const uint32_t word = __shfl_sync(kFull, w < kWarp ? lo : hi,
                                          w % kWarp);
        const int c = (w0 + w) * kWarp + lane;
        if (c < n) orow[c] = (word >> lane) & 1u;
    }
}

// ORs into (lo, hi) word w_lo (and w_hi) of the rows b of `slab` (row
// stride `stride` words) for the set bits b of ai.  A byte of ai at a time,
// its eight bits unrolled: the loads of the set bits are independent, so
// they are in flight together.
__device__ __forceinline__ void or_rows(uint32_t ai, const uint32_t* slab,
                                        int stride, int w_lo, int w_hi,
                                        bool two, uint32_t& lo, uint32_t& hi) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const uint32_t byte = (ai >> (8 * q)) & 0xffu;
        if (byte == 0u) continue;                   // warp-uniform
        uint32_t v0 = 0u, v1 = 0u;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
            if ((byte >> b) & 1u) {
                const uint32_t* row = slab + (8 * q + b) * stride;
                v0 |= row[w_lo];
                if (two) v1 |= row[w_hi];
            }
        }
        lo |= v0;
        hi |= v1;
    }
}

// Waits for phase 0 of the mbarrier at `bar`; a copy that has not landed
// after ~10 s of clock traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar) {
    const long long t0 = clock64();
    uint32_t done = 0;
    while (!done) {
        if (clock64() - t0 > 20000000000LL) __trap();
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar) : "memory");
    }
}

// The whole packed matrix in shared memory.  Block b owns rows b, b + G,
// ...; an item is (one of its rows, kChunkWords words of that row's k),
// taken by its warps in turn, so that every row's walk is split over
// several warps; each item ORs its rows of the matrix into the row's
// accumulator in shared memory.
__global__ void __launch_bounds__(1024)
square_resident(const uint32_t* __restrict__ bits, bool* __restrict__ out,
                int n, int ws) {
    extern __shared__ __align__(16) uint32_t sm[];
    const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
    const int warps = blockDim.x / kWarp;
    const int words = (n + kWarp - 1) / kWarp;
    // after the matrix (n ws 4 bytes, a multiple of 16): its mbarrier, then
    // the accumulators of the block's rows
    const uint32_t bytes = static_cast<uint32_t>(n) * ws * 4u;
    const uint32_t bar = smem_addr(sm) + bytes;
    uint32_t* acc = sm + bytes / 4 + 4;
    const int rows = (n - static_cast<int>(blockIdx.x) + gridDim.x - 1)
                     / gridDim.x;                   // this block's rows
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     :: "r"(bar) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();
    if (warp == 0) {            // a bulk copy per slab, from all 32 lanes
        if (lane == 0) {
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, "
                         "[%0], %1;\n" :: "r"(bar), "r"(bytes) : "memory");
        }
        __syncwarp();
        for (int s = lane; s < words; s += kWarp) {
            const uint32_t off = static_cast<uint32_t>(s) * kWarp * ws * 4;
            const uint32_t size = min(kWarp, n - s * kWarp) * ws * 4;
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                "::bytes [%0], [%1], %2, [%3];\n"
                :: "r"(smem_addr(sm) + off),
                   "l"(reinterpret_cast<const char*>(bits) + off),
                   "r"(size), "r"(bar) : "memory");
        }
    }
    mbar_wait(bar);
    for (int e = threadIdx.x; e < rows * ws; e += blockDim.x) {
        const int i = blockIdx.x + (e / ws) * gridDim.x;
        acc[e] = sm[static_cast<long long>(i) * ws + e % ws];  // A's words
    }
    __syncthreads();

    const bool two = ws > kWarp;                    // a second word per lane
    const int w_lo = min(lane, ws - 1);             // lanes past ws read a
    const int w_hi = min(lane + kWarp, ws - 1);     // valid word, unused
    const int chunks = (words + kChunkWords - 1) / kChunkWords;
    for (int item = warp; item < rows * chunks; item += warps) {
        const int r = item / chunks;
        const int kw0 = (item % chunks) * kChunkWords;
        const uint32_t* arow =
            sm + static_cast<long long>(blockIdx.x + r * gridDim.x) * ws;
        uint32_t lo = 0u, hi = 0u;
        for (int kw = kw0; kw < min(words, kw0 + kChunkWords); ++kw) {
            const uint32_t ai = arow[kw];           // broadcast
            if (ai == 0u) continue;                 // warp-uniform
            or_rows(ai, sm + static_cast<long long>(kw) * kWarp * ws, ws,
                    w_lo, w_hi, two, lo, hi);
        }
        // OR does not depend on order: the bits are the same whichever
        // warp gets there first
        if (lo != 0u && lane < ws) atomicOr(&acc[r * ws + lane], lo);
        if (hi != 0u && lane + kWarp < ws) {
            atomicOr(&acc[r * ws + lane + kWarp], hi);
        }
    }
    __syncthreads();
    for (int r = warp; r < rows; r += warps) {
        const uint32_t* row = acc + r * ws;
        unpack_row(out, n, blockIdx.x + r * gridDim.x, 0, words, row[w_lo],
                   two ? row[w_hi] : 0u);
    }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// Stages 32 rows k0.. x 32 words w0.. of the packed matrix: thread t copies
// 16 bytes (row t / 8, words 4 (t % 8) ..), zeros past the matrix.
__device__ __forceinline__ void load_slab(uint32_t (*slab)[kTileWords],
                                          const uint32_t* __restrict__ bits,
                                          int n, int ws, int k0, int w0) {
    const int r = threadIdx.x / 8, q = 4 * (threadIdx.x % 8);
    const int k = k0 + r;
    if (k < n && w0 + q < ws) {
        cp_async16(&slab[r][q],
                   bits + static_cast<long long>(k) * ws + w0 + q);
    } else {
        *reinterpret_cast<uint4*>(&slab[r][q]) = make_uint4(0u, 0u, 0u, 0u);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The next slab at or after kw that a row of the block reaches.
__device__ __forceinline__ int next_slab(const unsigned char* need, int kw,
                                         int words) {
    while (kw < words && !need[kw]) ++kw;
    return kw;
}

// A block owns 8 rows x 32 words of the result and streams the slabs of A
// that its rows reach through a double-buffered ring.
__global__ void __launch_bounds__(kWarp * kRows)
square_streamed(const uint32_t* __restrict__ bits, bool* __restrict__ out,
                int n, int ws) {
    __shared__ __align__(16) uint32_t slab[2][kWarp][kTileWords];
    extern __shared__ __align__(16) uint32_t dyn[];
    uint32_t* rows = dyn;                                   // [kRows][ws]
    auto* need = reinterpret_cast<unsigned char*>(dyn + kRows * ws);
    const int lane = threadIdx.x % kWarp;
    const int wr = threadIdx.x / kWarp;
    const int row0 = blockIdx.y * kRows;
    const int w0 = blockIdx.x * kTileWords;
    const int words = (n + kWarp - 1) / kWarp;
    for (int e = threadIdx.x; e < kRows * ws; e += blockDim.x) {
        const int r = row0 + e / ws;
        rows[e] = r < n ? bits[static_cast<long long>(r) * ws + e % ws] : 0u;
    }
    __syncthreads();
    for (int kw = threadIdx.x; kw < words; kw += blockDim.x) {
        bool any = false;
#pragma unroll
        for (int r = 0; r < kRows; ++r) any |= rows[r * ws + kw] != 0u;
        need[kw] = any;
    }
    __syncthreads();

    uint32_t acc = 0u;
    int buf = 0;
    int kw = next_slab(need, 0, words);
    if (kw < words) load_slab(slab[0], bits, n, ws, kw * kWarp, w0);
    while (kw < words) {
        const int nk = next_slab(need, kw + 1, words);
        if (nk < words) {
            load_slab(slab[buf ^ 1], bits, n, ws, nk * kWarp, w0);
            asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        } else {
            asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        }
        __syncthreads();                        // slab kw has landed
        uint32_t unused = 0u;
        or_rows(rows[wr * ws + kw], &slab[buf][0][0], kTileWords, lane, lane,
                false, acc, unused);
        __syncthreads();                        // slab kw is free again
        buf ^= 1;
        kw = nk;
    }
    const int i = row0 + wr;
    if (i >= n) return;                         // warp-uniform
    if (w0 + lane < ws) acc |= rows[wr * ws + w0 + lane];
    unpack_row(out, n, i, w0, min(kTileWords, words - w0), acc, 0u);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

template <typename T>
int launch(const void* a, uint32_t* bits, bool* out, int n, int ws,
           int resident, int blocks, int warps, cudaStream_t stream) {
    const long long groups = static_cast<long long>(n) * (ws / 4);
    const unsigned pack_blocks =
        static_cast<unsigned>((groups + kPackWarps - 1) / kPackWarps);
    pack_kernel<T><<<pack_blocks, kWarp * kPackWarps, 0, stream>>>(
        static_cast<const T*>(a), bits, n, ws);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (resident) {
        const int rows = (n + blocks - 1) / blocks;
        const size_t smem = static_cast<size_t>(n) * ws * 4 + 16
                            + static_cast<size_t>(rows) * ws * 4;
        err = allow_smem(square_resident, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        square_resident<<<blocks, kWarp * warps, smem, stream>>>(
            bits, out, n, ws);
    } else {
        const size_t smem = static_cast<size_t>(kRows) * ws * 4
                            + (n + kWarp - 1) / kWarp;
        err = allow_smem(square_streamed, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        const dim3 grid((ws + kTileWords - 1) / kTileWords,
                        (n + kRows - 1) / kRows);
        square_streamed<<<grid, kWarp * kRows, smem, stream>>>(
            bits, out, n, ws);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (n, n) bool = A | (A . A) for A (n, n), contiguous row-major, of
// element type `dtype`: 0 bool (1 byte), 1 int8, 2 int32, 3 float32.
// `bits` is scratch of n * ws words, 16-byte aligned, ws = ceil(n / 32)
// rounded up to a multiple of 4.  `resident` picks the square: 1 the
// resident path on `blocks` blocks of `warps` warps (n ws 4 bytes of shared
// memory each), 0 the streamed path (its grid follows from n).
// repro_torch.kernels.tclosure.plan computes them.  Launches on `stream`
// and returns cudaGetLastError() (0 on success) without synchronising; an
// unknown dtype or a bad argument returns cudaErrorInvalidValue.
extern "C" int tclosure_step(const void* a, int dtype, void* bits, void* out,
                             int n, int ws, int resident, int blocks,
                             int warps, void* stream) {
    if (n <= 0) return static_cast<int>(cudaSuccess);
    if (ws % 4 != 0 || ws * kWarp < n || (resident && (blocks < 1
            || warps < 1 || warps > 32 || ws > 2 * kWarp))) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    auto* b = static_cast<uint32_t*>(bits);
    auto* o = static_cast<bool*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch<uint8_t>(a, b, o, n, ws, resident, blocks,
                                       warps, s);
        case 1: return launch<int8_t>(a, b, o, n, ws, resident, blocks,
                                      warps, s);
        case 2: return launch<int32_t>(a, b, o, n, ws, resident, blocks,
                                       warps, s);
        case 3: return launch<float>(a, b, o, n, ws, resident, blocks,
                                     warps, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

