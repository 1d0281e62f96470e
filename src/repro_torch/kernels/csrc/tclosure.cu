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
// and out at 3.35 TB/s.  Both are far below one launch, so at this size the
// launch and the host loop around it bound the step, not the card.
//
// Design.  Two launches on one stream:
//   1. pack: one warp per 32-column word of a row; each lane tests one
//      element (any of bool, int8, int32, float32: nonzero is set), and
//      `__ballot_sync` gathers the 32 tests into one word.  Columns past n
//      give 0 bits, so the padding of each row's last word is zero.
//   2. square: a GEMM over bits.  A block owns 8 rows x 32 words (1,024
//      columns) of the result, one warp per row and one lane per word
//      (101 blocks at n = 801).  For each 32-row slab k0..k0+31 of A that
//      some row of the block reaches (`__syncthreads_or` skips the rest),
//      it stages the slab's 32 x 32 words in shared memory, and each warp
//      ORs into its row the staged row k of every set bit k of its word
//      A[i, k0..k0+31], walking only the set bits (`__ffs`).  Then A's own
//      word is ORed in, and the block unpacks its rows into bool bytes
//      through shared memory, neighbouring threads on neighbouring bytes;
//      bits past column n are never written.
// The work is one 32-bit OR per set bit of A and word of the row: nnz(A)
// n / 32 (2.3 M at the first step of n = 801, against n^3 / 32 = 16 M for a
// dense product), exact for any n, with no atomics: OR does not depend on
// order, so the result is bit-identical run to run.  An int8 tensor-core
// version (mma.sync s8 with an s32 accumulator) is also exact; it is later
// work, for matrices dense enough to need it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kPackWarps = 8;      // pack: 8 words per block of 256 threads
constexpr int kRows = 8;           // square: rows of the result per block
constexpr int kTileWords = 32;     // square: 32-bit words of it per block

template <typename T>
__global__ void __launch_bounds__(kWarp * kPackWarps)
pack_kernel(const T* __restrict__ a, uint32_t* __restrict__ bits, int n,
            int words) {
    const int lane = threadIdx.x % kWarp;
    const long long w = static_cast<long long>(blockIdx.x) * kPackWarps
                        + threadIdx.x / kWarp;
    if (w >= static_cast<long long>(n) * words) return;   // warp-uniform
    const int row = static_cast<int>(w / words);
    const int col = static_cast<int>(w % words) * kWarp + lane;
    const bool set = col < n
        && a[static_cast<long long>(row) * n + col] != static_cast<T>(0);
    const uint32_t word = __ballot_sync(0xffffffffu, set);
    if (lane == 0) bits[w] = word;
}

// One warp per row i of the tile, one lane per word w: for each 32-row
// slab k0.. of A that some row of the tile reaches, stage the slab's words
// in shared memory and OR in row k of it for every set bit k of A[i, k0..].
__global__ void __launch_bounds__(kWarp * kRows)
square_kernel(const uint32_t* __restrict__ bits, bool* __restrict__ out,
              int n, int words) {
    __shared__ uint32_t b_s[kWarp][kTileWords];    // rows k0..k0+31 of A
    __shared__ uint32_t r_s[kRows][kTileWords];    // the result, to unpack
    const int lane = threadIdx.x % kWarp;
    const int wr = threadIdx.x / kWarp;
    const int i = blockIdx.y * kRows + wr;
    const int word0 = blockIdx.x * kTileWords;
    const int w = word0 + lane;
    const uint32_t* arow =
        bits + static_cast<long long>(min(i, n - 1)) * words;

    uint32_t acc = 0u;
    for (int kw = 0; kw < words; ++kw) {
        uint32_t ai = i < n ? arow[kw] : 0u;       // one word per warp
        if (!__syncthreads_or(ai != 0u)) continue; // block-uniform skip
#pragma unroll
        for (int s = 0; s < kWarp / kRows; ++s) {
            const int r = wr + kRows * s;
            const int k = kw * kWarp + r;
            b_s[r][lane] = (k < n && w < words)
                ? bits[static_cast<long long>(k) * words + w] : 0u;
        }
        __syncthreads();
        while (ai != 0u) {                         // warp-uniform
            acc |= b_s[__ffs(ai) - 1][lane];
            ai &= ai - 1u;
        }
        __syncthreads();
    }
    r_s[wr][lane] = (i < n && w < words) ? acc | arow[w] : 0u;
    __syncthreads();
    // unpack the tile's rows, neighbouring threads on neighbouring bytes;
    // bits past column n are never written
    const int c0 = word0 * kWarp;
    const int ncols = min(kTileWords * kWarp, n - c0);
    for (int r = 0; r < kRows; ++r) {
        const int row = blockIdx.y * kRows + r;
        if (row >= n) break;
        bool* orow = out + static_cast<long long>(row) * n + c0;
        for (int c = threadIdx.x; c < ncols; c += kWarp * kRows) {
            orow[c] = (r_s[r][c / kWarp] >> (c % kWarp)) & 1u;
        }
    }
}

template <typename T>
int launch(const void* a, uint32_t* bits, bool* out, int n,
           cudaStream_t stream) {
    const int words = (n + kWarp - 1) / kWarp;
    const long long total = static_cast<long long>(n) * words;
    const unsigned pack_blocks =
        static_cast<unsigned>((total + kPackWarps - 1) / kPackWarps);
    pack_kernel<T><<<pack_blocks, kWarp * kPackWarps, 0, stream>>>(
        static_cast<const T*>(a), bits, n, words);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((words + kTileWords - 1) / kTileWords,
                    (n + kRows - 1) / kRows);
    square_kernel<<<grid, kWarp * kRows, 0, stream>>>(
        bits, out, n, words);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (n, n) bool = A | (A . A) for A (n, n), contiguous row-major, of
// element type `dtype`: 0 bool (1 byte), 1 int8, 2 int32, 3 float32.
// `bits` is scratch of n * ceil(n / 32) words.  Launches on `stream` and
// returns cudaGetLastError() (0 on success) without synchronising; an
// unknown dtype returns cudaErrorInvalidValue.
extern "C" int tclosure_step(const void* a, int dtype, void* bits, void* out,
                             int n, void* stream) {
    if (n <= 0) return static_cast<int>(cudaSuccess);
    auto* b = static_cast<uint32_t*>(bits);
    auto* o = static_cast<bool*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch<uint8_t>(a, b, o, n, s);
        case 1: return launch<int8_t>(a, b, o, n, s);
        case 2: return launch<int32_t>(a, b, o, n, s);
        case 3: return launch<float>(a, b, o, n, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
