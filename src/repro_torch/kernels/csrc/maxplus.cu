// Tropical (max, +) matrix product for Hopper (sm_90a):
// out[i, j] = max(NEG_INF, max_k a[i, k] + b[k, j]), all float32.
//
// Replaces the Pallas TPU kernel `repro/kernels/maxplus.py:40 maxplus`
// (body `_maxplus_kernel`), which ran on the TPU's vector unit because the
// MXU has no (max, +) semiring.  Hopper's tensor cores have none either, so
// this is a CUDA-core kernel.
//
// What bounds it.  `ops.longest_paths` squares the 801 x 801 weight matrix
// of megatron-462b 5 times.  One product is m k n = 514 M float32 adds and
// as many maxes, two instructions that do not fuse: ~31 us at the card's
// ~33.5 T float32 instructions/s (the 67 TFLOP/s peak counts an FMA as
// two), against ~2 us for its 7.7 MB in and out at 3.35 TB/s.  So it is
// bound by operations, and the design is an SGEMM's with fmaxf for the sum.
//
// Design.  A block of 256 threads owns a 64 x 64 tile of the result and
// walks k in chunks of 16: it stages a 64 x 16 tile of a (transposed, so a
// thread reads its rows as one broadcast) and a 16 x 64 tile of b in shared
// memory, and each thread keeps a 4 x 4 block of the result in registers,
// rows ty + 16 r and columns tx + 16 c (neighbouring threads read
// neighbouring words: no bank conflicts, coalesced stores).  Out-of-range
// elements load as NEG_INF, as the Pallas wrapper pads (NEG_INF + x never
// beats the NEG_INF the sums start from), and out-of-range results are not
// stored.  Each entry is a max of float32 sums, each rounded once, and a max
// does not depend on order: the result is bit-identical to the plain
// version's and run to run.

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;   // repro_torch.kernels.ref.NEG_INF
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kT = 16;              // 16 x 16 threads
constexpr int kR = kBM / kT;        // 4 x 4 results per thread

__global__ void __launch_bounds__(kT * kT)
maxplus_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ out, int M, int K, int N) {
    __shared__ float a_s[kBK][kBM + 1];  // a tile, transposed; +1: banks
    __shared__ float b_s[kBK][kBN];
    const int tx = threadIdx.x % kT;
    const int ty = threadIdx.x / kT;
    const int row0 = blockIdx.y * kBM;
    const int col0 = blockIdx.x * kBN;

    float acc[kR][kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
        for (int c = 0; c < kR; ++c) acc[r][c] = kNegInf;
    }
    for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
        for (int s = 0; s < kBM * kBK / (kT * kT); ++s) {
            const int l = threadIdx.x + s * kT * kT;
            const int r = l / kBK, k = l % kBK;       // a: 16 k per row
            const int gi = row0 + r, gk = k0 + k;
            a_s[k][r] = (gi < M && gk < K)
                ? a[static_cast<long long>(gi) * K + gk] : kNegInf;
        }
#pragma unroll
        for (int s = 0; s < kBK * kBN / (kT * kT); ++s) {
            const int l = threadIdx.x + s * kT * kT;
            const int k = l / kBN, c = l % kBN;       // b: 64 columns per k
            const int gk = k0 + k, gj = col0 + c;
            b_s[k][c] = (gk < K && gj < N)
                ? b[static_cast<long long>(gk) * N + gj] : kNegInf;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kBK; ++k) {
            float av[kR], bv[kR];
#pragma unroll
            for (int r = 0; r < kR; ++r) av[r] = a_s[k][ty + kT * r];
#pragma unroll
            for (int c = 0; c < kR; ++c) bv[c] = b_s[k][tx + kT * c];
#pragma unroll
            for (int r = 0; r < kR; ++r) {
#pragma unroll
                for (int c = 0; c < kR; ++c) {
                    acc[r][c] = fmaxf(acc[r][c], __fadd_rn(av[r], bv[c]));
                }
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
        const int gi = row0 + ty + kT * r;
        if (gi >= M) continue;
#pragma unroll
        for (int c = 0; c < kR; ++c) {
            const int gj = col0 + tx + kT * c;
            if (gj < N) out[static_cast<long long>(gi) * N + gj] = acc[r][c];
        }
    }
}

}  // namespace

// out (M, N) = max-plus product of a (M, K) and b (K, N), clamped at
// NEG_INF; all float32, contiguous, row-major.  Launches on `stream` and
// returns cudaGetLastError() (0 on success) without synchronising.
extern "C" int maxplus(const float* a, const float* b, float* out, int M,
                       int K, int N, void* stream) {
    if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    maxplus_kernel<<<grid, kT * kT, 0, static_cast<cudaStream_t>(stream)>>>(
        a, b, out, M, K, N);
    return static_cast<int>(cudaGetLastError());
}
