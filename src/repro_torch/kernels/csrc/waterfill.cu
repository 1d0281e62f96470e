// Water-filling matvec for Hopper (sm_90a): out[b, c, r] = sum_n W[c, n] * rhs[b, n, r].
//
// Replaces the Pallas TPU kernel `repro/kernels/waterfill.py:47 fill_matvec`
// (body `_fill_kernel`), which padded the right-hand sides to 128 MXU lanes
// and walked N on a sequential grid axis.  Neither serves this card, so the
// design starts again from what the DES asks of it.
//
// What bounds it.  One progressive-filling round of the DES (the
// `repro_torch.core.des_torch` inner loop) needs (used, denom) = W @ [level,
// unfrozen] for every lane of the GA population: R = 2 columns, C = 80
// constraints, N = 832 tasks, B = 48 lanes at the main path's width.  That
// is ~0.62 MB of traffic (W 266 KB, rhs 320 KB, out 31 KB) and 12.8 MFLOP:
// ~0.19 us at 3.35 TB/s and ~0.19 us at 67 TFLOP/s f32.  Both are far
// below one kernel launch, so the launch and the host loop around it bound
// the round, not the card.
//
// Design.  A batched GEMV that is light on memory: one warp per output row
// (b, c, r-chunk of up to RT columns).  Lanes stride over N (coalesced
// reads of a W row and of the rhs rows), keep their RT partial sums in
// registers with fp32 FMA, and reduce with a fixed shuffle tree.  No tensor
// cores, no TF32, no atomics: the summation order is fixed, so the same
// inputs give bit-identical outputs run to run (the GA's "same seed, same
// topology" determinism rests on it).  W is re-read once per (b, r-chunk);
// at 266 KB it stays in the 50 MB L2.
//
// Later work: fuse the whole progressive-filling loop (and the event
// trip around it) into one persistent kernel with W held in shared
// memory, so a round costs no launch and no host sync.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;   // 8 output rows (constraints) per block
constexpr int kRT = 4;              // rhs columns per warp

__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
fill_matvec_kernel(const float* __restrict__ w, const float* __restrict__ rhs,
                   float* __restrict__ out, int C, int N, int R) {
    const int lane = threadIdx.x % kWarp;
    const int c = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
    const int r0 = blockIdx.y * kRT;
    const int b = blockIdx.z;
    if (c >= C) return;   // whole warp exits together: c is warp-uniform

    const float* wrow = w + static_cast<long long>(c) * N;
    const float* rb = rhs + static_cast<long long>(b) * N * R;
    float acc[kRT];
#pragma unroll
    for (int j = 0; j < kRT; ++j) acc[j] = 0.0f;

    for (int n = lane; n < N; n += kWarp) {
        const float wv = wrow[n];
        const float* rrow = rb + static_cast<long long>(n) * R + r0;
#pragma unroll
        for (int j = 0; j < kRT; ++j) {
            if (r0 + j < R) acc[j] = fmaf(wv, rrow[j], acc[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < kRT; ++j) {
#pragma unroll
        for (int off = kWarp / 2; off > 0; off >>= 1) {
            acc[j] += __shfl_down_sync(0xffffffffu, acc[j], off);
        }
    }
    if (lane == 0) {
        float* orow = out + (static_cast<long long>(b) * C + c) * R + r0;
#pragma unroll
        for (int j = 0; j < kRT; ++j) {
            if (r0 + j < R) orow[j] = acc[j];
        }
    }
}

}  // namespace

// out (B, C, R) = W (C, N) @ rhs (B, N, R); all float32, contiguous,
// row-major.  Launches on `stream` and returns cudaGetLastError() (0 on
// success) without synchronising.
extern "C" int waterfill_fill_matvec(const float* w, const float* rhs,
                                     float* out, int B, int C, int N, int R,
                                     void* stream) {
    if (B <= 0 || C <= 0 || R <= 0) return static_cast<int>(cudaSuccess);
    const dim3 block(kWarp * kWarpsPerBlock);
    const dim3 grid((C + kWarpsPerBlock - 1) / kWarpsPerBlock,
                    (R + kRT - 1) / kRT, B);
    fill_matvec_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        w, rhs, out, C, N, R);
    return static_cast<int>(cudaGetLastError());
}
