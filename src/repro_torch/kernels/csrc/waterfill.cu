// Water-filling kernels for Hopper (sm_90a).
//
//   fill_matvec  out[b, c, r] = sum_n W[c, n] * rhs[b, n, r]: one filling
//                round's (used, denom), launched once per round;
//   fill_maxmin  every progressive-filling round of one DES event trip, for
//                every lane of the population, in one launch.
//
// ------------------------------------------------------------ fill_matvec
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

#include <assert.h>
#include <cuda_runtime.h>
#include <math.h>

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

// ------------------------------------------------------------ fill_maxmin
//
// Weighted max-min fair task rates by progressive filling: the whole
// filling loop of one DES event trip, for every lane of the population.
// Replaces the Pallas kernel `repro/kernels/waterfill.py:47 fill_matvec`
// together with the `lax.while_loop` around it in
// `repro/core/des_jax.py:256 _maxmin`, which launches it once per round,
// and the vmap of both over an ensemble's members in
// `repro/core/des_jax.py:719 EnsembleJaxDES`.
//
// What bounds it.  At the main path's width (megatron-462b bucketed: N =
// 832 tasks, C = 80 constraints, E = 2,432 incidence entries, S = 48
// lanes) a trip reads the CSR incidence (~20 KB), `active` (40 KB), `caps`
// (15 KB) and `flows` (3 KB) once and writes `rates` (160 KB): ~0.07 us at
// 3.35 TB/s.  Its arithmetic is ~4E FLOP per lane and round, far less.
// Neither is what a trip pays: the rounds are sequential, each a chain of
// block barriers and shared-memory round trips, so one launch is bound by
// its latency (a few us), and the per-round path it replaces was bound by
// one host sync, one launch and ~15 small torch ops per round.
//
// Design.  One block per lane; no round leaves the block.  A launch may
// serve M problems at once (the members of an ensemble, each padded to one
// (N, C, E)): lane s reads member s % M's CSR and flows, so the lanes are
// genome-major and member-minor, and with M = 1 every lane reads the one
// problem.  The block copies its member's incidence as CSR by constraint
// (con_ptr, ent_task, ent_w) into shared memory once, with the lane's phi,
// active / unfrozen / hit flags, alpha_c and caps, sized as dynamic shared memory from (N, C, E) (above
// 48 KB after cudaFuncAttributeMaxDynamicSharedMemorySize; the wrapper
// refuses more than the 227 KB a block may have).  The dense W of the
// per-round kernel is 96% zeros at the main shape; the CSR reads only the
// nonzeros.  A round is three barriers:
//   1. one warp per constraint sums used = sum w phi active and denom =
//      sum w unfrozen over the constraint's entries (lane l takes entries
//      l, l + 32, ...; then a shuffle-down tree) and writes
//      alpha_c = denom > 0 ? (caps - used) / denom : inf;          | sync
//   2. every warp takes alpha = max(min_c alpha_c, 0) itself (a min is
//      exact, so every warp gets the same bits; NaN wins, as in
//      torch.amin); each warp marks the tasks of its saturated
//      constraints (alpha_c finite and <= alpha + 1e-18: the reference's
//      (1 + 1e-9) is 1 in float32) with hit = 1 -- racing writes of the
//      same 1 -- and phi += alpha on the unfrozen tasks;            | sync
//   3. unfrozen &= !hit, hit = 0, and __syncthreads_or(any unfrozen)
//      ends the loop, which is capped at C + 1 rounds.             | sync
// No host sync and no atomics: every sum has a fixed order, so reruns are
// bit-identical (the GA's "same seed, same x" rests on it).  Every product
// and sum is rounded once (__fmul_rn, __fadd_rn: no FMA) and division is
// IEEE (__fdiv_rn), so the plain version (`kernels/ref.py`
// csr_warp_sums, the same order in torch ops) gives the same bits: the
// saturation test compares alpha_c for equality, and a tie that two
// summation orders split differently would change the rounds.  The
// reference's 1e-300 clamp is 0 in float32, so a constraint with denom ==
// 0 drops out.  Built without --use_fast_math.

namespace {

constexpr int kMaxminThreads = 1024;

// kernels/waterfill.py's `maxmin_smem_bytes` is the same sum: the wrapper
// refuses a problem above the 227 KB a block may have before it launches
size_t maxmin_smem_bytes(int N, int C, int E) {
    // 4-byte arrays first (con_ptr, ent_task, ent_w, phi, alpha_c, caps),
    // then the three byte arrays (active, unfrozen, hit)
    return 4 * (static_cast<size_t>(C) + 1) + 8 * static_cast<size_t>(E)
           + 4 * static_cast<size_t>(N) + 8 * static_cast<size_t>(C)
           + 3 * static_cast<size_t>(N);
}

// torch.amin's order: a NaN wins, otherwise the smaller value
__device__ __forceinline__ float min_nan(float a, float b) {
    return (a < b || a != a) ? a : b;
}

__global__ void __launch_bounds__(kMaxminThreads)
fill_maxmin_kernel(const int* __restrict__ con_ptr,
                   const int* __restrict__ ent_task,
                   const float* __restrict__ ent_w,
                   const unsigned char* __restrict__ active,
                   const float* __restrict__ caps,
                   const float* __restrict__ flows,
                   float* __restrict__ rates, int* __restrict__ rounds,
                   int M, int N, int C, int E) {
    extern __shared__ __align__(16) unsigned char smem[];
    int* s_ptr = reinterpret_cast<int*>(smem);
    int* s_task = s_ptr + (C + 1);
    float* s_w = reinterpret_cast<float*>(s_task + E);
    float* s_phi = s_w + E;
    float* s_alpha = s_phi + N;
    float* s_caps = s_alpha + C;
    unsigned char* s_active = reinterpret_cast<unsigned char*>(s_caps + C);
    unsigned char* s_unf = s_active + N;
    unsigned char* s_hit = s_unf + N;

    const int tid = threadIdx.x, nthr = blockDim.x;
    const int warp = tid / kWarp, lane = tid % kWarp, nwarps = nthr / kWarp;
    const long long s = blockIdx.x;
    const long long m = s % M;           // the lane's member
    const unsigned char* act = active + s * N;
    const float* cap = caps + s * C;
    con_ptr += m * (C + 1);
    ent_task += m * E;
    ent_w += m * E;
    flows += m * N;

    // a malformed CSR would index shared memory out of bounds: a device
    // assert stops the launch (a check on the host would cost a sync)
    for (int i = tid; i <= C; i += nthr) {
        const int v = con_ptr[i];
        assert(i < C ? v <= con_ptr[i + 1] : v == E);
        assert(i > 0 || v == 0);
        s_ptr[i] = v;
    }
    for (int i = tid; i < E; i += nthr) {
        const int t = ent_task[i];
        assert(t >= 0 && t < N);
        s_task[i] = t;
        s_w[i] = ent_w[i];
    }
    for (int i = tid; i < C; i += nthr) s_caps[i] = cap[i];
    int any = 0;
    for (int t = tid; t < N; t += nthr) {
        const unsigned char a = act[t] != 0;
        s_active[t] = a;
        s_unf[t] = a;
        s_hit[t] = 0;
        s_phi[t] = 0.0f;
        any |= a;
    }
    any = __syncthreads_or(any);

    int r = 0;
    while (any && r < C + 1) {
        // 1. per constraint: (used, denom) -> alpha_c
        for (int c = warp; c < C; c += nwarps) {
            float used = 0.0f, denom = 0.0f;
            const int end = s_ptr[c + 1];
            for (int e = s_ptr[c] + lane; e < end; e += kWarp) {
                const int t = s_task[e];
                const float w = s_w[e];
                used = __fadd_rn(
                    used, __fmul_rn(w, s_active[t] ? s_phi[t] : 0.0f));
                denom = __fadd_rn(
                    denom, __fmul_rn(w, s_unf[t] ? 1.0f : 0.0f));
            }
#pragma unroll
            for (int off = kWarp / 2; off > 0; off >>= 1) {
                used = __fadd_rn(used,
                                 __shfl_down_sync(0xffffffffu, used, off));
                denom = __fadd_rn(denom,
                                  __shfl_down_sync(0xffffffffu, denom, off));
            }
            if (lane == 0) {
                s_alpha[c] = denom > 0.0f
                    ? __fdiv_rn(__fsub_rn(s_caps[c], used), denom)
                    : INFINITY;
            }
        }
        __syncthreads();

        // 2. alpha, the saturated constraints' hits, phi += alpha
        float m = INFINITY;
        for (int c = lane; c < C; c += kWarp) m = min_nan(m, s_alpha[c]);
#pragma unroll
        for (int off = kWarp / 2; off > 0; off >>= 1) {
            m = min_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
        }
        const float alpha = m != m ? m : fmaxf(m, 0.0f);
        const float thresh = __fadd_rn(alpha, 1e-18f);
        for (int c = warp; c < C; c += nwarps) {
            const float ac = s_alpha[c];
            if (isfinite(ac) && ac <= thresh) {
                const int end = s_ptr[c + 1];
                for (int e = s_ptr[c] + lane; e < end; e += kWarp) {
                    s_hit[s_task[e]] = 1;
                }
            }
        }
        for (int t = tid; t < N; t += nthr) {
            if (s_unf[t]) s_phi[t] = __fadd_rn(s_phi[t], alpha);
        }
        __syncthreads();

        // 3. freeze the hit tasks; go on while any task is unfrozen
        int left = 0;
        for (int t = tid; t < N; t += nthr) {
            if (s_hit[t]) {
                s_unf[t] = 0;
                s_hit[t] = 0;
            }
            left |= s_unf[t];
        }
        ++r;
        any = __syncthreads_or(left);
    }

    float* out = rates + s * N;
    for (int t = tid; t < N; t += nthr) {
        out[t] = __fmul_rn(__fmul_rn(flows[t], s_phi[t]),
                           s_active[t] ? 1.0f : 0.0f);
    }
    if (tid == 0) rounds[s] = r;
}

}  // namespace

// rates (S, N) and rounds (S,) of S lanes over M members (S a multiple of
// M; lane s reads member s % M): con_ptr (M, C + 1) int32, ent_task (M, E)
// int32, ent_w (M, E) float32 (each member's incidence as CSR by
// constraint: con_ptr rising from 0 to E, every task in [0, N), else a
// device assert), active (S, N) bool, caps (S, C) float32, flows (M, N)
// float32; contiguous.
// Launches on `stream` and returns the launch's cudaError_t (0 on success)
// without synchronising.  A block that needs more shared memory than the
// card lets a block opt in to is refused by cudaFuncSetAttribute (the
// wrapper refuses it first, from the same size).
extern "C" int waterfill_fill_maxmin(const int* con_ptr, const int* ent_task,
                                     const float* ent_w,
                                     const unsigned char* active,
                                     const float* caps, const float* flows,
                                     float* rates, int* rounds, int S, int M,
                                     int N, int C, int E, void* stream) {
    if (S <= 0) return static_cast<int>(cudaSuccess);
    if (C <= 0 || N < 0 || E < 0 || M <= 0 || S % M != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t smem = maxmin_smem_bytes(N, C, E);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            fill_maxmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    fill_maxmin_kernel<<<S, kMaxminThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        con_ptr, ent_task, ent_w, active, caps, flows, rates, rounds, M, N, C,
        E);
    return static_cast<int>(cudaGetLastError());
}
