#!/usr/bin/env python3
"""Design variants of the maxplus and tclosure kernels, timed on one GPU.

    python3 kernel_variants.py

Runs from the root of a checkout, on a machine with a CUDA device and
nvcc, and imports nothing of JAX.  Each variant is the kept source
(`src/repro_torch/kernels/csrc/{maxplus,tclosure}.cu`) with one change
made by text substitution; it is built with the same nvcc flags into
`build/variants/`, checked against the plain version where its result is
meant to be the same, and timed by torch.profiler (device microseconds
per call, by kernel) at megatron-462b's full width: the 801^3 max-plus
product of `longest_paths`' first squaring, and the three squaring steps
of Alg. 2's closure (n = 801).  The variants that change the arithmetic
("timing only") show what bounds the kept kernel.  PERF.md's findings on
the redesign read this script's output.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

MP_SUM = "acc[r][c] = fmaxf(acc[r][c], __fadd_rn(av[r], bv[c]));"
MP_LOOP = """        cp_async_wait_stages();            // unit it has landed (this thread)
        __syncthreads();                   // ... for every thread; and the
                                           // stage of unit it - 1 is free
        if (it + kStages - 1 < count) {
            load_unit(st[ls], a, b, ld, M, K, N);
            ld.next(kc, tiles_n);
        }
        cp_async_commit();"""
MP_MBAR_HELPERS = """constexpr int kStages = 3;
__device__ const float g_neg_inf = -1e30f;

__device__ __forceinline__ uint32_t sa(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mb_init(uint64_t* b, int n) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(sa(b)), "r"(n) : "memory");
}
__device__ __forceinline__ void mb_arrive(uint64_t* b) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(sa(b)) : "memory");
}
__device__ __forceinline__ void mb_cp_arrive(uint64_t* b) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
                 :: "r"(sa(b)) : "memory");
}
__device__ __forceinline__ void mb_wait(uint64_t* b, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile("{\\n.reg .pred p;\\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n"
                     "selp.u32 %0, 1, 0, p;\\n}\\n"
                     : "=r"(done) : "r"(sa(b)), "r"(parity) : "memory");
    }
}"""
MP_MBAR_PROLOGUE = """    __shared__ uint64_t full[kStages], empty[kStages];
    if (threadIdx.x == 0) {
        for (int q = 0; q < kStages; ++q) {
            mb_init(&full[q], kThreads);
            mb_init(&empty[q], kThreads);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kStages - 1; ++p) {
        if (p < count) {
            load_unit(st[p], a, b, ld, M, K, N);
            ld.next(kc, tiles_n);
            mb_cp_arrive(&full[p]);
        }
    }
    int cs = 0, ls = kStages - 1;
    for (int it = 0; it < count; ++it) {
        mb_wait(&full[cs], (it / kStages) & 1);
        const Stage& s = st[cs];
"""
MP_MBAR_TAIL = """        mb_arrive(&empty[cs]);
        cs = cs + 1 == kStages ? 0 : cs + 1;
        if (it + kStages - 1 < count) {
            if (it >= 1) mb_wait(&empty[ls], ((it - 1) / kStages) & 1);
            load_unit(st[ls], a, b, ld, M, K, N);
            ld.next(kc, tiles_n);
            mb_cp_arrive(&full[ls]);
        }
        ls = ls + 1 == kStages ? 0 : ls + 1;
        // the tile's last chunk, or the block's last unit"""


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        cs.fail(f"kernel_variants: the kept source has changed; cannot find "
                f"{old[:60]!r}")
    return src.replace(old, new)


def _between(src: str, start: str, end: str) -> str:
    i = src.index(start)
    return src[i:src.index(end, i)]


def maxplus_variants(src: str) -> dict[str, tuple[str, bool, int]]:
    """name -> (source, same result as the plain version, blocks per SM)."""
    mbar = _sub(src, "constexpr int kStages = 3;", MP_MBAR_HELPERS)
    mbar = _sub(mbar, "                s.a[k][r] = kNegInf;",
                "                cp_async4(&s.a[k][r], &g_neg_inf);")
    mbar = _sub(mbar, "            s.b[k][bc] = kNegInf;",
                "            cp_async4(&s.b[k][bc], &g_neg_inf);")
    prologue = _between(mbar, "    // prologue: the first kStages - 1 units",
                        "#pragma unroll\n        for (int k = 0; k < kBK;")
    mbar = _sub(mbar, prologue, MP_MBAR_PROLOGUE)
    mbar = _sub(mbar, "        // the tile's last chunk, or the block's last "
                "unit", MP_MBAR_TAIL)
    mbar = _sub(mbar, '    asm volatile("cp.async.wait_all;\\n" ::: '
                '"memory");\n}', "}")
    return {
        "kept": (src, True, 1),
        "two blocks per SM (launch bounds 256 x 2)": (_sub(
            src, "__launch_bounds__(kThreads, 1)",
            "__launch_bounds__(kThreads, 2)"), True, 2),
        "per-stage mbarriers, no block barrier": (mbar, True, 1),
        "adds only (timing only)": (_sub(
            src, MP_SUM,
            "acc[r][c] = __fadd_rn(acc[r][c], __fadd_rn(av[r], bv[c]));"),
            False, 1),
        "maxes only (timing only)": (_sub(
            src, MP_SUM, "acc[r][c] = fmaxf(acc[r][c], fmaxf(av[r], bv[c]));"),
            False, 1),
        "no loads after the first unit (timing only)": (_sub(_sub(
            src, MP_LOOP,
            "        if (it == 0) { cp_async_wait_stages(); __syncthreads(); }"),
            "const Stage& s = st[cs];", "const Stage& s = st[0];"), False, 1),
    }


TC_COPY = """    if (warp == 0) {            // a bulk copy per slab, from all 32 lanes
        if (lane == 0) {
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, "
                         "[%0], %1;\\n" :: "r"(bar), "r"(bytes) : "memory");
        }
        __syncwarp();
        for (int s = lane; s < words; s += kWarp) {"""
TC_UNPACK = """    for (int r = warp; r < rows; r += warps) {
        const uint32_t* row = acc + r * ws;
        unpack_row(out, n, blockIdx.x + r * gridDim.x, 0, words, row[w_lo],
                   two ? row[w_hi] : 0u);
    }"""


def tclosure_variants(src: str) -> dict[str, tuple[str, int]]:
    """name -> (source, words of a row per item)."""
    one_thread = _sub(src, TC_COPY, """    if (threadIdx.x == 0) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, "
                     "[%0], %1;\\n" :: "r"(bar), "r"(bytes) : "memory");
        for (int s = 0; s < words; ++s) {""")
    column = _sub(src, TC_UNPACK, """\
    for (int e = threadIdx.x; e < rows * words * kWarp; e += blockDim.x) {
        const int r = e / (words * kWarp), c = e % (words * kWarp);
        if (c < n) {
            out[static_cast<long long>(blockIdx.x + r * gridDim.x) * n + c] =
                (acc[r * ws + c / kWarp] >> (c % kWarp)) & 1u;
        }
    }""")
    return {
        "kept": (src, 2),
        "slab copies issued by one thread": (one_thread, 2),
        "items of 1 word": (_sub(src, "constexpr int kChunkWords = 2;",
                                 "constexpr int kChunkWords = 1;"), 1),
        "items of 4 words": (_sub(src, "constexpr int kChunkWords = 2;",
                                  "constexpr int kChunkWords = 4;"), 4),
        "a thread per column in the unpack": (column, 2),
    }


def _build_all(kernel: str, sources: dict[str, str]
               ) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import _build
    out_dir = cs.ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build._nvcc(), {}
    for i, (name, text) in enumerate(sources.items()):
        cu = out_dir / f"{kernel}-{i}.cu"
        cu.write_text(text)
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"kernel_variants: {name} does not build:\n{out}")
        used = [line.split(":", 1)[1].strip() for line in out.splitlines()
                if "Used" in line]
        cs.log(f"[variants] built {name}: {'; '.join(used)}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def _time(fn) -> str:
    by = cs._device_us_by_kernel(fn)
    return ", ".join(f"{k} {v:.3f}" for k, v in by.items()) \
        + f"; {sum(by.values()):.3f} us in all"


def run_maxplus(dag) -> None:
    import torch
    from repro_torch.kernels import _build, maxplus
    from repro_torch.kernels.ref import maxplus_ref
    variants = maxplus_variants((_build.CSRC / "maxplus.cu").read_text())
    libs = _build_all("maxplus", {k: v[0] for k, v in variants.items()})
    dev = torch.device("cuda")
    d0 = cs._paths_start(dag, dev)
    n = d0.shape[0]
    want = maxplus_ref(d0, d0)
    big = torch.rand((4096, 4096), device=dev) * 10
    sms = _build.sm_count(dev.index)
    for name, (_, same, per_sm) in variants.items():
        fn = libs[name].maxplus
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def product(a, fn=fn, per_sm=per_sm):
            m, k = a.shape
            p = maxplus.plan(m, k, m, per_sm * sms)
            out = torch.empty_like(a)
            ws = torch.empty((p.blocks * p.max_seg, maxplus.BM * maxplus.BN),
                             device=dev)
            err = fn(a.data_ptr(), a.data_ptr(), out.data_ptr(),
                     ws.data_ptr(), m, k, m, p.blocks, p.max_seg,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                cs.fail(f"kernel_variants: {name} launch failed ({err})")
            return out
        got = product(d0)
        torch.cuda.synchronize()
        if same and not torch.equal(got, want):
            cs.fail(f"kernel_variants: maxplus variant {name} is not "
                    f"bit-equal to the plain version")
        cs.log(f"[variants] maxplus {n}^3, {name}"
               f"{', bit-equal' if same else ''}: {_time(lambda: product(d0))}")
        if name in ("kept", "per-stage mbarriers, no block barrier"):
            cs.log(f"[variants] maxplus 4096^3, {name}: "
                   f"{_time(lambda: product(big))}")


def run_tclosure(dag) -> None:
    import torch
    from repro_torch.core.xbound import dep_adjacency
    from repro_torch.kernels import _build, tclosure
    from repro_torch.kernels.ref import tclosure_step_ref
    variants = tclosure_variants((_build.CSRC / "tclosure.cu").read_text())
    libs = _build_all("tclosure", {k: v[0] for k, v in variants.items()})
    dev = torch.device("cuda")
    steps = [dep_adjacency(dag, dev)]
    for _ in range(2):
        steps.append(tclosure_step_ref(steps[-1]))
    zero = torch.zeros_like(steps[0])
    kernel, chunk = tclosure._kernel, tclosure.CHUNK_WORDS
    try:
        for name, (_, words) in variants.items():
            fn = libs[name].tclosure_step
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_void_p] + [ctypes.c_int] * 5 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            tclosure._kernel = lambda fn=fn: fn
            tclosure.CHUNK_WORDS = words
            tclosure.plan.cache_clear()
            for a in steps:
                if not torch.equal(tclosure.tclosure_step(a),
                                   tclosure_step_ref(a)):
                    cs.fail(f"kernel_variants: tclosure variant {name} is "
                            f"not bit-equal to the plain version")
            for i, a in enumerate(steps, 1):
                cs.log(f"[variants] tclosure n={a.shape[0]} step {i}, {name}, "
                       f"bit-equal: {_time(lambda: tclosure.tclosure_step(a))}")
            if name == "kept":
                cs.log(f"[variants] tclosure n={zero.shape[0]} all-zero "
                       f"matrix, kept: "
                       f"{_time(lambda: tclosure.tclosure_step(zero))}")
    finally:
        tclosure._kernel, tclosure.CHUNK_WORDS = kernel, chunk
        tclosure.plan.cache_clear()


def main() -> int:
    cs.phase_device()
    dag = cs._megatron_462b()
    run_maxplus(dag)
    run_tclosure(dag)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    cs.log(f"[variants] SM clock, power draw: {smi.stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
