#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and drives the port (`src/repro_torch`)
only; it imports nothing of JAX or of the JAX package `repro`.  Phases:

  1. device   torch/CUDA versions, the card's name and power limit;
  2. build    every kernel of the port (waterfill, tclosure, maxplus), one
              nvcc each, all started together, from the sources in the
              checkout, with ptxas's register and shared-memory report;
  3. kernels  each kernel against its plain-torch version on the card
              (the shape and dtype sweeps of tests/test_kernels.py and the
              shape its path gives it at full width: bit equality for
              tclosure and maxplus), with its time, the plain version's,
              one PyTorch library call's and the card's bound;
  4. DES      the torch DES at the full width of megatron-462b (paper
              Table I: 1,024 GPUs, 32 pods) against the exact numpy DES,
              and a 48-genome batch against 48 single simulations;
  5. plan     the slice end to end: plan(PlanRequest(method="delta-fast"))
              for 5 GA generations of 48 genomes, twice, with the kernel
              launch counts of the first run and identical topologies;
              and the GA on the card against the GA on the CPU at a small
              size;
  6. xbound   Alg. 2 on megatron-462b with the closure by matrix squaring
              (the tclosure kernel) against the bitset closure: the same
              reachability and the same X-bar;
  7. paths    all-pairs longest paths by max-plus squaring (the maxplus
              kernel) on megatron-462b's dependency weights: row VIRTUAL
              is Alg. 4's EST; and the Bellman check of
              tests/test_kernels.py.

Any failed check or error exits non-zero.  Without a CUDA device, or
without the port beside it, it exits non-zero before printing a result.
The second-to-last line of standard output is the kernels' JSON record;
the last is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
F32_PEAK = 67e12        # H100 SXM float32 FLOP/s outside the tensor cores
F32_INSTR = F32_PEAK / 2  # float32 instructions/s: the peak counts FMA as 2
INT8_PEAK = 1979e12     # H100 SXM int8 tensor-core OP/s, dense
HBM_RATE = 3.35e12      # H100 SXM HBM3 bytes/s
KERNEL_RTOL = KERNEL_ATOL = 1e-5
DES_RTOL = 5e-5
# (C, N) sweep of tests/test_kernels.py:79-106
SWEEP = [(3, 5), (100, 257), (130, 64), (1, 1), (128, 128), (34, 273)]
# tclosure and maxplus sweeps of tests/test_kernels.py:16-57
TC_SIZES = [1, 5, 64, 127, 128, 130, 257]
TC_DENSITIES = [0.02, 0.2]
MP_SHAPES = [(3, 4, 5), (64, 64, 64), (130, 17, 70), (1, 1, 1),
             (128, 128, 128)]
KERNELS = ("waterfill", "tclosure", "maxplus")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def log(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean milliseconds per call, CUDA events around back-to-back calls
    (what a caller in a loop pays, launch included)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(bytes_moved: float, ops: float, rate: float = F32_PEAK
             ) -> tuple[float, str]:
    """The least time for the work: bytes at the HBM rate or `ops` at
    `rate`, whichever is longer, and which of the two it is."""
    t_bytes, t_ops = bytes_moved / HBM_RATE, ops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA device")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it "
             f"from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"[device] python {sys.version.split()[0]} torch {torch.__version__}"
        f" cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    log(smi.stdout.strip().splitlines()[0])


def phase_build():
    import torch
    from repro_torch.kernels import _build
    log(f"[build] repro_torch sets tf32: matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
        f"{torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    libs = _build.build(*KERNELS)
    log(f"[build] {', '.join(f'{k}.cu' for k in KERNELS)} (one nvcc each, "
        f"in parallel) in {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        report = [line.split(":", 1)[-1].strip() for line in
                  lib.with_suffix(".log").read_text().splitlines()
                  if "Used" in line or "spill" in line]
        log(f"[build] {lib.relative_to(ROOT)}: {'; '.join(report)}")


def _check_close(name: str, got, want) -> tuple[float, float]:
    import torch
    err = (got - want).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    max_rel = float((err / want.abs().clamp_min(1e-30)).max()) \
        if err.numel() else 0.0
    if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs {max_abs:.3e}, max rel {max_rel:.3e})")
    return max_abs, max_rel


def kernel_waterfill() -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import ops, waterfill
    from repro_torch.kernels.ref import fill_matvec_ref, fill_round_ref
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def w_of(c, n):
        return torch.from_numpy((rng.random((c, n))
                                 * (rng.random((c, n)) < 0.3))
                                .astype(np.float32)).to(dev)

    worst = 0.0
    for c, n in SWEEP:
        for r in (1, 2, 3):
            for batch in (None, 48):
                w = w_of(c, n)
                shape = (n, r) if batch is None else (batch, n, r)
                rhs = torch.from_numpy(rng.random(shape).astype(np.float32)
                                       ).to(dev)
                got = ops.fill_matvec(w, rhs, backend="cuda")
                torch.cuda.synchronize()
                a, _ = _check_close(f"fill_matvec C={c} N={n} R={r} "
                                    f"B={batch}", got, fill_matvec_ref(w,
                                                                       rhs))
                worst = max(worst, a)
    log(f"[kernels] fill_matvec sweep {len(SWEEP)}x3x2 cases within "
        f"rtol/atol {KERNEL_RTOL:g}: max abs err {worst:.3e}")

    # the main path's shape: a 48-lane population round on megatron-462b's
    # padded incidence (C=80 constraints, N=832 tasks), R=2 (level, unfrozen)
    B, C, N, R = 48, 80, 832, 2
    w = w_of(C, N)
    level = torch.from_numpy(rng.random((B, N)).astype(np.float32)).to(dev)
    unfrozen = torch.from_numpy((rng.random((B, N)) < 0.5)
                                .astype(np.float32)).to(dev)
    used, denom = ops.fill_round(w, level, unfrozen, backend="cuda")
    u_ref, d_ref = fill_round_ref(w, level, unfrozen)
    torch.cuda.synchronize()
    a1, r1 = _check_close("fill_round main shape (used)", used, u_ref)
    a2, r2 = _check_close("fill_round main shape (denom)", denom, d_ref)
    rhs = torch.stack([level, unfrozen], -1)
    got = ops.fill_matvec(w, rhs, backend="cuda")
    if not torch.equal(got, ops.fill_matvec(w, rhs, backend="cuda")):
        fail("fill_matvec is not bit-identical run to run")
    max_abs = max(a1, a2)
    log(f"[kernels] fill_round B={B} C={C} N={N}: max abs err "
        f"{max_abs:.3e}, max rel err {max(r1, r2):.3e}; bit-identical "
        f"rerun")

    ms = time_ms(lambda: waterfill.fill_matvec(w, rhs))
    plain_ms = time_ms(lambda: fill_matvec_ref(w, rhs))
    library_ms = time_ms(lambda: torch.matmul(w, rhs))
    round_ms = time_ms(lambda: waterfill.fill_round(w, level, unfrozen))
    b_ms, b_by = bound_ms(4.0 * (C * N + B * N * R + B * C * R),
                          2.0 * B * C * N * R)
    log(f"[kernels] fill_matvec B={B} C={C} N={N} R={R}: kernel {ms:.5f} ms"
        f"/call, plain {plain_ms:.5f}, torch.matmul {library_ms:.5f}, "
        f"fill_round (stack + kernel) {round_ms:.5f}, bound {b_ms:.6f} ms "
        f"({b_by})")
    dev_us = {name: _device_us_per_call(fn) for name, fn in (
        ("kernel", lambda: waterfill.fill_matvec(w, rhs)),
        ("plain", lambda: fill_matvec_ref(w, rhs)),
        ("torch.matmul", lambda: torch.matmul(w, rhs)))}
    log("[kernels] device time per call (profiler): " + ", ".join(
        f"{k} {v}" for k, v in dev_us.items()))
    return {"name": "waterfill.fill_matvec", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/waterfill.cu",
            "replaces": "src/repro/kernels/waterfill.py:47",
            "launches": None, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}


def _bits_equal(name: str, got, want) -> None:
    import torch
    if got.shape != want.shape or got.dtype != want.dtype \
            or not torch.equal(got, want):
        diff = (got != want).sum().item() if got.shape == want.shape \
            else "shape"
        fail(f"{name}: kernel is not bit-equal to its plain version "
             f"({got.dtype}{tuple(got.shape)} vs {want.dtype}"
             f"{tuple(want.shape)}, {diff} entries differ)")


def _paths_start(dag, device):
    """The matrix longest_paths squares first on megatron-462b: the
    dependency weights (float32) with the diagonal forced to 0."""
    import torch
    from repro_torch.core.pruning import dep_weights
    w = torch.from_numpy(dep_weights(dag)).to(device, torch.float32)
    return torch.maximum(w, torch.full_like(w, -1e30).fill_diagonal_(0.0))


def kernel_tclosure(dag) -> tuple[dict, int]:
    """The tclosure kernel against its plain version; returns its record
    and the squaring steps of megatron-462b's closure."""
    import numpy as np
    import torch
    from repro_torch.core.xbound import dep_adjacency
    from repro_torch.kernels import ops, tclosure
    from repro_torch.kernels.ref import tclosure_step_ref
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    cases = 0
    for n in TC_SIZES:
        for density in TC_DENSITIES:
            a = torch.from_numpy(rng.random((n, n)) < density).to(dev)
            for dtype in (torch.bool, torch.int8, torch.int32,
                          torch.float32):
                x = a.to(dtype)
                _bits_equal(f"tclosure_step n={n} density={density} "
                            f"{dtype}", ops.tclosure_step(x, backend="cuda"),
                            tclosure_step_ref(x))
                cases += 1
    torch.cuda.synchronize()
    log(f"[kernels] tclosure_step sweep {cases} cases (n x density x "
        f"dtype): bit-equal to the plain version")

    # full width: every squaring step of megatron-462b's closure
    adj = dep_adjacency(dag, dev)
    n = adj.shape[0]
    a = adj
    for steps in range(1, 2 + math.ceil(math.log2(n))):
        got = ops.tclosure_step(a, backend="cuda")
        _bits_equal(f"tclosure_step n={n} step {steps}", got,
                    tclosure_step_ref(a))
        if torch.equal(got, a):
            break
        a = got
    else:
        fail(f"tclosure_step n={n}: no fixed point in {steps} steps")
    if not torch.equal(ops.tclosure_step(adj, backend="cuda"),
                       ops.tclosure_step(adj, backend="cuda")):
        fail("tclosure_step is not bit-identical run to run")
    log(f"[kernels] tclosure_step n={n} (megatron-462b adjacency, "
        f"{int(adj.sum())} edges): {steps} steps to the fixed point, each "
        f"bit-equal to the plain version; bit-identical rerun")

    f = adj.to(torch.float32)
    ms = time_ms(lambda: tclosure.tclosure_step(adj))
    plain_ms = time_ms(lambda: tclosure_step_ref(adj))
    library_ms = time_ms(lambda: torch.matmul(f, f))
    # bool in and out; the product counted as the dense int8 product an
    # exact tensor-core version would run (2 n^3 at the int8 peak)
    b_ms, b_by = bound_ms(2.0 * n * n, 2.0 * n ** 3, INT8_PEAK)
    log(f"[kernels] tclosure_step n={n}: kernel {ms:.5f} ms/call, plain "
        f"{plain_ms:.5f}, torch.matmul (f32) {library_ms:.5f}, bound "
        f"{b_ms:.6f} ms ({b_by})")
    dev_us = {name: _device_us_per_call(fn) for name, fn in (
        ("kernel", lambda: tclosure.tclosure_step(adj)),
        ("plain", lambda: tclosure_step_ref(adj)),
        ("torch.matmul", lambda: torch.matmul(f, f)))}
    log("[kernels] device time per call (profiler): " + ", ".join(
        f"{k} {v}" for k, v in dev_us.items()))
    by_kernel = _device_us_by_kernel(lambda: tclosure.tclosure_step(adj))
    log("[kernels] tclosure_step device time by kernel (profiler): "
        + ", ".join(f"{k} {v:.3f} us" for k, v in by_kernel.items()))
    return {"name": "tclosure.tclosure_step", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/tclosure.cu",
            "replaces": "src/repro/kernels/tclosure.py:41",
            "launches": None, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}, steps


def kernel_maxplus(dag) -> tuple[dict, int]:
    """The maxplus kernel against its plain version; returns its record
    and the squaring steps of megatron-462b's longest paths."""
    import numpy as np
    import torch
    from repro_torch.kernels import maxplus, ops
    from repro_torch.kernels.ref import NEG_INF, maxplus_ref
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)

    def sparse(m, k):
        return torch.from_numpy(np.where(
            rng.random((m, k)) < 0.4, rng.random((m, k)) * 10, NEG_INF)
            .astype(np.float32)).to(dev)

    for m, k, n in MP_SHAPES:
        a, b = sparse(m, k), sparse(k, n)
        _bits_equal(f"maxplus {m}x{k}x{n}", ops.maxplus(a, b, backend="cuda"),
                    maxplus_ref(a, b))
    torch.cuda.synchronize()
    log(f"[kernels] maxplus sweep {len(MP_SHAPES)} shapes: bit-equal to "
        f"the plain version")

    # full width: every squaring step of longest_paths on megatron-462b
    d0 = _paths_start(dag, dev)
    n = d0.shape[0]
    d = d0
    for steps in range(1, 2 + math.ceil(math.log2(n))):
        got = ops.maxplus(d, d, backend="cuda")
        _bits_equal(f"maxplus {n}x{n}x{n} step {steps}", got,
                    maxplus_ref(d, d))
        if torch.allclose(got, d):
            break
        d = got
    else:
        fail(f"maxplus {n}x{n}x{n}: no fixed point in {steps} squarings")
    if not torch.equal(ops.maxplus(d0, d0, backend="cuda"),
                       ops.maxplus(d0, d0, backend="cuda")):
        fail("maxplus is not bit-identical run to run")
    log(f"[kernels] maxplus {n}x{n}x{n} (megatron-462b dependency "
        f"weights): {steps} squarings to the fixed point, each bit-equal "
        f"to the plain version; bit-identical rerun")

    ms = time_ms(lambda: maxplus.maxplus(d0, d0))
    plain_ms = time_ms(lambda: maxplus_ref(d0, d0), iters=20, warmup=3)
    b_ms, b_by = bound_ms(4.0 * 3 * n * n, 2.0 * n ** 3, F32_INSTR)
    log(f"[kernels] maxplus {n}x{n}x{n}: kernel {ms:.5f} ms/call, plain "
        f"{plain_ms:.5f}, no library call, bound {b_ms:.6f} ms ({b_by})")
    dev_us = {name: _device_us_per_call(fn, iters) for name, fn, iters in (
        ("kernel", lambda: maxplus.maxplus(d0, d0), 50),
        ("plain", lambda: maxplus_ref(d0, d0), 5))}
    log("[kernels] device time per call (profiler): " + ", ".join(
        f"{k} {v}" for k, v in dev_us.items()))
    return {"name": "maxplus.maxplus", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/maxplus.cu",
            "replaces": "src/repro/kernels/maxplus.py:40",
            "launches": None, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}, steps


def _device_busy_s(fn) -> float:
    """Seconds the device spent in kernels and copies during one call of
    `fn`, from a torch.profiler trace (0.0 when the trace holds no device
    time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return 1e-6 * sum(ev.device_time_total for ev in prof.events()
                      if ev.device_type == torch.autograd.DeviceType.CUDA)


def _device_us_per_call(fn, iters: int = 50) -> str:
    busy_s = _device_busy_s(lambda: [fn() for _ in range(iters)])
    return f"{busy_s * 1e6 / iters:.3f} us" if busy_s else "not measured"


def _device_us_by_kernel(fn, iters: int = 50) -> dict[str, float]:
    """Device microseconds per call of `fn`, by kernel name, from a
    torch.profiler trace of `iters` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_time_total > 0:
            m = re.search(r"::(\w+)", ev.key)   # drop namespaces and types
            out[m.group(1) if m else ev.key[:40]] = \
                ev.device_time_total / iters
    return out


def _megatron_462b():
    from repro_torch.configs import PAPER_WORKLOADS, make_job
    from repro_torch.core.schedule import build_comm_dag
    job = make_job(PAPER_WORKLOADS["megatron-462b"], seq_len=4096)
    dag = build_comm_dag(job, 400.0)
    n, deps, pods = dag.num_tasks, len(dag.deps), dag.cluster.num_pods
    log(f"[des] megatron-462b Table I: {job.tp * job.pp * job.dp} GPUs, "
        f"{job.num_microbatches} microbatches, {n} tasks, {deps} deps, "
        f"{pods} pods")
    if (n, deps, pods) != (801, 88096, 32):
        fail(f"megatron-462b DAG is ({n}, {deps}, {pods}), expected "
             f"(801, 88096, 32)")
    return dag


def _counts():
    from repro_torch.kernels import waterfill
    from repro_torch.obs import REGISTRY
    return {"launches": waterfill.launches,
            "trips": REGISTRY.counter("des_event_trips_total").value(),
            "rounds": REGISTRY.counter("des_fill_rounds_total").value()}


def _reset_counts() -> None:
    from repro_torch.kernels import maxplus, tclosure, waterfill
    from repro_torch.obs import REGISTRY
    waterfill.launches = tclosure.launches = maxplus.launches = 0
    REGISTRY.counter("des_event_trips_total").reset()
    REGISTRY.counter("des_fill_rounds_total").reset()


def phase_des(dag) -> None:
    import numpy as np
    import torch
    from repro_torch.core.baselines import BASELINES
    from repro_torch.core.des import DESProblem, simulate
    from repro_torch.core.des_torch import TorchDES
    from repro_torch.core.ga import TopologySpace

    prob = DESProblem(dag)
    t0 = time.perf_counter()
    des = TorchDES(prob)
    log(f"[des] TorchDES device {des.device} backend {des.backend} pad "
        f"{tuple(des.pad)} built in {time.perf_counter() - t0:.2f} s")
    if des.backend != "cuda":
        fail(f"TorchDES took backend {des.backend!r}, not the kernel")
    for name in ("prop-alloc", "sqrt-alloc"):
        x = BASELINES[name](dag)
        t0 = time.perf_counter()
        want = simulate(prob, x)
        t_np = time.perf_counter() - t0
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms, feas, _, _ = des.simulate(x)
        t_dev = time.perf_counter() - t0
        c = _counts()
        rel = abs(ms - want.makespan) / want.makespan
        log(f"[des] {name} ({int(x.sum())} ports): numpy {want.makespan!r}"
            f" ({t_np:.3f} s), torch {ms!r} ({t_dev:.3f} s), rel "
            f"{rel:.3e}; {c['trips']:.0f} trips, {c['rounds']:.0f} rounds, "
            f"{c['launches']} launches")
        if feas != want.feasible or not rel <= DES_RTOL:
            fail(f"{name}: torch DES {ms} vs numpy {want.makespan} "
                 f"(rel {rel:.3e} > {DES_RTOL:g})")
        if c["launches"] != c["rounds"] or c["launches"] == 0:
            fail(f"{name}: {c['launches']} kernel launches for "
                 f"{c['rounds']} filling rounds: a round missed the kernel")

    space = TopologySpace(dag)
    genomes = space.random_init_batch(np.random.default_rng(0), 48)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms_b, feas_b = des.batch_genome_makespan(genomes, space.edge_u,
                                             space.edge_v)
    t_batch = time.perf_counter() - t0
    busy_s = _device_busy_s(lambda: des.batch_genome_makespan(
        genomes, space.edge_u, space.edge_v))
    log(f"[des] 48-genome batch: {t_batch:.4f} s wall; device busy "
        f"{busy_s:.4f} s (profiled rerun), idle share "
        + (f"{1.0 - busy_s / t_batch:.4f}" if busy_s else "not measured"))
    t0 = time.perf_counter()
    worst = 0.0
    for i, x in enumerate(space.to_matrix_batch(genomes)):
        ms, feas, _, _ = des.simulate(x)
        if feas != bool(feas_b[i]):
            fail(f"genome {i}: batched feasible {feas_b[i]}, single {feas}")
        if feas:
            worst = max(worst, abs(ms - ms_b[i]) / ms)
    t_single = time.perf_counter() - t0
    log(f"[des] 48 single calls {t_single:.2f} s; max rel diff from the "
        f"batch {worst:.3e} ({int(feas_b.sum())} of 48 feasible)")
    if not worst <= 1e-6:
        fail(f"batched makespans differ from single ones by rel {worst}")


def phase_plan(dag) -> int:
    import numpy as np
    from repro_torch import obs
    from repro_torch.core.api import PlanRequest, plan
    from repro_torch.core.ga import GAOptions

    def opts():
        return GAOptions(seed=0, pop_size=48, max_generations=5,
                         patience=60, time_limit=1e9)

    results = []
    for run in (1, 2):
        obs.TRACER.clear()
        _reset_counts()             # the main path's counts start at 0
        t0 = time.perf_counter()
        with obs.enabled():
            res = plan(PlanRequest(dag=dag, method="delta-fast",
                                   ga_options=opts()))
        wall = time.perf_counter() - t0
        c = _counts()
        spans = obs.TRACER.summary()
        gens = res.details["generations"]
        batches = spans["ga.fitness_batch"]["count"]
        gen_s = spans["ga.generation"]["total_s"] / max(gens, 1)
        log(f"[plan] run {run}: makespan {float(res.makespan)!r} s, NCT "
            f"{float(res.nct)!r}, {res.total_ports} ports, {gens} "
            f"generations, {res.details['evaluations']} evaluations, plan "
            f"{wall:.2f} s, {gen_s:.3f} s/generation")
        log(f"[plan] run {run}: {batches} fitness batches, per batch "
            f"{c['trips'] / batches:.1f} trips, {c['rounds'] / batches:.1f}"
            f" rounds, {c['launches'] / batches:.1f} kernel launches; "
            f"totals {c['trips']:.0f} / {c['rounds']:.0f} / "
            f"{c['launches']}")
        if gens != 5 or not res.feasible or not np.isfinite(res.makespan) \
                or not 0.0 < res.nct < np.inf:
            fail(f"plan run {run}: generations {gens}, feasible "
                 f"{res.feasible}, makespan {res.makespan}, nct {res.nct}")
        if c["launches"] == 0 or c["launches"] != c["rounds"]:
            fail(f"plan run {run}: {c['launches']} kernel launches for "
                 f"{c['rounds']} filling rounds")
        results.append((res, c))
    (a, ca), (b, _) = results
    if not np.array_equal(a.x, b.x) or a.makespan != b.makespan:
        fail("plan() gave different topologies on two runs with one seed")
    log("[plan] two runs: identical x and makespan")
    return ca["launches"]


def phase_small_parity() -> None:
    """The GA at a small size on the card's kernel and on the CPU's plain
    path: same seed, same topology."""
    import numpy as np
    from repro_torch.configs import PAPER_WORKLOADS, make_job
    from repro_torch.core.api import PlanRequest, plan
    from repro_torch.core.des_torch import DESOptions
    from repro_torch.core.ga import GAOptions
    from repro_torch.core.schedule import build_comm_dag
    dag = build_comm_dag(make_job(PAPER_WORKLOADS["gpt-7b"]), 400.0)
    kw = dict(seed=0, pop_size=16, max_generations=6, patience=60,
              time_limit=1e9)
    card = plan(PlanRequest(dag=dag, ga_options=GAOptions(**kw)))
    cpu = plan(PlanRequest(dag=dag, ga_options=GAOptions(**kw),
                           des_options=DESOptions(device="cpu")))
    same = bool(np.array_equal(card.x, cpu.x))
    rel = abs(card.makespan - cpu.makespan) / cpu.makespan
    log(f"[plan] gpt-7b ({dag.num_tasks} tasks): card {card.makespan!r}, "
        f"cpu {cpu.makespan!r}, rel {rel:.3e}, identical x {same}")
    if not rel <= DES_RTOL:
        fail(f"gpt-7b plan on the card {card.makespan} vs the CPU "
             f"{cpu.makespan}")


def phase_xbound(dag, steps: int) -> tuple[int, float]:
    """Alg. 2 with the closure by matrix squaring on the card against the
    bitset closure, each run launching one kernel per squaring step;
    returns the tclosure launches of the x_upper_bound run and the t_up
    both runs share."""
    import numpy as np
    from repro_torch.core.des import DESProblem
    from repro_torch.core.pruning import estimate_t_up
    from repro_torch.core.xbound import (reachability_bitset,
                                         reachability_kernel, x_upper_bound)
    from repro_torch.kernels import tclosure

    _reset_counts()
    t0 = time.perf_counter()
    reach = reachability_kernel(dag)
    t_kernel = time.perf_counter() - t0
    launches = tclosure.launches
    t0 = time.perf_counter()
    want = reachability_bitset(dag)
    t_bitset = time.perf_counter() - t0
    log(f"[xbound] reachability n={dag.num_tasks}: kernel {t_kernel:.4f} s "
        f"({launches} tclosure launches, {steps} squaring steps), bitset "
        f"{t_bitset:.4f} s; {int(want.sum())} reachable pairs")
    if not np.array_equal(reach, want):
        fail(f"reachability on the kernel differs from the bitset in "
             f"{int((reach != want).sum())} pairs")
    if launches != steps:
        fail(f"reachability: {launches} tclosure launches for {steps} "
             f"squaring steps")

    t_up = estimate_t_up(DESProblem(dag))
    _reset_counts()             # the slice's path: its counts start at 0
    t0 = time.perf_counter()
    xbar = x_upper_bound(dag, t_up, closure_backend="kernel")
    t_kernel = time.perf_counter() - t0
    launches = tclosure.launches
    t0 = time.perf_counter()
    xbar_bitset = x_upper_bound(dag, t_up, closure_backend="bitset")
    t_bitset = time.perf_counter() - t0
    log(f"[xbound] x_upper_bound t_up {t_up!r} s: kernel closure "
        f"{t_kernel:.3f} s ({launches} tclosure launches), bitset "
        f"{t_bitset:.3f} s; X-bar sums to {int(xbar.sum())}")
    if not np.array_equal(xbar, xbar_bitset):
        fail("X-bar on the kernel closure differs from X-bar on the bitset")
    if launches != steps:
        fail(f"x_upper_bound: {launches} tclosure launches for {steps} "
             f"squaring steps")
    return launches, t_up


def phase_paths(dag, t_up: float, steps: int) -> int:
    """All-pairs longest paths by max-plus squaring on the card, one
    launch per squaring step: row VIRTUAL against Alg. 4's EST, and the
    Bellman check at n = 24; returns the maxplus launches of the
    longest_paths run."""
    import numpy as np
    import torch
    from repro_torch.core.dag import VIRTUAL
    from repro_torch.core.pruning import cal_task_time_windows, dep_weights
    from repro_torch.kernels import maxplus, ops
    from repro_torch.kernels.ref import NEG_INF

    w = torch.from_numpy(dep_weights(dag)).to("cuda", torch.float32)
    est, _ = cal_task_time_windows(dag, t_up)
    _reset_counts()             # the slice's path: its counts start at 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp = ops.longest_paths(w)
    torch.cuda.synchronize()
    t_lp = time.perf_counter() - t0
    launches = maxplus.launches
    row = lp[VIRTUAL].double().cpu().numpy()
    err = float(np.abs(row - est).max())
    atol = 1e-5 * float(est.max())
    log(f"[paths] longest_paths n={dag.num_tasks}: {launches} maxplus "
        f"launches, {steps} squaring steps, {t_lp:.4f} s; row VIRTUAL vs "
        f"Alg. 4 EST: max abs err {err:.3e} (atol {atol:.3e}, max EST "
        f"{float(est.max())!r} s)")
    if not (row > NEG_INF / 2).all() or not err <= atol:
        fail(f"longest_paths row VIRTUAL differs from the EST by {err} "
             f"(> {atol}) or leaves a task unreached")
    if launches != steps:
        fail(f"longest_paths: {launches} maxplus launches for {steps} "
             f"squaring steps")

    # the Bellman check of tests/test_kernels.py:59-76
    n = 24
    rng = np.random.default_rng(24)
    adj_mask = np.triu(rng.random((n, n)) < 0.2, k=1)
    adj = np.where(adj_mask, rng.random((n, n)) * 5, NEG_INF) \
        .astype(np.float32)
    got = ops.longest_paths(torch.from_numpy(adj).cuda()).cpu().numpy()
    dist = np.where(np.eye(n, dtype=bool), 0.0, NEG_INF)
    for _ in range(n):
        nd = dist.copy()
        for i, j in zip(*np.nonzero(adj_mask)):
            nd[:, j] = np.maximum(nd[:, j], dist[:, i] + adj[i, j])
        dist = nd
    mask = dist > NEG_INF / 2
    if not np.allclose(got[mask], dist[mask], rtol=1e-5) \
            or not (got[~mask] <= NEG_INF / 2 + 1).all():
        fail("longest_paths on the card disagrees with the Bellman loop")
    log(f"[paths] Bellman check n={n}: longest_paths on the card agrees "
        f"(rtol 1e-5)")
    return launches


def main() -> int:
    phase_device()
    import torch
    phase_build()
    dag = _megatron_462b()
    waterfill = kernel_waterfill()
    tclosure, closure_steps = kernel_tclosure(dag)
    maxplus, paths_steps = kernel_maxplus(dag)
    phase_des(dag)
    waterfill["launches"] = phase_plan(dag)
    phase_small_parity()
    tclosure["launches"], t_up = phase_xbound(dag, closure_steps)
    maxplus["launches"] = phase_paths(dag, t_up, paths_steps)
    log(json.dumps({"kernels": [waterfill, tclosure, maxplus]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
