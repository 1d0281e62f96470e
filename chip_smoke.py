#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and drives the port (`src/repro_torch`)
only; it imports nothing of JAX or of the JAX package `repro`.  Phases:

  1. device   torch/CUDA versions, the card's name and power limit;
  2. build    every kernel of the main path, with nvcc, from the sources
              in the checkout;
  3. kernels  each kernel against its plain-torch version on the card
              (the shape sweep of tests/test_kernels.py and the main
              path's shape), with its time, the plain version's, one
              PyTorch library call's and the card's bound;
  4. DES      the torch DES at the full width of megatron-462b (paper
              Table I: 1,024 GPUs, 32 pods) against the exact numpy DES,
              and a 48-genome batch against 48 single simulations;
  5. plan     the slice end to end: plan(PlanRequest(method="delta-fast"))
              for 5 GA generations of 48 genomes, twice, with the kernel
              launch counts of the first run and identical topologies;
              and the GA on the card against the GA on the CPU at a small
              size.

Any failed check or error exits non-zero.  Without a CUDA device, or
without the port beside it, it exits non-zero before printing a result.
The second-to-last line of standard output is the kernels' JSON record;
the last is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
F32_PEAK = 67e12        # H100 SXM float32 FLOP/s outside the tensor cores
HBM_RATE = 3.35e12      # H100 SXM HBM3 bytes/s
KERNEL_RTOL = KERNEL_ATOL = 1e-5
DES_RTOL = 5e-5
# (C, N) sweep of tests/test_kernels.py:79-106
SWEEP = [(3, 5), (100, 257), (130, 64), (1, 1), (128, 128), (34, 273)]


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


def bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_RATE, flops / F32_PEAK
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
    from repro_torch.kernels import waterfill
    log(f"[build] repro_torch sets tf32: matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
        f"{torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    lib = waterfill.build()
    log(f"[build] waterfill.cu -> {lib.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s")


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


def phase_kernels() -> dict:
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
    from repro_torch.kernels import waterfill
    from repro_torch.obs import REGISTRY
    waterfill.launches = 0
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


def main() -> int:
    phase_device()
    import torch
    phase_build()
    record = phase_kernels()
    dag = _megatron_462b()
    phase_des(dag)
    record["launches"] = phase_plan(dag)
    phase_small_parity()
    log(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
