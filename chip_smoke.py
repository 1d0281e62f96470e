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
              tclosure and maxplus; the fused filling kernel over a sweep
              and on megatron-462b's CSR at 48 lanes, with equal rounds),
              with its time, the plain version's, one PyTorch library
              call's and the card's bound;
  4. DES      the torch DES at the full width of megatron-462b (paper
              Table I: 1,024 GPUs, 32 pods) against the exact numpy DES on
              the fused path ('cuda': one fill_maxmin launch per trip) and
              on the per-round path ('cuda-round': one fill_round launch
              per round); a 48-genome batch in turns on both paths (round,
              fused, fused, round) with wall time, device busy time, idle
              share and host syncs per trip, the host's torch ops and the
              device's kernels of one fused trip, and the batch against
              48 single simulations;
  5. plan     the slice end to end: plan(PlanRequest(method="delta-fast"))
              for 5 GA generations of 48 genomes on the fused path, on the
              per-round path, and on the fused path again (s/generation of
              each, the kernel launch counts of each path, identical
              topologies from the two fused runs); and the GA on the card
              against the GA on the CPU at a small size (the same
              topology);
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
# the edges of the max-plus kernel's stream-K schedule: one row and column
# with a long k, ragged tiles, and a short k (fewer chunks than one block's
# range), each at megatron-462b's width
MP_EDGES = [(1, 801, 1), (33, 1000, 65), (801, 1, 801), (801, 3, 801),
            (801, 17, 801)]
KERNELS = ("waterfill", "tclosure", "maxplus")
# fill_maxmin sweep of tests/test_torch_cuda.py: (lanes S, tasks N,
# constraints C, entries E, density of the active sets); the last needs
# 93 KB of shared memory, above the 48 KB default
MAXMIN_SWEEP = [(1, 1, 1, 1, 1.0), (3, 5, 3, 7, 0.5), (8, 64, 8, 100, 0.3),
                (5, 257, 40, 600, 0.8), (2, 1000, 200, 3000, 0.05),
                (4, 4000, 100, 8000, 0.1)]
LANES = 48              # the GA population of the main path
# plan() on megatron-462b (48 genomes, 5 generations, seed 0) on the
# per-round kernel path, as PERF.md records it
ROUND_PATH_PORTS, ROUND_PATH_MAKESPAN = 122, 93.60538748389672


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


def _ptxas(name: str) -> str:
    """The compiler's report (registers, spills, shared memory) for each
    kernel of `csrc/<name>.cu`, from its build log."""
    from repro_torch.kernels import _build
    lines, kernel = [], None
    for line in _build.library_path(name).with_suffix(".log").read_text() \
            .splitlines():
        m = re.search(r"Compiling entry function '\w*?\d+((?:pack|square|"
                      r"maxplus|combine)_[a-z]+)(?:I(\w)E)?", line)
        if m:       # the kernel's name, and a template's type code
            kernel = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        elif "Used" in line and kernel:
            lines.append(f"{kernel[:40]}: {line.split(':', 1)[1].strip()}")
    return "; ".join(lines)


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


def _maxmin_instance(rng, s, n, c, e, density, dev):
    """A random CSR incidence in which every task sits in a constraint
    (when E >= N), with S lanes of active sets and capacities."""
    import numpy as np
    import torch
    con = np.concatenate([np.arange(min(n, e)) % c,
                          rng.integers(0, c, max(e - n, 0))])
    task = np.concatenate([np.arange(min(n, e)),
                           rng.integers(0, n, max(e - n, 0))])
    order = np.argsort(con, kind="stable")
    con_ptr = np.zeros(c + 1, dtype=np.int32)
    con_ptr[1:] = np.cumsum(np.bincount(con, minlength=c))
    tensors = (con_ptr, task[order].astype(np.int32),
               rng.uniform(0.1, 3.0, e).astype(np.float32),
               rng.random((s, n)) < density,
               rng.uniform(0.1, 5.0, (s, c)).astype(np.float32),
               rng.uniform(1.0, 4.0, n).astype(np.float32))
    return [torch.from_numpy(np.ascontiguousarray(t)).to(dev)
            for t in tensors]


def _check_maxmin(name: str, args) -> tuple[float, float, list]:
    """fill_maxmin against its plain version: rates within the tolerance
    and bit-equal (both sum in one order and round every operation once),
    the same rounds on every lane."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import fill_maxmin_ref
    rates, rounds = ops.fill_maxmin(*args, backend="cuda")
    want, want_rounds = fill_maxmin_ref(*args)
    torch.cuda.synchronize()
    a, r = _check_close(name, rates, want)
    _bits_equal(name, rates, want)
    if not torch.equal(rounds, want_rounds):
        fail(f"{name}: kernel rounds {rounds.tolist()} differ from the "
             f"plain version's {want_rounds.tolist()}")
    again, again_rounds = ops.fill_maxmin(*args, backend="cuda")
    if not (torch.equal(again, rates) and torch.equal(again_rounds, rounds)):
        fail(f"{name}: fill_maxmin is not bit-identical run to run")
    return a, r, rounds.tolist()


def kernel_maxmin(dag) -> dict:
    """The fused filling kernel against its plain version over the sweep
    and on megatron-462b's CSR at 48 lanes of random active sets and
    caps, with its time and bound."""
    import numpy as np
    import torch
    from repro_torch.core.des import DESProblem
    from repro_torch.core.des_torch import TorchDES, _incidence_csr
    from repro_torch.kernels import waterfill
    from repro_torch.kernels.ref import fill_maxmin_ref
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    worst = 0.0
    for shape in MAXMIN_SWEEP:
        a, _, _ = _check_maxmin(f"fill_maxmin {shape}",
                                _maxmin_instance(rng, *shape, dev))
        worst = max(worst, a)
    log(f"[kernels] fill_maxmin sweep {len(MAXMIN_SWEEP)} shapes (S, N, C, "
        f"E, density): bit-equal to the plain version (max abs err "
        f"{worst:.3e}, rtol/atol {KERNEL_RTOL:g}), rounds equal, "
        f"bit-identical reruns")

    # the main path's shape: megatron-462b's padded CSR, 48 lanes
    des = TorchDES(DESProblem(dag))
    a = des.arrays
    con_ptr, ent_task, ent_w = _incidence_csr(a)
    S, N, C, E = LANES, a.n, a.num_cons, ent_task.numel()
    real = a.task_valid.cpu().numpy().copy()
    real[0] = False
    active = (rng.random((S, N)) < rng.uniform(0.02, 0.5, (S, 1))) & real
    caps = np.concatenate([rng.integers(1, 5, (S, a.num_link_cons)),
                           np.ones((S, C - a.num_link_cons))], 1)
    args = [con_ptr, ent_task, ent_w, torch.from_numpy(active).to(dev),
            torch.from_numpy(caps.astype(np.float32)).to(dev), a.flows]
    max_abs, max_rel, rounds = _check_maxmin("fill_maxmin main shape", args)
    log(f"[kernels] fill_maxmin S={S} N={N} C={C} E={E} (megatron-462b CSR,"
        f" max {int((con_ptr[1:] - con_ptr[:-1]).max())} entries per "
        f"constraint, {waterfill.maxmin_smem_bytes(N, C, E)} bytes of "
        f"shared memory per block): bit-equal to the plain version (max abs "
        f"err {max_abs:.3e}, max rel err {max_rel:.3e}); rounds per lane "
        f"{min(rounds)}-{max(rounds)} (sum {sum(rounds)}), equal to the plain"
        f" version's; bit-identical rerun")

    ms = time_ms(lambda: waterfill.fill_maxmin(*args))
    plain_ms = time_ms(lambda: fill_maxmin_ref(*args), iters=20, warmup=3)
    # bytes: the CSR, active, caps and flows read once, rates and rounds
    # written once; operations: per lane and round two FMAs per entry,
    # a subtraction, a division and a min per constraint, an add per task
    b_ms, b_by = bound_ms(
        4.0 * (C + 1) + 8.0 * E + S * N + 4.0 * S * C + 4.0 * N
        + 4.0 * S * N + 4.0 * S, sum(rounds) * (4.0 * E + 3.0 * C + N))
    log(f"[kernels] fill_maxmin S={S} N={N} C={C} E={E}: kernel {ms:.5f} ms"
        f"/call, plain {plain_ms:.5f}, no library call, bound {b_ms:.6f} "
        f"ms ({b_by})")
    dev_us = {name: _device_us_per_call(fn, iters) for name, fn, iters in (
        ("kernel", lambda: waterfill.fill_maxmin(*args), 50),
        ("plain", lambda: fill_maxmin_ref(*args), 5))}
    log("[kernels] device time per call (profiler): " + ", ".join(
        f"{k} {v}" for k, v in dev_us.items()))
    return {"name": "waterfill.fill_maxmin", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/waterfill.cu",
            "replaces": "src/repro/kernels/waterfill.py:47",
            "launches": None, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


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
    # the two paths of the square, on either side of the resident limit
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    limit = max(m for m in range(1, 4096) if tclosure.plan(m, sms).resident)
    for m in (limit, limit + 1):
        path = "resident" if tclosure.plan(m, sms).resident else "streamed"
        if path != ("resident" if m == limit else "streamed"):
            fail(f"tclosure_step n={m}: plan takes the {path} path")
        a = torch.from_numpy(rng.random((m, m)) < 0.02).to(dev)
        got = ops.tclosure_step(a, backend="cuda")
        _bits_equal(f"tclosure_step n={m} ({path})", got,
                    tclosure_step_ref(a))
        if not torch.equal(got, ops.tclosure_step(a, backend="cuda")):
            fail(f"tclosure_step n={m} is not bit-identical run to run")
        log(f"[kernels] tclosure_step n={m} ({path} path, "
            f"{tclosure.plan(m, sms).smem} bytes of shared memory per "
            f"block): bit-equal to the plain version; bit-identical rerun")

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
    # the counting product an int8 route would run: torch._int_mm needs
    # sizes that are multiples of 8, so the matrix is padded with zeros
    pad = -(-n // 8) * 8
    i8 = torch.zeros((pad, pad), dtype=torch.int8, device=dev)
    i8[:n, :n] = adj
    ms = time_ms(lambda: tclosure.tclosure_step(adj))
    plain_ms = time_ms(lambda: tclosure_step_ref(adj))
    library_ms = time_ms(lambda: torch.matmul(f, f))
    int_mm_ms = time_ms(lambda: torch._int_mm(i8, i8))
    # bool in and out; the product counted as the dense int8 product an
    # exact tensor-core version would run (2 n^3 at the int8 peak)
    b_ms, b_by = bound_ms(2.0 * n * n, 2.0 * n ** 3, INT8_PEAK)
    p = tclosure.plan(n, sms)
    path = "resident" if p.resident else "streamed"
    log(f"[kernels] tclosure_step n={n} ({path} path, {p.blocks} blocks of "
        f"{p.warps} warps, {p.smem} bytes of shared memory per block): "
        f"kernel {ms:.5f} ms/call, plain {plain_ms:.5f}, torch.matmul "
        f"(f32) {library_ms:.5f}, torch._int_mm (int8, padded to {pad}) "
        f"{int_mm_ms:.5f}, bound {b_ms:.6f} ms ({b_by})")
    dev_us = {name: _device_us_per_call(fn) for name, fn in (
        ("kernel", lambda: tclosure.tclosure_step(adj)),
        ("plain", lambda: tclosure_step_ref(adj)),
        ("torch.matmul", lambda: torch.matmul(f, f)),
        (f"torch._int_mm padded to {pad}", lambda: torch._int_mm(i8, i8)))}
    log("[kernels] device time per call (profiler): " + ", ".join(
        f"{k} {v}" for k, v in dev_us.items()))
    a = adj
    for step in range(1, steps + 1):
        by_kernel = _device_us_by_kernel(lambda: tclosure.tclosure_step(a))
        total = sum(by_kernel.values())
        log(f"[kernels] tclosure_step n={n} step {step} ({int(a.sum())} set "
            f"bits) device time by kernel (profiler): " + ", ".join(
                f"{k} {v:.3f} us" for k, v in by_kernel.items())
            + f"; {total:.3f} us in all, {b_ms * 1e3 / total:.4f} of the "
            f"bound")
        a = tclosure_step_ref(a)
    log(f"[kernels] tclosure ptxas: {_ptxas('tclosure')}")
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
    for m, k, n in MP_EDGES:
        a, b = sparse(m, k), sparse(k, n)
        got = ops.maxplus(a, b, backend="cuda")
        _bits_equal(f"maxplus {m}x{k}x{n}", got, maxplus_ref(a, b))
        if not torch.equal(got, ops.maxplus(a, b, backend="cuda")):
            fail(f"maxplus {m}x{k}x{n} is not bit-identical run to run")
    torch.cuda.synchronize()
    log(f"[kernels] maxplus sweep {len(MP_SHAPES)} shapes and "
        f"{len(MP_EDGES)} edges of the schedule {MP_EDGES}: bit-equal to "
        f"the plain version, bit-identical reruns")

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
    p = maxplus.plan(n, n, n, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    log(f"[kernels] maxplus {n}x{n}x{n} ({p.tiles_m * p.tiles_n} tiles x "
        f"{p.kc} k-chunks = {p.units} units on {p.blocks} blocks, workspace "
        f"{p.blocks * p.max_seg} tiles): kernel {ms:.5f} ms/call, plain "
        f"{plain_ms:.5f}, no library call, bound {b_ms:.6f} ms ({b_by})")
    dev_us = {name: _device_us_per_call(fn, iters) for name, fn, iters in (
        ("kernel", lambda: maxplus.maxplus(d0, d0), 50),
        ("plain", lambda: maxplus_ref(d0, d0), 5))}
    log("[kernels] device time per call (profiler): " + ", ".join(
        f"{k} {v}" for k, v in dev_us.items()))
    by_kernel = _device_us_by_kernel(lambda: maxplus.maxplus(d0, d0))
    total = sum(by_kernel.values())
    log("[kernels] maxplus device time by kernel (profiler): " + ", ".join(
        f"{k} {v:.3f} us" for k, v in by_kernel.items())
        + f"; {total:.3f} us in all, {b_ms * 1e3 / total:.4f} of the bound")
    log(f"[kernels] maxplus ptxas: {_ptxas('maxplus')}")
    return {"name": "maxplus.maxplus", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/maxplus.cu",
            "replaces": "src/repro/kernels/maxplus.py:40",
            "launches": None, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}, steps


def _profile(fn):
    """A torch.profiler trace (host and device) of one call of `fn`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def _busy_s(prof) -> float:
    """Seconds the device spent in kernels and copies in a trace (0.0 when
    it holds no device time)."""
    import torch
    return 1e-6 * sum(ev.device_time_total for ev in prof.events()
                      if ev.device_type == torch.autograd.DeviceType.CUDA)


def _device_busy_s(fn) -> float:
    """Seconds the device spent in kernels and copies during one call of
    `fn`, from a torch.profiler trace."""
    return _busy_s(_profile(fn))


def _host_syncs(fn) -> int:
    """Host syncs during one call of `fn`: the warnings of
    torch.cuda.set_sync_debug_mode("warn"), each one counted."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


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
            "maxmin": waterfill.maxmin_launches,
            "trips": REGISTRY.counter("des_event_trips_total").value(),
            "rounds": REGISTRY.counter("des_fill_rounds_total").value()}


def _reset_counts() -> None:
    from repro_torch.kernels import maxplus, tclosure, waterfill
    from repro_torch.obs import REGISTRY
    waterfill.launches = waterfill.maxmin_launches = 0
    tclosure.launches = maxplus.launches = 0
    REGISTRY.counter("des_event_trips_total").reset()
    REGISTRY.counter("des_fill_rounds_total").reset()


def _check_path(name: str, c: dict) -> None:
    """The launch counts of one DES run on `name`'s path: the fused path
    launches fill_maxmin once per trip and fill_round never; the
    per-round path fill_round once per round and fill_maxmin never; the
    plain path neither."""
    if name == "ref":
        if c["maxmin"] or c["launches"] or c["trips"] == 0:
            fail(f"plain path: {c['maxmin']} fill_maxmin and "
                 f"{c['launches']} fill_round launches")
    elif name == "cuda":
        if c["maxmin"] != c["trips"] or c["trips"] == 0 \
                or c["launches"] != 0:
            fail(f"fused path: {c['maxmin']} fill_maxmin launches for "
                 f"{c['trips']:.0f} trips and {c['launches']} fill_round "
                 f"launches")
    elif c["launches"] != c["rounds"] or c["launches"] == 0 \
            or c["maxmin"] != 0:
        fail(f"per-round path: {c['launches']} fill_round launches for "
             f"{c['rounds']:.0f} filling rounds and {c['maxmin']} "
             f"fill_maxmin launches")


def _trip_ops(prof, trips: float, wall_s: float, top: int = 16) -> None:
    """The host's torch ops of one profiled run, by self CPU time, per
    trip (torch.profiler's CPU side; its own cost inflates the times, and
    what is not a torch op -- Python, the ctypes launch -- is the rest of
    the wall time), and the device's kernels of the same run."""
    import torch
    rows = [(ev.key, ev.count, ev.self_cpu_time_total)
            for ev in prof.key_averages() if ev.count]
    rows.sort(key=lambda r: -r[2])
    total_us = sum(r[2] for r in rows)
    calls = sum(r[1] for r in rows if r[0].startswith("aten::"))
    log(f"[des] host ops of one fused batch per trip (torch.profiler CPU "
        f"side, {trips:.0f} trips, {wall_s * 1e6 / trips:.2f} us of "
        f"profiled wall time per trip): {calls / trips:.2f} aten ops "
        f"(nested ones included), {total_us / trips:.2f} us self CPU time "
        f"in all")
    for key, count, self_us in rows[:top]:
        log(f"[des]   {key[:48]:48s} {count / trips:7.2f} calls "
            f"{self_us / trips:9.3f} us")
    # device-side events only: a CPU op's entry carries its kernels' time
    kernels = [(ev.key, ev.count, ev.device_time_total)
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda r: -r[2])
    log(f"[des] device time of one fused batch per trip by kernel "
        f"(torch.profiler): {sum(k[2] for k in kernels) / trips:.2f} us in "
        f"{sum(k[1] for k in kernels) / trips:.2f} kernels and copies")
    for key, count, dev_us in kernels[:10]:
        name = re.split(r"[<(]", key.replace("(anonymous namespace)::", "")
                        )[0].split("::")[-1].strip() or key
        log(f"[des]   {name[:48]:48s} {count / trips:7.2f} calls "
            f"{dev_us / trips:9.3f} us")


def phase_des(dag) -> None:
    """The DES at full width on the fused, per-round and plain paths."""
    import numpy as np
    import torch
    from repro_torch.core.baselines import BASELINES
    from repro_torch.core.des import DESProblem, simulate
    from repro_torch.core.des_torch import DESOptions, TorchDES
    from repro_torch.core.ga import TopologySpace

    prob = DESProblem(dag)
    engines = {}
    for name in ("cuda", "cuda-round", "ref"):
        t0 = time.perf_counter()
        des = TorchDES(prob, options=DESOptions(backend=name))
        log(f"[des] TorchDES device {des.device} backend {des.backend} pad "
            f"{tuple(des.pad)} built in {time.perf_counter() - t0:.2f} s")
        if des.backend != name:
            fail(f"TorchDES took backend {des.backend!r}, not {name!r}")
        engines[name] = des
    if TorchDES(prob).backend != "cuda":
        fail("TorchDES on the card does not default to the fused kernel")
    for base in ("prop-alloc", "sqrt-alloc"):
        x = BASELINES[base](dag)
        t0 = time.perf_counter()
        want = simulate(prob, x)
        t_np = time.perf_counter() - t0
        got = {}
        for name, des in engines.items():
            _reset_counts()         # this path's counts start at 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ms, feas, _, _ = des.simulate(x)
            t_dev = time.perf_counter() - t0
            c = _counts()
            rel = abs(ms - want.makespan) / want.makespan
            log(f"[des] {base} ({int(x.sum())} ports) on {name}: numpy "
                f"{want.makespan!r} ({t_np:.3f} s), torch {ms!r} ({t_dev:.3f}"
                f" s), rel {rel:.3e}; {c['trips']:.0f} trips, "
                f"{c['rounds']:.0f} rounds, {c['maxmin']} fill_maxmin and "
                f"{c['launches']} fill_round launches")
            if feas != want.feasible or not rel <= DES_RTOL:
                fail(f"{base} on {name}: torch DES {ms} vs numpy "
                     f"{want.makespan} (rel {rel:.3e} > {DES_RTOL:g})")
            _check_path(name, c)
            got[name] = (ms, c["rounds"])
        # the fused kernel and its plain version give the same bits, so
        # the same makespan and rounds; the per-round kernel sums in
        # another order
        if got["cuda"] != got["ref"]:
            fail(f"{base}: fused path {got['cuda']} vs its plain version "
                 f"{got['ref']} (makespan, rounds) on the card")
        rel = abs(got["cuda"][0] - got["cuda-round"][0]) / got["cuda"][0]
        log(f"[des] {base}: fused == plain (makespan and rounds); fused vs "
            f"per-round makespan rel {rel:.3e}, rounds {got['cuda'][1]:.0f} "
            f"vs {got['cuda-round'][1]:.0f}")
        if not rel <= KERNEL_RTOL:
            fail(f"{base}: fused path {got['cuda']} vs per-round path "
                 f"{got['cuda-round']} (makespan, rounds), rel {rel:.3e}")

    # a 48-genome fitness batch in turns: round, fused, fused, round
    space = TopologySpace(dag)
    genomes = space.random_init_batch(np.random.default_rng(0), LANES)
    results = {}
    for turn, name in enumerate(("cuda-round", "cuda", "cuda", "cuda-round"),
                                1):
        des = engines[name]

        def batch():
            return des.batch_genome_makespan(genomes, space.edge_u,
                                             space.edge_v)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms_b, feas_b = batch()
        wall = time.perf_counter() - t0
        c = _counts()
        _check_path(name, c)
        t0 = time.perf_counter()
        prof = _profile(batch)
        prof_wall = time.perf_counter() - t0
        busy = _busy_s(prof)
        syncs = _host_syncs(batch)
        trips = c["trips"]
        log(f"[des] turn {turn} {name}: 48-genome batch {wall:.4f} s wall "
            f"({wall * 1e3 / c['trips']:.4f} ms per trip); "
            f"device busy {busy:.4f} s (profiled rerun), idle share "
            + (f"{1.0 - busy / wall:.4f}" if busy else "not measured")
            + f"; {syncs} host syncs in {trips:.0f} trips, "
            f"{syncs / trips:.3f} per trip; {c['rounds']:.0f} rounds, "
            f"{c['maxmin']} fill_maxmin, {c['launches']} fill_round launches")
        if name == "cuda" and name not in results:
            _trip_ops(prof, trips, prof_wall)
        results.setdefault(name, []).append((ms_b, feas_b))
    (ms_f, feas_f), (ms_r, feas_r) = results["cuda"][0], \
        results["cuda-round"][0]
    ok = feas_f & feas_r
    worst = float((np.abs(ms_f[ok] - ms_r[ok]) / ms_r[ok]).max()) \
        if ok.any() else 0.0
    log(f"[des] fused vs per-round batch: max rel diff {worst:.3e} "
        f"({int(ok.sum())} of {LANES} feasible on both)")
    if not np.array_equal(feas_f, feas_r) or not worst <= KERNEL_RTOL:
        fail(f"fused and per-round batches differ: rel {worst:.3e}")
    for name, runs in results.items():
        if not all(np.array_equal(m, runs[0][0]) for m, _ in runs):
            fail(f"{name}: two batches of one seed gave other makespans")

    des = engines["cuda"]
    t0 = time.perf_counter()
    worst = 0.0
    for i, x in enumerate(space.to_matrix_batch(genomes)):
        ms, feas, _, _ = des.simulate(x)
        if feas != bool(feas_f[i]):
            fail(f"genome {i}: batched feasible {feas_f[i]}, single {feas}")
        if feas:
            worst = max(worst, abs(ms - ms_f[i]) / ms)
    t_single = time.perf_counter() - t0
    log(f"[des] {LANES} single calls {t_single:.2f} s; max rel diff from "
        f"the batch {worst:.3e} ({int(feas_f.sum())} of {LANES} feasible in the batch)")
    if not worst <= 1e-6:
        fail(f"batched makespans differ from single ones by rel {worst}")


def phase_plan(dag) -> tuple[int, int]:
    """plan(delta-fast) at full width on the fused path, on the per-round
    path, and on the fused path again; returns the fill_maxmin launches
    of the first fused run and the fill_round launches of the per-round
    run."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.core.api import PlanRequest, plan
    from repro_torch.core.des_torch import DESOptions
    from repro_torch.core.ga import GAOptions

    results = {}
    for run, name in enumerate(("cuda", "cuda-round", "cuda"), 1):
        obs.TRACER.clear()
        _reset_counts()             # this path's counts start at 0
        t0 = time.perf_counter()
        with obs.enabled():
            res = plan(PlanRequest(
                dag=dag, method="delta-fast",
                ga_options=GAOptions(seed=0, pop_size=48, max_generations=5,
                                     patience=60, time_limit=1e9),
                # the fused runs take the default, which is the fused path
                des_options=DESOptions(backend="auto" if name == "cuda"
                                       else name)))
        wall = time.perf_counter() - t0
        c = _counts()
        spans = obs.TRACER.summary()
        gens = res.details["generations"]
        batches = spans["ga.fitness_batch"]["count"]
        gen_s = spans["ga.generation"]["total_s"] / max(gens, 1)
        log(f"[plan] run {run} on {name}: makespan {float(res.makespan)!r} "
            f"s, NCT {float(res.nct)!r}, {res.total_ports} ports, {gens} "
            f"generations, {res.details['evaluations']} evaluations, plan "
            f"{wall:.2f} s, {gen_s:.3f} s/generation")
        log(f"[plan] run {run} on {name}: {batches} fitness batches, per "
            f"batch {c['trips'] / batches:.1f} trips, "
            f"{c['rounds'] / batches:.1f} rounds, "
            f"{c['maxmin'] / batches:.1f} fill_maxmin and "
            f"{c['launches'] / batches:.1f} fill_round launches; totals "
            f"{c['trips']:.0f} / {c['rounds']:.0f} / {c['maxmin']} / "
            f"{c['launches']}")
        log(f"[plan] run {run} on {name}: x has {res.total_ports} ports, "
            f"makespan {float(res.makespan)!r} s (recorded on the per-round "
            f"path: {ROUND_PATH_PORTS} ports, {ROUND_PATH_MAKESPAN!r} s)")
        if gens != 5 or not res.feasible or not np.isfinite(res.makespan) \
                or not 0.0 < res.nct < np.inf:
            fail(f"plan run {run} on {name}: generations {gens}, feasible "
                 f"{res.feasible}, makespan {res.makespan}, nct {res.nct}")
        _check_path(name, c)
        results.setdefault(name, []).append((res, c))
    (a, ca), (b, _) = results["cuda"]
    if not np.array_equal(a.x, b.x) or a.makespan != b.makespan:
        fail("plan() gave different topologies on two runs with one seed")
    r, cr = results["cuda-round"][0]
    log(f"[plan] two fused runs: identical x and makespan; the per-round "
        f"run's x is {'identical' if np.array_equal(a.x, r.x) else 'other'}"
        f" (makespan {float(r.makespan)!r} s)")
    return ca["maxmin"], cr["launches"]


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
    if not rel <= DES_RTOL or not same:
        fail(f"gpt-7b plan on the card {card.makespan} vs the CPU "
             f"{cpu.makespan}, identical x {same}")


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
    maxmin = kernel_maxmin(dag)
    tclosure, closure_steps = kernel_tclosure(dag)
    maxplus, paths_steps = kernel_maxplus(dag)
    phase_des(dag)
    maxmin["launches"], waterfill["launches"] = phase_plan(dag)
    phase_small_parity()
    tclosure["launches"], t_up = phase_xbound(dag, closure_steps)
    maxplus["launches"] = phase_paths(dag, t_up, paths_steps)
    log(json.dumps({"kernels": [waterfill, maxmin, tclosure, maxplus]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
