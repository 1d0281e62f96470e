"""One run of one cell: set-up, the measured window, the reference's
check, the metrics and the result line."""
from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from harness import check, job, trace, traffic
from harness.faults import FAULTS
from harness.probe import Probe
from harness.spec import Spec

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARM_TRIPS = 8      # event trips of the warm-up batch: every kernel of a trip


@dataclass
class Run:
    """Everything a metric's reader may read."""
    workload: dict
    config: dict
    traffic: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    records: list = field(default_factory=list)
    probe: Probe = field(default_factory=Probe)
    spans: list = field(default_factory=list)     # (name, t0, dur)
    counters: dict = field(default_factory=dict)  # deltas over the window
    device: trace.DeviceProfile | None = None

    def span_records(self, name: str) -> list[tuple[str, float, float]]:
        return [s for s in self.spans if s[0] == name]


def forbidden_modules(names: tuple[str, ...] = FORBIDDEN) -> list[str]:
    """Top-level names of `sys.modules` among `names` (JAX and the JAX
    package), compared whole: `repro_torch` is not `repro`."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(names))


def counters() -> dict[str, float]:
    """Every counter of the port's registry, summed over its labels, and
    the kernels' launch counts."""
    from repro_torch.kernels import waterfill
    from repro_torch.obs import REGISTRY
    out = {name: float(sum(m["series"].values()))
           for name, m in REGISTRY.snapshot().items()
           if m["kind"] == "counter"}
    out["waterfill.maxmin_launches"] = float(waterfill.maxmin_launches)
    return out


def warm_up(dag, traf: dict, config: dict, device: str | None) -> None:
    """One fitness batch at the cell's lane count through the engine the
    plans build, cut to a few event trips: every operation of a trip runs
    once (and in a fresh checkout nvcc builds the kernel) before the
    window.  Alg. 2 and the host DES are numpy and need no warm-up."""
    from repro_torch.core.des import DESProblem
    from repro_torch.core.des_torch import TorchDES
    opts = job.ga_options(traf, config, 0, 1.0, device)
    problem = DESProblem(dag)
    on_device = opts.backend == "torch" or (
        opts.backend == "auto" and problem.n <= opts.device_task_limit)
    if not on_device:
        return
    pairs = np.asarray(dag.undirected_pairs(), dtype=np.int64).reshape(-1, 2)
    des = TorchDES(problem, max_events=WARM_TRIPS, options=opts.des_options)
    des.batch_genome_makespan(np.ones((opts.pop_size, len(pairs)),
                                      dtype=np.int64), pairs[:, 0],
                              pairs[:, 1])


def run_cell(spec: Spec, name: str, seed: int, seconds: float,
             traced: bool, t0: float, device: str | None = None,
             log=print, forbidden: tuple[str, ...] = FORBIDDEN,
             faults: tuple[str, ...] = ()) -> dict:
    """The result line of one run.  `t0` is the process's start on
    `time.perf_counter()`; `device` None is the CUDA device, "cpu" the
    plain path that tests take (in a process that may hold JAX, so they
    pass no `forbidden` names).  `faults` names faults of
    `harness.faults` to plant in the program, for the checks' tests."""
    import torch

    from repro_torch import obs
    wl = spec.workload(name)
    config, traf = spec.config(wl), spec.traffic(wl)
    limits = spec.limits(wl)
    kind = "per_layer" if traced else "end_to_end"
    wanted = spec.metrics(wl, kind)
    readers = {m["name"]: spec.reader(m["name"]) for m in wanted}
    on_cuda = device is None

    dag = job.build_dag(config)
    warm_up(dag, traf, config, device)
    probe = Probe()
    for fault in faults:
        FAULTS[fault](probe)
    probe.record_outputs()
    traced_slice = None
    if traced:
        probe.time_host_layers()
        for reader in readers.values():
            if hasattr(reader, "install"):
                reader.install(probe)
        obs.TRACER.clear()
        obs.TRACER.enable()
        if on_cuda:
            traced_slice = trace.TraceSlice(trace.DeviceTrace(),
                                            **traf["trace"])
            probe.after_batch.append(traced_slice.batch_done)
            traced_slice.open_now()
    before = counters()
    if on_cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    log(f"set-up {setup_s:.3f} s; window of {seconds:g} s opens")
    try:
        records, window_s = traffic.drive(traf, config, dag, seed, seconds,
                                          probe, device)
        log(f"window closed after {window_s:.3f} s, {len(records)} requests")
        device_profile = traced_slice.close() if traced_slice else None
    finally:
        obs.TRACER.disable()
        probe.restore()
    after = counters()
    memory_peak = int(torch.cuda.max_memory_allocated()) if on_cuda else 0
    found = forbidden_modules(forbidden)
    if found:
        raise RuntimeError(f"modules of JAX or of the JAX package were "
                           f"loaded: {found}")

    run = Run(workload=wl, config=config, traffic=traf, setup_s=setup_s,
              window_s=window_s, records=records, probe=probe,
              counters={k: after[k] - before.get(k, 0.0) for k in after},
              device=device_profile)
    if device_profile is not None:
        traced_calls = device_profile.kernel_seconds("fill_maxmin")[1]
        log(f"device trace: {device_profile.events} device events, busy "
            f"{device_profile.busy_s:.3f} s of {device_profile.window_s:.3f}"
            f" s; fill_maxmin {traced_calls} traced of "
            f"{int(run.counters['waterfill.maxmin_launches'])} launched; "
            f"read in {device_profile.read_s:.3f} s")
    if traced:
        run.spans = [(r.name, r.t0, r.dur) for r in obs.TRACER.records] + [
            (s.name, s.t0, s.dur) for s in probe.spans] + [
            ("plan", r.t0, r.wall_s) for r in records]
        obs.TRACER.clear()
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the reference, once the window is closed and the program's state
    # is freed
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    for rec in records:
        if rec.error:
            log(f"request {rec.request} (GA seed {rec.seed}) failed:\n"
                f"{rec.error}")
    t_check = time.perf_counter()
    judge = check.Judge(job.raw_dag(dag))
    checks, info = check.compare(records, probe, judge, config,
                                 traf["check"]["lanes"], seed, limits)
    log(f"reference check in {time.perf_counter() - t_check:.3f} s")
    failed = sum(1 for r in records if not r.ok)
    correct = (failed == 0 and bool(records) and info["lanes_checked"] > 0
               and all(c.ok for c in checks))

    result: dict = {
        "correct": correct, "attempted": len(records), "failed": failed,
        "metrics": metrics,
        "device": device_info(on_cuda, memory_peak, device_profile)}
    if device_profile is not None:
        result["breakdown"] = breakdown(device_profile, run.spans)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    log(f"{name} seed {seed}: {len(records)} requests, {failed} failed, "
        f"generations {[r.generations for r in records]}, walls "
        f"{[round(r.wall_s, 3) for r in records]} s, "
        f"window {window_s:.3f} s, set-up {setup_s:.3f} s, "
        f"{info['lanes_checked']} of {info['lanes_scored']} scored lanes "
        f"and {info['plans_checked']} plans checked")
    for c in checks:
        log(f"check {c.name} {c.value!r} limit {c.limit!r} "
            f"{'ok' if c.ok else 'FAILED'}")
    return result


def device_info(on_cuda: bool, memory_peak: int,
                prof: trace.DeviceProfile | None) -> dict:
    import torch
    if on_cuda:
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1, "memory_peak_bytes": memory_peak}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 0,
               "memory_peak_bytes": 0}
    if prof is not None:
        out["busy_s"] = prof.busy_s
        out["window_s"] = prof.window_s
    return out


def breakdown(prof: trace.DeviceProfile, spans: list) -> dict:
    """The ten device operations that took most time, and the idle time by
    what the host was doing."""
    by_short: dict[str, float] = {}
    for name, secs in prof.kernels.items():
        short = trace.short_name(name)
        by_short[short] = by_short.get(short, 0.0) + secs
    ops = sorted(by_short.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(trace.idle_by_activity(prof, spans).items(),
                  key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}
