"""The general generator: plan requests as a traffic file describes them.

A traffic file (`bench/traffic/<name>.json`) holds only parameters:

  method      the `plan` method of every request
  repeat      false: one request; true: requests start back to back
              until the window has elapsed, and the one in flight finishes
  time_limit  each request's GA budget in seconds, or "window" for the
              run's own --seconds
  ga          `GAOptions` fields of every request (lanes, generations...)
  check       {"lanes": k}: card lanes the reference re-simulates
  trace       {"after": a, "batches": b}: a `--trace 1` run traces the
              card from when a fitness batches of the window have
              returned until b more have (`trace.TraceSlice`)

Request i's GA seed is the i-th draw of a generator seeded by --seed, so
a seed gives the same requests on every run.
"""
from __future__ import annotations

import time
import traceback
from dataclasses import dataclass

import numpy as np

from harness.job import ga_options


@dataclass
class PlanRecord:
    request: int
    seed: int
    t0: float                     # time.perf_counter() at the request
    wall_s: float
    generations: int | None = None
    x: np.ndarray | None = None
    makespan: float = float("inf")
    nct: float = float("inf")
    total_ports: int = 0
    feasible: bool = False
    error: str | None = None

    @property
    def ok(self) -> bool:
        return self.error is None and self.feasible


def request_seeds(seed: int):
    """The GA seeds of requests 0, 1, ... drawn from --seed."""
    rng = np.random.default_rng(abs(int(seed)))
    while True:
        yield int(rng.integers(0, 2 ** 31 - 1))


def drive(traffic: dict, config: dict, dag, seed: int, seconds: float,
          probe, device: str | None = None
          ) -> tuple[list[PlanRecord], float]:
    """Send the mix's requests to `plan` for `seconds` from one
    closed-loop client (a scheduler waits for each plan); returns the
    records and the window's length (until the last request finished)."""
    from repro_torch.core.api import PlanRequest, plan
    budget = seconds if traffic["time_limit"] == "window" \
        else float(traffic["time_limit"])
    records: list[PlanRecord] = []
    t_start = time.perf_counter()
    for i, s in enumerate(request_seeds(seed)):
        probe.request = i
        opts = ga_options(traffic, config, s, budget, device)
        t0 = time.perf_counter()
        try:
            res = plan(PlanRequest(dag=dag, method=traffic["method"],
                                   ga_options=opts))
            records.append(PlanRecord(
                i, s, t0, time.perf_counter() - t0,
                generations=res.details.get("generations"),
                x=np.asarray(res.x), makespan=float(res.makespan),
                nct=float(res.nct), total_ports=int(res.total_ports),
                feasible=bool(res.feasible)))
        except Exception:       # a failed request counts; the run goes on
            records.append(PlanRecord(i, s, t0, time.perf_counter() - t0,
                                      error=traceback.format_exc()))
        if not traffic["repeat"] or time.perf_counter() - t_start >= seconds:
            break
    probe.request = -1
    return records, time.perf_counter() - t_start
