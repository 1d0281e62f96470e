"""DELTA facade on PyTorch: one typed entry point, `plan(PlanRequest)`.

    result = plan(PlanRequest(dag=dag, method="delta-fast"))
    report = compare(dag)      # the baselines and delta-fast side by side

The port of `repro/core/api.py` for ``kind == "dag"``.  Methods:

  prop-alloc | sqrt-alloc | iter-halve    traffic-matrix baselines
  delta-fast                              GA (Alg. 3) on the torch DES

The MILP methods, the robust/failsafe/resilient planners and the fleet
come with later slices of the port; asking for them raises
`NotImplementedError` naming the ROADMAP.md item that brings them.

Planning runs on the CUDA device unless `des_options` (or
``ga_options.des_options``) names another; with no CUDA device and none
named, `plan` raises rather than run on the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.baselines import BASELINES
from repro_torch.core.dag import CommDAG, DagEnsemble
from repro_torch.core.des import DESProblem, DESResult, simulate
from repro_torch.core.des_torch import DESOptions
from repro_torch.core.ga import GAOptions, GAResult, delta_fast

INF = float("inf")

METHODS = ("prop-alloc", "sqrt-alloc", "iter-halve", "delta-fast")
# reference methods that later slices bring, by the ROADMAP.md item
_LATER_METHODS = {
    "delta-topo": "'Modules to port' item 5 (facade: MILP methods)",
    "delta-joint": "'Modules to port' item 5 (facade: MILP methods)",
    "delta-joint-hotstart": "'Modules to port' item 5 (facade: MILP "
                            "methods)",
    "delta-robust": "'Modules to port' item 6 (ensemble engines)",
}
_LATER_KINDS = {
    "ensemble": "'Modules to port' item 6 (ensemble engines)",
    "failsafe": "'Modules to port' item 6 (ensemble engines: failsafe)",
    "resilient": "'Modules to port' item 5 (facade: MILP methods)",
    "fleet": "'Modules to port' item 8 (fleet seams)",
}


@dataclass
class PlanResult:
    method: str
    x: np.ndarray
    makespan: float            # under the method's own rate semantics
    comm_time: float           # inter-pod comm time on the critical path
    nct: float
    total_ports: int
    elapsed: float
    feasible: bool = True
    details: dict = field(default_factory=dict)


def _ideal(problem: DESProblem) -> DESResult:
    P = problem.dag.cluster.num_pods
    return simulate(problem, np.zeros((P, P)), ideal=True)


def _plan_dag(dag: CommDAG, method: str = "delta-fast",
              ga_options: GAOptions | None = None,
              ideal_result: DESResult | None = None) -> PlanResult:
    if method in _LATER_METHODS:
        raise NotImplementedError(
            f"method {method!r} is not ported yet: ROADMAP.md "
            f"{_LATER_METHODS[method]}")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; pick from {METHODS}")
    # the device is settled before any work: no CUDA device and none named
    # raises here, whichever method was asked for
    ((ga_options and ga_options.des_options) or DESOptions()) \
        .resolve_device()
    problem = DESProblem(dag)
    ideal = ideal_result or _ideal(problem)
    t0 = time.time()

    if method in BASELINES:
        x = BASELINES[method](dag)
        elapsed = time.time() - t0
        return _from_des(dag, problem, method, x, elapsed, ideal)

    res: GAResult = delta_fast(dag, ga_options)
    elapsed = time.time() - t0
    out = _from_des(dag, problem, method, res.x, elapsed, ideal)
    out.details.update(generations=res.generations,
                       evaluations=res.evaluations,
                       history_len=len(res.history))
    return out


def _from_des(dag: CommDAG, problem: DESProblem, method: str, x: np.ndarray,
              elapsed: float, ideal: DESResult) -> PlanResult:
    res = simulate(problem, x)
    if not res.feasible:
        return PlanResult(method=method, x=x, makespan=INF, comm_time=INF,
                          nct=INF, total_ports=int(x.sum()), elapsed=elapsed,
                          feasible=False)
    nct = res.comm_time / ideal.comm_time if ideal.comm_time > 0 else INF
    return PlanResult(method=method, x=x, makespan=res.makespan,
                      comm_time=res.comm_time, nct=nct,
                      total_ports=int(x.sum()), elapsed=elapsed)


def compare(dag: CommDAG, methods=METHODS, **kw) -> dict[str, PlanResult]:
    problem = DESProblem(dag)
    ideal = _ideal(problem)
    return {m: _plan_dag(dag, m, ideal_result=ideal, **kw) for m in methods}


@dataclass
class PlanRequest:
    """One typed request for every planning mode.

    Exactly one of `dag` / `ensemble` / `fleet_requests` must be set;
    `kind` is derived from which one is, and a `dag` with a `failure`
    model is a failsafe (or resilient) request.  This slice plans
    ``kind == "dag"``; the other kinds raise `NotImplementedError`.
    `method` defaults to "delta-fast".  `des_options`, when set, is copied
    into ``ga_options.des_options`` (without mutating the caller's
    options object).
    """

    dag: CommDAG | None = None
    ensemble: DagEnsemble | None = None
    fleet_requests: list | tuple | None = None
    failure: object | None = None
    method: str | None = None
    ga_options: GAOptions | None = None
    des_options: DESOptions | None = None
    ideal_result: DESResult | None = None

    @property
    def kind(self) -> str:
        given = [k for k, v in (("dag", self.dag),
                                ("ensemble", self.ensemble),
                                ("fleet", self.fleet_requests))
                 if v is not None]
        if len(given) != 1:
            raise ValueError(
                "PlanRequest needs exactly one of dag | ensemble | "
                f"fleet_requests, got {given or 'none'}")
        if given[0] == "dag" and self.failure is not None:
            return "resilient" if getattr(self.failure, "resilient", False) \
                else "failsafe"
        return given[0]


def plan(request: PlanRequest) -> PlanResult:
    """THE planner entry point: dispatch a `PlanRequest` by `kind`."""
    kind = request.kind
    if kind != "dag":
        raise NotImplementedError(
            f"plan kind {kind!r} is not ported yet: ROADMAP.md "
            f"{_LATER_KINDS[kind]}")
    ga = request.ga_options
    if request.des_options is not None:
        ga = dataclasses.replace(ga or GAOptions(),
                                 des_options=request.des_options)
    return _plan_dag(request.dag, method=request.method or "delta-fast",
                     ga_options=ga, ideal_result=request.ideal_result)
