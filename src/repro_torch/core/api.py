"""DELTA facade on PyTorch: one typed entry point, `plan(PlanRequest)`.

    result = plan(PlanRequest(dag=dag, method="delta-joint", port_min=True))
    robust = plan(PlanRequest(ensemble=DagEnsemble([dagA, dagB]),
                              objective="max-regret"))
    fleet = plan(PlanRequest(fleet_requests=[("a", job_a), ("b", job_b)]))
    report = compare(dag)      # baselines, delta-fast, delta-topo/joint

The port of `repro/core/api.py`.  `PlanRequest` carries the what (dag |
ensemble | fleet_requests, exactly one) and the how; `plan` dispatches on
`request.kind`.  The historical facades (`optimize`, `optimize_ensemble`,
`optimize_failsafe`, `optimize_resilient`, `fleet_optimize`) remain as
thin shims that build the equivalent `PlanRequest`, with bit-identical
results.  Methods (``kind == "dag"``):

  prop-alloc | sqrt-alloc | iter-halve    traffic-matrix baselines
  delta-fast                              GA (Alg. 3) on the torch DES
  delta-topo                              MILP + fairness (Eq. 17)
  delta-joint                             MILP, joint topology + rates
  delta-joint-hotstart                    delta-joint seeded by delta-fast
  delta-robust                            GA over a singleton ensemble
                                          (reduces to the delta-fast path)

An ensemble takes "delta-robust" (GA) or "delta-robust-milp" (shared-x
multi-member MILP); a dag with a `FailureModel` is a failsafe request (GA
over failure scenarios) or, with ``resilient=True``, a budgeted MILP with
its fallback chain.  A fleet request admits its jobs into a shared-pod
fleet (`repro_torch.fleet`, paper Sec. VI) and returns the live planner
and its report.

Planning runs on the CUDA device unless `des_options` (or
``ga_options.des_options``) names another.  The device is settled before
any work: with no CUDA device and none named, `plan` raises for every
method and kind, those whose first stage is host-only (the MILP) too.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.baselines import BASELINES
from repro_torch.core.dag import VIRTUAL, CommDAG, DagEnsemble
from repro_torch.core.des import DESProblem, DESResult, simulate
# des_cache_stats is re-exported so that callers tuning the engine need
# only the facade
from repro_torch.core.des_torch import DESOptions, des_cache_stats  # noqa: F401
from repro_torch.core.ga import (ROBUST_OBJECTIVES, GAOptions, GAResult,
                                 delta_failsafe, delta_fast, delta_robust)
from repro_torch.core.milp import (MILPOptions, MILPResult, solve_delta_milp,
                                   solve_resilient, solve_robust_milp)
from repro_torch.obs import span

INF = float("inf")

METHODS = ("prop-alloc", "sqrt-alloc", "iter-halve",
           "delta-fast", "delta-topo", "delta-joint",
           "delta-joint-hotstart", "delta-robust")
ROBUST_METHODS = ("delta-robust", "delta-robust-milp")
# the method a kind that takes one runs when the request names none
_DEFAULT_METHODS = {"dag": "delta-fast", "ensemble": "delta-robust"}

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
    with span("api.ideal"):
        return simulate(problem, np.zeros((P, P)), ideal=True)


def milp_critical_delta(dag: CommDAG, res: MILPResult) -> float:
    """Sum of rigid deltas along the binding chain of a MILP schedule."""
    finish = res.finish
    preds: dict[int, list] = {}
    for d in dag.deps:
        preds.setdefault(d.succ, []).append(d)
    cur = int(np.argmax(finish))
    delta_sum = 0.0
    guard = 0
    while cur != VIRTUAL and guard <= dag.num_tasks + 1:
        guard += 1
        plist = preds.get(cur, [])
        if not plist:
            break
        best = max(plist, key=lambda d: (0.0 if d.pre == VIRTUAL
                                         else finish[d.pre]) + d.delta)
        delta_sum += best.delta
        cur = best.pre
    return delta_sum


def _plan_dag(dag: CommDAG, method: str = "delta-fast",
              port_min: bool = False,
              ga_options: GAOptions | None = None,
              milp_options: MILPOptions | None = None,
              ideal_result: DESResult | None = None) -> PlanResult:
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; pick from {METHODS}")
    problem = DESProblem(dag)
    ideal = ideal_result or _ideal(problem)
    t0 = time.time()

    if method == "delta-robust":
        # singleton ensemble: the weighted objective degenerates to the
        # plain makespan, so this IS the delta-fast path (same RNG stream)
        eres = _plan_ensemble(DagEnsemble.singleton(dag),
                              method="delta-robust", objective="weighted",
                              refs=np.array([max(ideal.makespan, 1e-12)]),
                              ga_options=ga_options)
        elapsed = time.time() - t0
        out = _from_des(dag, problem, method, eres.x, elapsed, ideal)
        out.details.update(eres.details)
        return out

    if method in BASELINES:
        x = BASELINES[method](dag)
        elapsed = time.time() - t0
        return _from_des(dag, problem, method, x, elapsed, ideal)

    if method == "delta-fast":
        res: GAResult = delta_fast(dag, ga_options)
        elapsed = time.time() - t0
        out = _from_des(dag, problem, method, res.x, elapsed, ideal)
        out.details.update(generations=res.generations,
                           evaluations=res.evaluations,
                           history_len=len(res.history))
        return out

    # a copy: the MILP methods set port_min/fairness/the hot start per
    # method and must not leak them into the caller's options object
    opts = dataclasses.replace(milp_options) if milp_options \
        else MILPOptions()
    opts.port_min = port_min or opts.port_min
    if method == "delta-topo":
        opts.fairness = True
        mres = solve_delta_milp(dag, opts)
        elapsed = time.time() - t0
        out = _from_des(dag, problem, method, mres.x, elapsed, ideal)
        out.details.update(milp_status=mres.status,
                           milp_makespan=mres.makespan,
                           solve_time=mres.solve_time,
                           port_min_applied=mres.port_min_applied,
                           stats=mres.stats, schedule=mres)
        return out

    # delta-joint variants: makespan/comm time come from the MILP schedule
    opts.fairness = False
    hot = {}
    if method == "delta-joint-hotstart":
        th = time.time()
        ga = delta_fast(dag, ga_options)
        hot = {"hotstart_ga_s": time.time() - th,
               "hotstart_ga_makespan": ga.makespan}
        if np.isfinite(ga.makespan):
            ub = ga.makespan * (1 + 1e-9)
            opts.upper_bound = min(opts.upper_bound, ub) \
                if opts.upper_bound else ub
            # route the GA incumbent into the MILP hot start: its DES trace
            # seeds the anchors and the polish pre-pass (see MILPOptions)
            opts.seed_x = ga.x
        opts.hot_start = True
    mres = solve_delta_milp(dag, opts)
    elapsed = time.time() - t0
    if not mres.feasible or not np.isfinite(mres.makespan):
        return PlanResult(method=method, x=mres.x, makespan=INF,
                          comm_time=INF, nct=INF, total_ports=0,
                          elapsed=elapsed, feasible=False,
                          details={"milp_status": mres.status, **hot})
    crit_delta = milp_critical_delta(dag, mres)
    comm = mres.makespan - crit_delta
    # a time-limited incumbent schedule can carry slack; the topology is
    # still at least as good as its fair-share execution (joint rate
    # control can only improve on fair sharing), so report the better of
    # the two measurements
    des = simulate(problem, mres.x)
    makespan = mres.makespan
    source = "milp_schedule"
    if des.feasible and (not np.isfinite(comm) or des.comm_time < comm):
        comm, makespan, source = des.comm_time, des.makespan, "des_fairshare"
    nct = comm / ideal.comm_time if ideal.comm_time > 0 else INF
    return PlanResult(method=method, x=mres.x, makespan=makespan,
                      comm_time=comm, nct=nct,
                      total_ports=int(mres.x.sum()), elapsed=elapsed,
                      details={"milp_status": mres.status,
                               "solve_time": mres.solve_time,
                               "port_min_applied": mres.port_min_applied,
                               "comm_time_source": source,
                               "stats": mres.stats, "schedule": mres,
                               **hot})


def _from_des(dag: CommDAG, problem: DESProblem, method: str, x: np.ndarray,
              elapsed: float, ideal: DESResult) -> PlanResult:
    with span("api.certify") as sp:
        res = simulate(problem, x)
        sp.set(feasible=bool(res.feasible))
    if not res.feasible:
        return PlanResult(method=method, x=x, makespan=INF, comm_time=INF,
                          nct=INF, total_ports=int(x.sum()), elapsed=elapsed,
                          feasible=False)
    nct = res.comm_time / ideal.comm_time if ideal.comm_time > 0 else INF
    return PlanResult(method=method, x=x, makespan=res.makespan,
                      comm_time=res.comm_time, nct=nct,
                      total_ports=int(x.sum()), elapsed=elapsed)


def compare(dag: CommDAG, methods=METHODS[:6], **kw) -> dict[str, PlanResult]:
    _settle_device(kw.get("ga_options"))
    problem = DESProblem(dag)
    ideal = _ideal(problem)
    return {m: _plan_dag(dag, m, ideal_result=ideal, **kw) for m in methods}


# ------------------------------------------------------------- DELTA-Robust
@dataclass
class EnsemblePlanResult:
    """One static topology scored against every member of a DagEnsemble."""

    method: str
    objective: str
    x: np.ndarray
    member_names: list[str]
    weights: np.ndarray
    makespans: np.ndarray          # (M,) exact fair-share DES makespans
    refs: np.ndarray               # (M,) reference makespans (regret = 1)
    regrets: np.ndarray            # (M,) makespans / refs
    elapsed: float
    feasible: bool = True
    details: dict = field(default_factory=dict)

    @property
    def worst_regret(self) -> float:
        return float(self.regrets.max()) if len(self.regrets) else INF

    @property
    def weighted_makespan(self) -> float:
        return float(self.makespans @ self.weights)

    @property
    def total_ports(self) -> int:
        return int(self.x.sum())


def evaluate_on_ensemble(ensemble: DagEnsemble, x: np.ndarray) -> np.ndarray:
    """Exact fair-share DES makespan of topology `x` on every member (INF
    where infeasible) -- the cross-evaluation used for regret reporting."""
    return np.array([simulate(DESProblem(m), np.asarray(x)).makespan
                     for m in ensemble.members])


def _plan_ensemble(ensemble: DagEnsemble, method: str = "delta-robust",
                   objective: str = "max-regret",
                   refs: np.ndarray | None = None,
                   ga_options: GAOptions | None = None,
                   milp_options: MILPOptions | None = None
                   ) -> EnsemblePlanResult:
    """DELTA-Robust entry point: one port allocation for a set of DAGs.

    `refs` define regret (makespan / ref per member); when omitted they
    are the members' best single-DAG `delta-fast` plans computed here with
    the same `ga_options` (their plan makespans are also the natural
    baseline to report robust regret against).
    """
    if method not in ROBUST_METHODS:
        raise ValueError(
            f"unknown method {method!r}; pick from {ROBUST_METHODS}")
    if objective not in ROBUST_OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; "
                         f"pick from {ROBUST_OBJECTIVES}")
    t0 = time.time()
    details: dict = {}
    if refs is None:
        singles = [delta_fast(m, ga_options) for m in ensemble.members]
        refs = np.array([s.makespan for s in singles])
        details["single_plan_ports"] = [s.total_ports for s in singles]
        details["single_plan_x"] = [s.x for s in singles]
        details["refs_s"] = time.time() - t0
    refs = np.asarray(refs, dtype=np.float64)

    if method == "delta-robust":
        res = delta_robust(ensemble, ga_options, objective=objective,
                           refs=refs)
        x, makespans, feasible = res.x, res.makespans, res.feasible
        details.update(generations=res.generations,
                       evaluations=res.evaluations,
                       objective_value=res.objective_value)
    else:
        # honour the caller's fairness choice: MILPOptions(fairness=True)
        # yields the Eq. 17 fair-share robust variant (the delta-topo
        # analog), the default the joint-rate one (the delta-joint analog)
        opts = dataclasses.replace(milp_options) if milp_options \
            else MILPOptions()
        res = solve_robust_milp(ensemble, opts, objective=objective,
                                refs=refs)
        # a time-limited schedule can carry slack; the shared topology is
        # at least as good as its fair-share execution (cf. `_plan_dag`)
        des_ms = evaluate_on_ensemble(ensemble, res.x)
        makespans = np.minimum(res.makespans, des_ms) if res.feasible \
            else des_ms
        x, feasible = res.x, bool(np.isfinite(makespans).all())
        details.update(milp_status=res.status, solve_time=res.solve_time,
                       objective_value=res.objective_value,
                       stats=res.stats)
    with np.errstate(invalid="ignore"):
        regrets = makespans / refs
    return EnsemblePlanResult(
        method=method, objective=objective, x=x,
        member_names=list(ensemble.names),
        weights=np.asarray(ensemble.weights), makespans=makespans,
        refs=refs, regrets=regrets, elapsed=time.time() - t0,
        feasible=feasible, details=details)


def _plan_failsafe(dag: CommDAG,
                   scenarios: list[np.ndarray] | None = None,
                   num_planes: int = 4, k: int = 1,
                   objective: str = "worst",
                   ga_options: GAOptions | None = None,
                   ideal_result: DESResult | None = None) -> PlanResult:
    """DELTA-Failsafe entry point: one topology whose makespan holds up
    across fabric-degradation scenarios (capacity masks; default: every
    k-of-num_planes plane loss per pod pair).  Reported under healthy
    fair-share DES semantics; per-scenario exact makespans ride in
    `details`."""
    problem = DESProblem(dag)
    ideal = ideal_result or _ideal(problem)
    t0 = time.time()
    res = delta_failsafe(dag, ga_options, scenarios=scenarios,
                         num_planes=num_planes, k=k, objective=objective)
    elapsed = time.time() - t0
    out = _from_des(dag, problem, "delta-failsafe", res.x, elapsed, ideal)
    out.feasible = out.feasible and res.feasible
    out.details.update(objective=objective,
                       scenario_makespans=res.makespans.tolist(),
                       worst_scenario_makespan=float(res.makespans.max()),
                       generations=res.generations,
                       evaluations=res.evaluations)
    return out


def _plan_resilient(dag: CommDAG, *, budget_s: float | None = None,
                    retries: int = 1,
                    ga_options: GAOptions | None = None,
                    milp_options: MILPOptions | None = None,
                    current_x: np.ndarray | None = None,
                    mask: np.ndarray | None = None,
                    ideal_result: DESResult | None = None) -> PlanResult:
    """Budgeted MILP solve with the full fallback chain (MILP -> GA ->
    masked current plan), with `degraded` and the producing
    `fallback_stage` in `details` when the MILP did not make the budget.
    The GA stage runs on the device and is not guarded: an error of the
    device or of a kernel raises out of `plan`."""
    problem = DESProblem(dag)
    ideal = ideal_result or _ideal(problem)
    t0 = time.time()
    mres = solve_resilient(dag, milp_options, budget_s=budget_s,
                           retries=retries, ga_options=ga_options,
                           current_x=current_x, mask=mask)
    elapsed = time.time() - t0
    out = _from_des(dag, problem, "delta-resilient", mres.x, elapsed, ideal)
    out.feasible = out.feasible and mres.feasible
    out.details.update(milp_status=mres.status,
                       milp_makespan=mres.makespan,
                       degraded=bool(mres.degraded),
                       fallback_stage=mres.fallback_stage,
                       stats=mres.stats, schedule=mres)
    return out


def _plan_fleet(requests, num_pods: int | None = None,
                ports_per_pod: int | None = None,
                nic_gbps: float = 400.0,
                ga_options: GAOptions | None = None,
                nct_threshold: float = 1.005, seed: int = 0):
    """Multi-tenant entry point (paper Sec. VI): admit every request into a
    shared-pod fleet, donate port-minimized savings, waterfill the surplus
    across bottlenecked tenants, and return the FleetPlanner for inspection.

    `requests` is an iterable of `repro_torch.fleet.JobArrival` events or
    `(name, JobSpec[, kwargs])` tuples.  The fleet defaults to the smallest
    cluster that can host all requests back to back: the max pod span among
    requests, with each pod sized for the sum of co-located entitlements.
    Every engine of the fleet runs on ``ga_options.des_options``'s device.

    Returns `(planner, report)`; `report` is `planner.report()` after all
    arrivals and surplus passes.
    """
    from repro_torch.fleet import FleetPlanner, FleetSpec, arrivals

    events = arrivals(*requests)
    if not events:
        raise ValueError("fleet_optimize needs at least one job request")

    if num_pods is None or ports_per_pod is None:
        spans, per_pod = [], []
        for ev in events:
            pl = ev.job.placement()
            spans.append(pl.num_pods)
            per_pod.append(max(pl.port_limits()))
        num_pods = num_pods or max(spans)
        # stack all co-located entitlements: every request fits, worst case
        ports_per_pod = ports_per_pod or sum(per_pod)

    planner = FleetPlanner(
        FleetSpec(num_pods=num_pods, ports_per_pod=ports_per_pod,
                  nic_gbps=nic_gbps),
        ga_options=ga_options, nct_threshold=nct_threshold, seed=seed)
    planner.process(events)
    return planner, planner.report()


# -------------------------------------------------------- unified entry
@dataclass
class FailureModel:
    """How `plan` should handle fabric failures.

    Default (``resilient=False``): DELTA-Failsafe -- optimize one topology
    against degradation `scenarios` (capacity masks; when None, every
    `k`-of-`num_planes` plane loss per pod pair), aggregated by
    `objective` ("worst" | "weighted").

    ``resilient=True``: budgeted MILP with the full fallback chain
    (MILP -> GA -> masked `current_x`); `budget_s`/`retries` bound the
    solve, `mask` degrades capacities during it.
    """

    scenarios: list[np.ndarray] | None = None
    num_planes: int = 4
    k: int = 1
    objective: str = "worst"
    resilient: bool = False
    budget_s: float | None = None
    retries: int = 1
    current_x: np.ndarray | None = None
    mask: np.ndarray | None = None


@dataclass
class FleetOptions:
    """Fleet sizing + admission knobs for `plan(kind="fleet")`."""

    num_pods: int | None = None
    ports_per_pod: int | None = None
    nic_gbps: float = 400.0
    nct_threshold: float = 1.005
    seed: int = 0


@dataclass
class FleetPlanResult:
    """`plan` result for a fleet request: the live planner + its report."""

    planner: object
    report: dict

    def __iter__(self):
        # unpacks like the historical (planner, report) tuple
        return iter((self.planner, self.report))


@dataclass
class PlanRequest:
    """One typed request for every planning mode.

    Exactly one of `dag` / `ensemble` / `fleet_requests` must be set;
    `kind` is derived from which one is.  A `dag` request with a
    `FailureModel` routes to the failsafe path (or the resilient one when
    ``failure.resilient``).  `method` / `objective` default per kind
    ("delta-fast" for a dag, "delta-robust" / "max-regret" for an
    ensemble).  `des_options` is a convenience overlay: when set it is
    copied into ``ga_options.des_options`` (without mutating the caller's
    options object).
    """

    dag: CommDAG | None = None
    ensemble: DagEnsemble | None = None
    fleet_requests: list | tuple | None = None
    method: str | None = None
    objective: str | None = None
    port_min: bool = False
    refs: np.ndarray | None = None
    failure: FailureModel | None = None
    fleet: FleetOptions | None = None
    ga_options: GAOptions | None = None
    milp_options: MILPOptions | None = None
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
            return "resilient" if self.failure.resilient else "failsafe"
        return given[0]


def _settle_device(ga: GAOptions | None) -> None:
    """The device is settled before any work: no CUDA device and none
    named raises here, whichever method or kind was asked for."""
    ((ga and ga.des_options) or DESOptions()).resolve_device()


def plan(request: PlanRequest):
    """THE planner entry point: dispatch a `PlanRequest` by `kind`.

    Returns `PlanResult` (dag / failsafe / resilient),
    `EnsemblePlanResult` (ensemble) or `FleetPlanResult` (fleet) -- the
    same objects, bit-identical, that the legacy facades produce.  A MILP
    method's or the resilient kind's `details["schedule"]` is the
    `MILPResult` it planned from, which `milp.validate_solution` checks.
    Each call is one `api.plan` span, the root of the plan's spans."""
    kind = request.kind
    ga = request.ga_options
    if request.des_options is not None:
        ga = dataclasses.replace(ga or GAOptions(),
                                 des_options=request.des_options)
    _settle_device(ga)
    method = (request.method or _DEFAULT_METHODS[kind]
              if kind in _DEFAULT_METHODS else None)
    with span("api.plan", kind=kind, method=method):
        return _dispatch(request, kind, method, ga)


def _dispatch(request: PlanRequest, kind: str, method: str | None,
              ga: GAOptions | None):
    """`plan`'s body: the request's planner by `kind`."""
    if kind == "dag":
        return _plan_dag(request.dag, method=method,
                         port_min=request.port_min, ga_options=ga,
                         milp_options=request.milp_options,
                         ideal_result=request.ideal_result)
    if kind == "ensemble":
        return _plan_ensemble(request.ensemble, method=method,
                              objective=request.objective or "max-regret",
                              refs=request.refs, ga_options=ga,
                              milp_options=request.milp_options)
    f = request.failure
    if kind == "failsafe":
        return _plan_failsafe(request.dag, scenarios=f.scenarios,
                              num_planes=f.num_planes, k=f.k,
                              objective=f.objective, ga_options=ga,
                              ideal_result=request.ideal_result)
    if kind == "resilient":
        return _plan_resilient(request.dag, budget_s=f.budget_s,
                               retries=f.retries, ga_options=ga,
                               milp_options=request.milp_options,
                               current_x=f.current_x, mask=f.mask,
                               ideal_result=request.ideal_result)
    # kind == "fleet"
    fo = request.fleet or FleetOptions()
    planner, report = _plan_fleet(
        request.fleet_requests, num_pods=fo.num_pods,
        ports_per_pod=fo.ports_per_pod, nic_gbps=fo.nic_gbps,
        ga_options=ga, nct_threshold=fo.nct_threshold, seed=fo.seed)
    return FleetPlanResult(planner=planner, report=report)


# ------------------------------------------------- deprecated facades
# Thin shims over `plan` (bit-identical; parity-tested against the
# reference's).  New code should build a `PlanRequest`.
def optimize(dag: CommDAG, method: str = "delta-fast",
             port_min: bool = False,
             ga_options: GAOptions | None = None,
             milp_options: MILPOptions | None = None,
             ideal_result: DESResult | None = None) -> PlanResult:
    """Deprecated: use ``plan(PlanRequest(dag=..., method=...))``."""
    return plan(PlanRequest(dag=dag, method=method, port_min=port_min,
                            ga_options=ga_options, milp_options=milp_options,
                            ideal_result=ideal_result))


def optimize_ensemble(ensemble: DagEnsemble, method: str = "delta-robust",
                      objective: str = "max-regret",
                      refs: np.ndarray | None = None,
                      ga_options: GAOptions | None = None,
                      milp_options: MILPOptions | None = None
                      ) -> EnsemblePlanResult:
    """Deprecated: use ``plan(PlanRequest(ensemble=..., objective=...))``."""
    return plan(PlanRequest(ensemble=ensemble, method=method,
                            objective=objective, refs=refs,
                            ga_options=ga_options,
                            milp_options=milp_options))


def optimize_failsafe(dag: CommDAG,
                      scenarios: list[np.ndarray] | None = None,
                      num_planes: int = 4, k: int = 1,
                      objective: str = "worst",
                      ga_options: GAOptions | None = None,
                      ideal_result: DESResult | None = None) -> PlanResult:
    """Deprecated: use ``plan(PlanRequest(dag=..., failure=FailureModel(...)))``."""
    return plan(PlanRequest(
        dag=dag, ga_options=ga_options, ideal_result=ideal_result,
        failure=FailureModel(scenarios=scenarios, num_planes=num_planes,
                             k=k, objective=objective)))


def optimize_resilient(dag: CommDAG, *, budget_s: float | None = None,
                       retries: int = 1,
                       ga_options: GAOptions | None = None,
                       milp_options: MILPOptions | None = None,
                       current_x: np.ndarray | None = None,
                       mask: np.ndarray | None = None,
                       ideal_result: DESResult | None = None) -> PlanResult:
    """Deprecated: use ``plan(PlanRequest(dag=...,
    failure=FailureModel(resilient=True, ...)))``."""
    return plan(PlanRequest(
        dag=dag, ga_options=ga_options, milp_options=milp_options,
        ideal_result=ideal_result,
        failure=FailureModel(resilient=True, budget_s=budget_s,
                             retries=retries, current_x=current_x,
                             mask=mask)))


def fleet_optimize(requests, num_pods: int | None = None,
                   ports_per_pod: int | None = None,
                   nic_gbps: float = 400.0,
                   ga_options: GAOptions | None = None,
                   nct_threshold: float = 1.005, seed: int = 0):
    """Deprecated: use ``plan(PlanRequest(fleet_requests=...,
    fleet=FleetOptions(...)))``."""
    res = plan(PlanRequest(
        fleet_requests=list(requests), ga_options=ga_options,
        fleet=FleetOptions(num_pods=num_pods, ports_per_pod=ports_per_pod,
                           nic_gbps=nic_gbps, nct_threshold=nct_threshold,
                           seed=seed)))
    return res.planner, res.report
