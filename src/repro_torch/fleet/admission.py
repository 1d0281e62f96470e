"""Admission and placement: JobSpec -> fleet pods -> planned tenant.

Arriving jobs are placed first-fit onto a contiguous window of fleet pods
whose free (pool) ports cover the job's fair-share entitlement -- one port
per GPU the job owns in the pod (paper Sec. V-A1).  Co-tenancy is the
normal case: two jobs share a pod whenever the pod's physical port count
covers both entitlements (the Fig. 10 Model/Model^T deployment).

Each admitted tenant gets its *local* view of the cluster: a ClusterSpec of
its pod window with `port_limits = ledger.limits` gathered over the window,
and a reduced CommDAG built by `repro_torch.core.schedule.build_comm_dag`.
Planning is DELTA-Fast (+ greedy `trim_ports` for donors) behind the
fleet-wide PlanCache.  Every engine it builds (the GA's, the trims', the
tenants' realloc engines) runs on the device of the controller's
``ga_options.des_options``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.cluster import GBPS, ClusterSpec
from repro_torch.core.dag import CommDAG, DagEnsemble
from repro_torch.core.des import DESProblem, simulate
from repro_torch.core.des_torch import DESOptions, TorchDES
from repro_torch.core.ga import (ROBUST_OBJECTIVES, GAOptions,
                                 InfeasiblePlacement, delta_failsafe,
                                 delta_fast, delta_robust, trim_ports,
                                 trim_ports_ensemble)
from repro_torch.core.schedule import build_comm_dag
from repro_torch.core.traffic import JobSpec
from repro_torch.fleet.ledger import LedgerError, PortLedger, gather, scatter
from repro_torch.fleet.plancache import CachedPlan, PlanCache, dag_signature
from repro_torch.fleet.realloc import (_candidate_genomes, _genome_view,
                                       _greedy_fill, _scatter, circuit_changes)
from repro_torch.fleet.telemetry import DEFAULT_DWELL_S
from repro_torch.obs import get_counter, get_logger, span

INF = float("inf")

_log = get_logger("repro_torch.fleet")
_PLANS = get_counter("fleet_plans_total",
                     "tenant planning solves, by path and cache outcome")
_ROBUST_DEGRADED = get_counter(
    "fleet_robust_degraded_total",
    "robust replans degraded to a single-DAG plan (empty union space or "
    "infeasible member references)")
_REPAIRS = get_counter("fleet_repairs_total",
                       "fabric repair decisions, by chosen option")
_STEERS = get_counter("fleet_steer_decisions_total",
                      "priced phase-change decisions, by chosen option")


@dataclass(frozen=True)
class FleetSpec:
    """The physical fleet: pods, OCS ports per pod, per-port bandwidth."""

    num_pods: int
    ports_per_pod: int
    nic_gbps: float = 400.0
    intra_pod_bandwidth: float = 900e9

    @property
    def nic_bandwidth(self) -> float:
        return self.nic_gbps * GBPS

    def capacity(self) -> np.ndarray:
        return np.full(self.num_pods, self.ports_per_pod, dtype=np.int64)


@dataclass
class Tenant:
    """One admitted job: placement, local DAG, and its committed plan."""

    name: str
    job: JobSpec
    pods: tuple[int, ...]           # fleet pod ids, local pod i -> pods[i]
    reverse_stages: bool
    port_min: bool
    dag: CommDAG
    dag_history: list[CommDAG] = field(default_factory=list)
    plan: CachedPlan | None = None
    base_plan: CachedPlan | None = None   # within-entitlement plan; grants
    _des: object = field(default=None, repr=False)  # restore to this
    _xbar: object = field(default=None, repr=False)

    @property
    def num_local_pods(self) -> int:
        return len(self.pods)

    def local_usage(self) -> np.ndarray:
        """Per-local-pod ports wired by the committed topology."""
        if self.plan is None:
            return np.zeros(self.num_local_pods, dtype=np.int64)
        return self.plan.x.sum(axis=1).astype(np.int64)

    def fleet_usage(self, num_fleet_pods: int) -> np.ndarray:
        return scatter(self.local_usage(), self.pods, num_fleet_pods)

    def des(self, options: DESOptions | None = None) -> TorchDES:
        """Cached TorchDES for batched candidate evaluation (realloc and
        repair), built on `options`' device on first use.

        Lives on the fleet's hot replanning path, so an engine-cache miss
        here (a new bucket per surplus pass) is a perf regression worth
        surfacing -- `warn_on_miss` logs it."""
        if self._des is None:
            self._des = TorchDES(DESProblem(self.dag),
                                 options=dataclasses.replace(
                                     options or DESOptions(),
                                     warn_on_miss=True))
        return self._des

    def xbar(self):
        """Cached Alg. 2 circuit upper bounds (the DAG never changes)."""
        if self._xbar is None:
            from repro_torch.core.xbound import x_upper_bound
            self._xbar = x_upper_bound(self.dag)
        return self._xbar


class AdmissionError(RuntimeError):
    """No pod window can host the job's entitlement."""


class _InfeasibleRefs(ValueError):
    """A robust replan's member reference plans are not all feasible."""


class AdmissionController:
    """Places jobs on fleet pods and plans them through the cache."""

    def __init__(self, fleet: FleetSpec, ledger: PortLedger,
                 cache: PlanCache | None = None,
                 ga_options: GAOptions | None = None):
        self.fleet = fleet
        self.ledger = ledger
        # no `or`: an empty PlanCache is falsy (it has __len__)
        self.cache = cache if cache is not None else PlanCache()
        self.ga_options = ga_options
        # the engines' options: the planner's device and DES knobs
        self.des_options = (ga_options.des_options if ga_options
                            else None) or DESOptions()

    # ------------------------------------------------------------ placement
    def entitlement(self, job: JobSpec,
                    reverse_stages: bool = False) -> np.ndarray:
        """Per-local-pod fair-share ports (== GPUs owned in the pod)."""
        placement = job.placement(reverse_stages)
        return np.asarray(placement.port_limits(), dtype=np.int64)

    def find_window(self, job: JobSpec,
                    reverse_stages: bool = False) -> int:
        """First-fit base pod for the job's window.

        Checked against `headroom()`, not `pool()`: donated ports stay
        reserved for their donor (withdrawable on traffic growth) and must
        never be consumed by a new tenant's permanent entitlement."""
        ent = self.entitlement(job, reverse_stages)
        k = len(ent)
        if k > self.fleet.num_pods:
            raise AdmissionError(
                f"job {job.name!r} spans {k} pods, fleet has "
                f"{self.fleet.num_pods}")
        head = self.ledger.headroom()
        for base in range(self.fleet.num_pods - k + 1):
            if (head[base:base + k] >= ent).all():
                return base
        raise AdmissionError(
            f"no {k}-pod window with {ent.tolist()} free ports "
            f"(headroom={head.tolist()})")

    # ------------------------------------------------------------ admission
    def admit(self, name: str, job: JobSpec, *,
              reverse_stages: bool = False, port_min: bool = False,
              base_pod: int | None = None) -> Tenant:
        """Place, ledger-admit, build the local DAG, and plan the tenant."""
        ent = self.entitlement(job, reverse_stages)
        base = self.find_window(job, reverse_stages) if base_pod is None \
            else base_pod
        pods = tuple(range(base, base + len(ent)))
        if pods and pods[-1] >= self.fleet.num_pods:
            raise AdmissionError(f"window {pods} exceeds the fleet")
        head = self.ledger.headroom()[list(pods)]
        if (ent > head).any():
            raise AdmissionError(
                f"window {pods} has headroom {head.tolist()}, job needs "
                f"{ent.tolist()} (donated ports stay reserved)")
        self.ledger.admit(name, scatter(ent, pods, self.fleet.num_pods))
        try:
            with span("fleet.admit", tenant=name, pods=len(pods)):
                tenant = self._build_and_plan(name, job, pods,
                                              reverse_stages, port_min)
        except Exception:
            self.ledger.release(name)
            raise
        return tenant

    def _build_and_plan(self, name: str, job: JobSpec, pods: tuple[int, ...],
                        reverse_stages: bool, port_min: bool) -> Tenant:
        dag = self.build_dag(name, job, pods, reverse_stages)
        tenant = Tenant(name=name, job=job, pods=pods,
                        reverse_stages=reverse_stages, port_min=port_min,
                        dag=dag)
        self.plan(tenant)
        return tenant

    def build_dag(self, name: str, job: JobSpec, pods: tuple[int, ...],
                  reverse_stages: bool) -> CommDAG:
        limits = gather(self.ledger.limits(name), pods)
        cluster = ClusterSpec(
            num_pods=len(pods), port_limits=tuple(int(u) for u in limits),
            nic_bandwidth=self.fleet.nic_bandwidth,
            intra_pod_bandwidth=self.fleet.intra_pod_bandwidth)
        return build_comm_dag(job, reverse_stages=reverse_stages,
                              cluster=cluster)

    # ------------------------------------------------------------- planning
    def _solve_single(self, dag: CommDAG, port_min: bool) -> CachedPlan:
        """One port-aware DELTA-Fast solve of a local-view CommDAG."""
        problem = DESProblem(dag)
        P = dag.cluster.num_pods
        ideal = simulate(problem, np.zeros((P, P)), ideal=True)
        ga = delta_fast(dag, self.ga_options)
        x = ga.x
        if port_min and np.isfinite(ga.makespan):
            x = trim_ports(dag, x, options=self.des_options)
        res = simulate(problem, x)
        nct = res.comm_time / ideal.comm_time \
            if ideal.comm_time > 0 else float("inf")
        return CachedPlan(
            x=x, makespan=res.makespan, comm_time=res.comm_time,
            nct=nct, ideal_comm_time=ideal.comm_time,
            details={"generations": ga.generations,
                     "evaluations": ga.evaluations,
                     "port_min": port_min})

    def single_plan(self, dag: CommDAG,
                    port_min: bool) -> tuple[CachedPlan, bool]:
        """Cache-backed single-DAG plan (the unit every planning path --
        admission, robust references, traffic changes -- shares)."""
        return self.cache.get_or_plan(
            dag, lambda: self._solve_single(dag, port_min),
            extra=("delta-fast", port_min))

    def plan(self, tenant: Tenant) -> CachedPlan:
        """Port-aware DELTA-Fast solve behind the plan cache; commits the
        resulting allocation to the ledger."""
        with span("fleet.plan", tenant=tenant.name) as sp:
            plan, hit = self.single_plan(tenant.dag, tenant.port_min)
            sp.set(cache_hit=bool(hit))
        _PLANS.inc(path="single", cache="hit" if hit else "miss")
        plan.details["cache_hit"] = hit
        tenant.plan = plan
        tenant.base_plan = plan.copy()
        self.ledger.commit(tenant.name,
                           tenant.fleet_usage(self.fleet.num_pods))
        return plan

    def plan_robust(self, tenant: Tenant, incumbents: list[CommDAG],
                    objective: str = "max-regret") -> CachedPlan:
        """Robust plan over {incumbent DAGs + the tenant's current DAG}.

        Instead of replanning from scratch on every phase/traffic change --
        which assumes the OCS can rewire for free -- the tenant keeps one
        static topology scored against the whole set, so flipping back to
        a previous phase needs no reconfiguration.  Incumbents whose local
        cluster view no longer matches (e.g. recorded under different
        donated-port limits) are dropped; with no usable incumbent this
        degrades to the plain `plan` path.
        """
        if objective not in ROBUST_OBJECTIVES:
            # fail fast: a config typo is not an unplannable ensemble
            raise ValueError(f"unknown objective {objective!r}; "
                             f"pick from {ROBUST_OBJECTIVES}")
        cl = tenant.dag.cluster
        usable = [d for d in incumbents
                  if d.cluster.num_pods == cl.num_pods
                  and tuple(d.cluster.port_limits) == tuple(cl.port_limits)
                  and d.cluster.nic_bandwidth == cl.nic_bandwidth]
        # drop incumbents identical to the current DAG (phase flip-flops)
        cur_sig = dag_signature(tenant.dag)
        seen = {cur_sig}
        members, sigs = [tenant.dag], [cur_sig]
        for d in usable:
            sig = dag_signature(d)
            if sig not in seen:
                seen.add(sig)
                members.append(d)
                sigs.append(sig)
        if len(members) == 1:
            return self.plan(tenant)

        def member_refs() -> tuple[np.ndarray, int]:
            """Max-regret reference makespans, amortized through the fleet
            PlanCache: the refs ARE the members' best single-DAG plans,
            which the cache already stores from admission / previous phase
            plans, so they are never re-solved here on a hit."""
            refs, hits = [], 0
            for d in members:
                plan, hit = self.single_plan(d, tenant.port_min)
                refs.append(plan.makespan)
                hits += int(hit)
            return np.asarray(refs, dtype=np.float64), hits

        def solve() -> CachedPlan:
            refs, ref_hits = member_refs()
            if not (np.isfinite(refs) & (refs > 0)).all():
                raise _InfeasibleRefs(
                    f"infeasible member reference plans: {refs}")
            ensemble = DagEnsemble(
                members, names=[f"phase{i}" for i in range(len(members))])
            rob = delta_robust(ensemble, self.ga_options,
                               objective=objective, refs=refs)
            x = rob.x
            makespans = rob.makespans
            if tenant.port_min and rob.feasible:
                # port-min donors keep donating on the robust path: trim
                # circuits certified against EVERY member, so the freed
                # ports never break another phase's makespan
                from repro_torch.core.api import evaluate_on_ensemble
                x = trim_ports_ensemble(ensemble, x,
                                        options=self.des_options)
                makespans = evaluate_on_ensemble(ensemble, x)
            problem = DESProblem(tenant.dag)
            ideal = simulate(problem, np.zeros((len(tenant.pods),) * 2),
                             ideal=True)
            res = simulate(problem, x)
            nct = res.comm_time / ideal.comm_time \
                if ideal.comm_time > 0 else float("inf")
            return CachedPlan(
                x=x, makespan=res.makespan, comm_time=res.comm_time,
                nct=nct, ideal_comm_time=ideal.comm_time,
                details={"robust": True, "objective": objective,
                         "port_min": tenant.port_min,
                         "ref_cache_hits": ref_hits,
                         "num_members": len(members),
                         "member_makespans": makespans.tolist(),
                         "member_regrets": (makespans / rob.refs).tolist(),
                         "worst_regret": float(
                             (makespans / rob.refs).max()),
                         "generations": rob.generations,
                         "evaluations": rob.evaluations})

        try:
            with span("fleet.plan_robust", tenant=tenant.name,
                      members=len(members)):
                plan, hit = self.cache.get_or_plan(
                    tenant.dag, solve,
                    extra=("delta-robust", objective, tenant.port_min,
                           tuple(sorted(sigs))))
        except (InfeasiblePlacement, _InfeasibleRefs) as exc:
            # the robust search space can be empty even when every phase
            # plans fine alone: the *union* of active pairs may exceed a
            # pod's port budget (one circuit per incident pair is the
            # connectivity floor), and an incumbent member may have become
            # unplannable under the current limits (infeasible refs).
            # Degrade to the current-DAG plan instead of killing the
            # online replanning loop -- but never silently: the counter is
            # the authoritative degrade signal, the log line its echo.
            # Only these two degrade: an engine's error propagates.
            _ROBUST_DEGRADED.inc()
            _log.warning(
                "robust replan for tenant %r degraded to a single-DAG "
                "plan (%d members): %s", tenant.name, len(members), exc)
            return self.plan(tenant)
        _PLANS.inc(path="robust", cache="hit" if hit else "miss")
        plan.details["cache_hit"] = hit
        tenant.plan = plan
        tenant.base_plan = plan.copy()
        self.ledger.commit(tenant.name,
                           tenant.fleet_usage(self.fleet.num_pods))
        return plan

    # --------------------------------------------------------------- repair
    def repair(self, tenant: Tenant, mask: np.ndarray, *,
               rng: np.random.Generator | None = None,
               num_random: int = 8,
               dwell_s: float = DEFAULT_DWELL_S,
               reconfig_s_per_circuit: float = 0.01,
               replan_threshold: float = 1.2) -> dict:
        """Price and apply one repair decision for a tenant under a fabric
        capacity `mask` (its local (P, P) availability factor).

        Three options compete on the FastReChain-style price

            cost = delay + dwell_s * max(ms / ms_healthy - 1, 0)

        where `delay` is the option's reconfiguration delay (changed
        circuits x `reconfig_s_per_circuit`, zero for keep), `ms` its
        exact masked-DES makespan, and `ms_healthy` the incumbent
        topology's healthy makespan -- i.e. seconds of rewiring downtime
        now, plus the makespan inflation *relative to the healthy
        incumbent* (clamped at zero) paid on every iteration for the
        remaining phase dwell.  `dwell_s` defaults to the
        `DEFAULT_DWELL_S` prior; the fleet loop passes its per-tenant
        telemetry estimate (`FleetPlanner.dwell_for`).  An infeasible
        (partitioned) option prices at infinity:

          keep     run the incumbent topology through the degraded fabric
                   (zero delay, possibly large inflation -- or inf on a
                   partition);
          rewire   a mask-aware candidate portfolio within the tenant's
                   CURRENT ledger limits, scored in one fused masked
                   `batch_genome_makespan` call (cheap local surgery);
          replan   full DELTA-Failsafe GA solve against the mask, only
                   attempted when the best local option still inflates the
                   makespan beyond `replan_threshold` (it is the expensive
                   option, and cache-keyed by the rounded mask).

        The winner is certified with the exact numpy DES under the mask and
        committed to `tenant.plan` (and `base_plan`, so later grant
        revocations restore the *repaired* topology).  The caller commits
        the ledger allocation.  A mask of all-ones re-prices the plan at
        healthy capacity and reports option "healthy".
        """
        mask = np.asarray(mask, dtype=np.float64)
        problem = DESProblem(tenant.dag)
        x0 = np.asarray(tenant.plan.x, dtype=np.int64)
        # the committed plan's makespan may hold a *masked* value from a
        # previous repair -- always re-derive the healthy baseline
        healthy = simulate(problem, x0)
        ms_healthy = healthy.makespan
        ideal = tenant.plan.ideal_comm_time

        def nct_of(comm_time: float) -> float:
            return comm_time / ideal if ideal > 0 else INF

        if float(mask.min(initial=1.0)) >= 1.0 - 1e-12:
            tenant.plan.makespan = healthy.makespan
            tenant.plan.comm_time = healthy.comm_time
            tenant.plan.nct = nct_of(healthy.comm_time)
            tenant.base_plan = tenant.plan.copy()
            _REPAIRS.inc(option="healthy")
            return {"tenant": tenant.name, "option": "healthy",
                    "makespan": healthy.makespan,
                    "ms_healthy": ms_healthy, "delay_s": 0.0,
                    "cost_s": 0.0, "changed_circuits": 0, "options": {}}

        def price(ms: float, delay: float) -> float:
            """Seconds of delay now + expected seconds lost to the slowdown
            over one phase dwell.  An infeasible (partitioned) option is
            infinitely expensive."""
            if not np.isfinite(ms):
                return INF
            infl = max(ms / ms_healthy - 1.0, 0.0) \
                if np.isfinite(ms_healthy) and ms_healthy > 0 else 0.0
            return delay + dwell_s * infl

        # (name, x, masked makespan, delay, cost) -- list order breaks ties
        ms_keep = simulate(problem, x0.astype(np.float64) * mask).makespan
        options = [("keep", x0, ms_keep, 0.0, price(ms_keep, 0.0))]

        limits = gather(self.ledger.limits(tenant.name), tenant.pods)
        pairs = tenant.dag.undirected_pairs()
        if pairs:
            P = len(tenant.pods)
            eu, ev, g0, rem = _genome_view(x0, pairs, P)
            usage0 = rem.sum(axis=1)
            rng = rng if rng is not None else np.random.default_rng(0)
            G = _candidate_genomes(tenant.dag, g0, usage0, limits, eu, ev,
                                   rng, num_random=num_random)
            # mask-aware fill: a circuit on a degraded pair delivers only
            # `frac` of its bandwidth, so compensating lost capacity means
            # over-provisioning exactly those pairs (dead pairs excluded)
            vol = tenant.dag.traffic_matrix()
            uvol = vol[eu, ev] + vol[ev, eu]
            frac = mask[eu, ev]
            w_base = np.where(frac > 0, uvol / np.maximum(frac, 1e-9), -INF)
            g_mask = _greedy_fill(
                g0, usage0, limits, eu, ev,
                lambda g: w_base / np.maximum(g, 1))
            G = np.vstack([G, g_mask[None]])
            _, first = np.unique(G, axis=0, return_index=True)
            G = G[np.sort(first)]
            ms_c, feas = tenant.des(self.des_options).batch_genome_makespan(
                G, eu, ev, mask=mask)
            score = np.where(feas, np.asarray(ms_c), INF)
            best = int(np.argmin(score))
            x_rw = _scatter(G[best], eu, ev, P) + rem
            cert = simulate(problem, x_rw.astype(np.float64) * mask)
            delay = circuit_changes(x_rw, x0) * reconfig_s_per_circuit
            options.append(("rewire", x_rw, cert.makespan, delay,
                            price(cert.makespan, delay)))

        best_ms = min(o[2] for o in options)
        inflation = best_ms / ms_healthy \
            if np.isfinite(ms_healthy) and ms_healthy > 0 else INF
        if inflation > replan_threshold:
            def solve_failsafe() -> CachedPlan:
                res = delta_failsafe(tenant.dag, self.ga_options,
                                     scenarios=[mask])
                cert = simulate(problem,
                                np.asarray(res.x, np.float64) * mask)
                return CachedPlan(
                    x=np.asarray(res.x, dtype=np.int64),
                    makespan=cert.makespan, comm_time=cert.comm_time,
                    nct=nct_of(cert.comm_time), ideal_comm_time=ideal,
                    details={"failsafe": True,
                             "generations": res.generations,
                             "evaluations": res.evaluations})

            with span("fleet.repair_replan", tenant=tenant.name):
                plan_fs, hit = self.cache.get_or_plan(
                    tenant.dag, solve_failsafe,
                    extra=("delta-failsafe",
                           np.round(mask, 6).tobytes().hex()))
            _PLANS.inc(path="failsafe", cache="hit" if hit else "miss")
            x_fs = np.asarray(plan_fs.x, dtype=np.int64)
            ms_fs = plan_fs.makespan
            if (x_fs.sum(axis=1) > limits).any():
                # the failsafe GA solves against the dag's admission-time
                # port limits; the ledger may have seized ports since, so
                # clamp the plan to what the tenant may wire today
                x_fs = shrink_to_limits(x_fs, limits)
                ms_fs = simulate(
                    problem, x_fs.astype(np.float64) * mask).makespan
            delay = circuit_changes(x_fs, x0) * reconfig_s_per_circuit
            options.append(("replan", x_fs, ms_fs, delay,
                            price(ms_fs, delay)))

        name_w, x_w, _ms_w, delay_w, cost_w = min(options,
                                                  key=lambda o: o[4])
        res = simulate(problem, x_w.astype(np.float64) * mask)
        tenant.plan.x = np.asarray(x_w, dtype=np.int64)
        tenant.plan.makespan = res.makespan
        tenant.plan.comm_time = res.comm_time
        tenant.plan.nct = nct_of(res.comm_time)
        tenant.base_plan = tenant.plan.copy()
        _REPAIRS.inc(option=name_w)
        return {"tenant": tenant.name, "option": name_w,
                "ms_healthy": ms_healthy, "makespan": res.makespan,
                "delay_s": delay_w, "cost_s": cost_w,
                "changed_circuits": int(circuit_changes(x_w, x0)),
                "options": {n: {"makespan": m, "delay_s": d, "cost_s": c}
                            for n, _x, m, d, c in options}}

    # --------------------------------------------------------- phase change
    def change(self, tenant: Tenant, x_incumbent: np.ndarray, *,
               dwell_s: float, reconfig_s_per_circuit: float,
               mask: np.ndarray | None = None) -> dict:
        """Price and apply one steered phase change: `tenant` is the NEW
        tenant (its DAG already rebuilt for the arriving phase) and
        `x_incumbent` the topology committed for the previous phase.

        Two options compete on the same break-even as `repair`, priced
        against the best known plan for the new phase (`ms_new`):

          keep     run the new phase through the incumbent topology --
                   zero delay, `dwell_s * max(ms_keep / ms_new - 1, 0)`
                   expected seconds lost to inflation over the estimated
                   remaining dwell;
          replan   rewire to the new phase's cache-amortized DELTA-Fast
                   plan -- inflation-free but pays `changed_circuits x
                   reconfig_s_per_circuit` of rewiring delay now.

        Replan wins only if `dwell_s x inflation > delay` (strictly: ties
        keep the incumbent, a free hysteresis).  The winner is certified
        with the exact (masked, when `mask` is given) numpy DES,
        committed to `tenant.plan`/`base_plan` and the ledger.
        """
        problem = DESProblem(tenant.dag)
        P = len(tenant.pods)
        ideal = simulate(problem, np.zeros((P, P)), ideal=True)

        def msim(x):
            xe = np.asarray(x, dtype=np.float64)
            return simulate(problem, xe * mask if mask is not None else xe)

        x0 = np.asarray(x_incumbent, dtype=np.int64)
        keep_res = msim(x0)
        with span("fleet.change", tenant=tenant.name) as sp:
            plan_new, hit = self.single_plan(tenant.dag, tenant.port_min)
            sp.set(cache_hit=bool(hit))
        _PLANS.inc(path="steer", cache="hit" if hit else "miss")
        x_new = np.asarray(plan_new.x, dtype=np.int64)
        # the cached plan solved against admission-time limits; the ledger
        # may have seized ports since (cf. repair's failsafe clamp)
        limits = gather(self.ledger.limits(tenant.name), tenant.pods)
        if (x_new.sum(axis=1) > limits).any():
            x_new = shrink_to_limits(x_new, limits)
        new_res = msim(x_new)
        ms_new, ms_keep = new_res.makespan, keep_res.makespan
        delay = circuit_changes(x_new, x0) * reconfig_s_per_circuit
        if not np.isfinite(ms_keep):
            inflation, cost_keep = INF, INF
        elif np.isfinite(ms_new) and ms_new > 0:
            inflation = max(ms_keep / ms_new - 1.0, 0.0)
            cost_keep = dwell_s * inflation
        else:
            inflation, cost_keep = 0.0, 0.0
        cost_replan = delay if np.isfinite(ms_new) else INF
        if cost_replan < cost_keep:
            chosen, res, x_w = "replan", new_res, x_new
        else:
            chosen, res, x_w = "keep", keep_res, x0
        nct = res.comm_time / ideal.comm_time \
            if ideal.comm_time > 0 else INF
        tenant.plan = CachedPlan(
            x=np.asarray(x_w, dtype=np.int64).copy(),
            makespan=res.makespan, comm_time=res.comm_time, nct=nct,
            ideal_comm_time=ideal.comm_time,
            details={"steered": True, "option": chosen, "cache_hit": hit})
        tenant.base_plan = tenant.plan.copy()
        self.ledger.commit(tenant.name,
                           tenant.fleet_usage(self.fleet.num_pods))
        _STEERS.inc(option=chosen)
        return {"tenant": tenant.name, "option": chosen,
                "dwell_s": float(dwell_s), "ms_keep": ms_keep,
                "ms_replan": ms_new, "inflation": float(inflation),
                "delay_s": float(delay),
                "cost_keep_s": float(cost_keep),
                "cost_replan_s": float(cost_replan),
                "changed_circuits": int(circuit_changes(x_w, x0)),
                "cache_hit": bool(hit), "masked": mask is not None}

    def replan_reduced(self, tenant: Tenant) -> dict:
        """Rebuild the tenant's local view under its CURRENT ledger limits
        (after a port seizure or restoration) and replan through the cache.

        If the reduced budget makes the GA space infeasible (placement
        degree above the port budget), fall back to deterministically
        shrinking the incumbent topology to fit -- priced honestly with the
        exact DES, possibly at an infinite makespan if shrinking
        partitioned the job."""
        tenant.dag = self.build_dag(tenant.name, tenant.job, tenant.pods,
                                    tenant.reverse_stages)
        tenant._des = None
        tenant._xbar = None
        limits = gather(self.ledger.limits(tenant.name), tenant.pods)
        x_old = None if tenant.plan is None \
            else np.asarray(tenant.plan.x, dtype=np.int64)
        try:
            with span("fleet.replan_reduced", tenant=tenant.name):
                plan = self.plan(tenant)
            return {"tenant": tenant.name, "path": "replan",
                    "ports": int(plan.x.sum()), "makespan": plan.makespan,
                    "limits": limits.tolist()}
        except (InfeasiblePlacement, LedgerError) as exc:
            if x_old is None:
                raise
            x = shrink_to_limits(x_old, limits)
            problem = DESProblem(tenant.dag)
            P = len(tenant.pods)
            ideal = simulate(problem, np.zeros((P, P)), ideal=True)
            res = simulate(problem, x)
            nct = res.comm_time / ideal.comm_time \
                if ideal.comm_time > 0 else INF
            tenant.plan = CachedPlan(
                x=x, makespan=res.makespan, comm_time=res.comm_time,
                nct=nct, ideal_comm_time=ideal.comm_time,
                details={"shrunk": True, "error": type(exc).__name__})
            tenant.base_plan = tenant.plan.copy()
            self.ledger.commit(tenant.name,
                               tenant.fleet_usage(self.fleet.num_pods))
            _PLANS.inc(path="shrink", cache="miss")
            _log.warning(
                "reduced replan for tenant %r fell back to topology "
                "shrinking (limits %s): %s", tenant.name, limits.tolist(),
                exc)
            return {"tenant": tenant.name, "path": "shrink",
                    "ports": int(x.sum()), "makespan": res.makespan,
                    "limits": limits.tolist()}

    # ------------------------------------------------------------ departure
    def depart(self, tenant: Tenant) -> None:
        with contextlib.suppress(LedgerError):   # already released
            self.ledger.release(tenant.name)


def shrink_to_limits(x: np.ndarray, limits: np.ndarray) -> np.ndarray:
    """Deterministically drop circuits until per-pod usage fits `limits`:
    repeatedly remove one circuit from the most-oversubscribed pod's
    largest pair.  Always terminates with `x.sum(axis=1) <= limits`."""
    x = np.asarray(x, dtype=np.int64).copy()
    limits = np.asarray(limits, dtype=np.int64)
    while True:
        over = x.sum(axis=1) - limits
        p = int(np.argmax(over))
        if over[p] <= 0:
            break
        q = int(np.argmax(x[p]))
        if x[p, q] <= 0:   # pragma: no cover - over>0 implies a circuit
            break
        x[p, q] -= 1
        x[q, p] -= 1
    return x

