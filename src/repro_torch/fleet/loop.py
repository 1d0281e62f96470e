"""Event-driven fleet replanning loop.

The planner is a long-lived service consuming a stream of events:

  JobArrival     admit + place the job, plan its topology (cache-aware),
                 optionally donate the port savings of a port-minimized plan
  JobDeparture   release the tenant; its ports return to the pool
  TrafficChange  swap the tenant's JobSpec (same footprint), replan

After every event the loop runs a surplus pass: the grantable pool is
waterfilled across bandwidth-bottlenecked tenants (NCT above threshold) and
each boosted tenant is re-optimized with one batched `TorchDES` evaluation
(`repro_torch.fleet.realloc`).  The `PortLedger` conservation invariant is
checked after every event.  Every engine of the planner, the waterfill's
`fill_matvec` included, runs on the device of ``ga_options.des_options``
(None: the CUDA device, so a planner without one and without a device
named raises at construction).
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.core.cluster import split_port_budgets
from repro_torch.core.des import DESProblem, simulate
from repro_torch.core.des_torch import des_cache_stats
from repro_torch.core.ga import GAOptions, ROBUST_OBJECTIVES
from repro_torch.fleet.admission import (AdmissionController, AdmissionError,
                                         FleetSpec, Tenant)
# the event schema lives in repro_torch.fleet.events (single serialize/rebuild
# path); re-exported here so existing `from repro_torch.fleet.loop import ...`
# call sites keep working
from repro_torch.fleet.events import (FAULT_EVENTS, FleetEvent, JobArrival,
                                      JobDeparture, LinkFailure, LinkRecovery,
                                      PlaneFailure, PlaneRecovery, PortFailure,
                                      PortRecovery, TrafficChange,
                                      serialize_event)
from repro_torch.fleet.faults import FabricHealth
from repro_torch.fleet.planes import (PlaneBook, StaggeredTransition,
                                      TenantLane, split_plan)
from repro_torch.fleet.ledger import LedgerError, PortLedger, gather, scatter
from repro_torch.fleet.plancache import PlanCache
from repro_torch.fleet.realloc import port_demand, reallocate, waterfill_grants
from repro_torch.fleet.telemetry import DEFAULT_DWELL_S
from repro_torch.obs import REGISTRY, FleetJournal, get_counter, get_gauge, span

__all__ = ["FAULT_EVENTS", "FleetEvent", "FleetPlanner", "JobArrival",
           "JobDeparture", "LinkFailure", "LinkRecovery", "PlaneFailure",
           "PlaneRecovery", "PortFailure", "PortRecovery", "TrafficChange",
           "arrivals", "fault_events_from_trace"]

_EVENTS = get_counter("fleet_events_total",
                      "fleet events handled, by kind and outcome")
_GRANTS = get_counter("fleet_granted_ports_total",
                      "surplus ports granted by the waterfill pass")
_TENANTS = get_gauge("fleet_tenants", "currently admitted tenants")
_SNAPSHOTS = get_counter("fleet_snapshots_total",
                         "planner state snapshots written to the journal")


# ------------------------------------------------------------------- events
def fault_events_from_trace(trace: list[dict]) -> list[FleetEvent]:
    """Shared-trace-format dicts (`repro_torch.fleet.faults.FaultInjector`) ->
    live fleet fault events, in trace order (step_failure entries are
    training-loop faults, not fleet events; they are skipped here)."""
    out: list[FleetEvent] = []
    for ev in trace:
        kind = ev["kind"]
        if kind == "link_failure":
            out.append(LinkFailure(pair=tuple(ev["pair"]),
                                   fraction=float(ev.get("fraction", 1.0))))
        elif kind == "link_recovery":
            out.append(LinkRecovery(pair=tuple(ev["pair"])))
        elif kind == "port_failure":
            out.append(PortFailure(pod=int(ev["pod"]),
                                   count=int(ev.get("count", 1))))
        elif kind == "port_recovery":
            out.append(PortRecovery(pod=int(ev["pod"]),
                                    count=int(ev.get("count", 1))))
        elif kind == "plane_failure":
            out.append(PlaneFailure(plane=int(ev["plane"])))
        elif kind == "plane_recovery":
            out.append(PlaneRecovery(plane=int(ev["plane"])))
        elif kind != "step_failure":
            raise ValueError(f"unknown trace kind {kind!r}")
    return out


# ------------------------------------------------------------------ planner
class FleetPlanner:
    """Cluster-wide multi-tenant port manager (paper Sec. VI as a service)."""

    def __init__(self, fleet: FleetSpec,
                 ga_options: GAOptions | None = None,
                 cache: PlanCache | None = None,
                 nct_threshold: float = 1.005,
                 donors_can_receive: bool = False,
                 auto_realloc: bool = True,
                 num_random_candidates: int = 8,
                 robust_replan: bool = False,
                 robust_objective: str = "max-regret",
                 robust_history: int = 3,
                 seed: int = 0,
                 journal: FleetJournal | None = None,
                 num_planes: int = 4,
                 dwell_s: float = DEFAULT_DWELL_S,
                 reconfig_s_per_circuit: float = 0.01,
                 replan_threshold: float = 1.2,
                 snapshot_every: int = 0,
                 plane_slo: float = 3.0,
                 staggered: bool = True):
        self.fleet = fleet
        self.ledger = PortLedger(fleet.capacity())
        self.cache = cache if cache is not None else PlanCache()
        self.admission = AdmissionController(fleet, self.ledger, self.cache,
                                             ga_options)
        # the device every engine of the fleet runs on, settled up front
        self.device = self.admission.des_options.resolve_device()
        self.tenants: dict[str, Tenant] = {}
        self.nct_threshold = nct_threshold
        self.donors_can_receive = donors_can_receive
        self.auto_realloc = auto_realloc
        self.num_random_candidates = num_random_candidates
        # robust phase changes: instead of replanning from scratch, a
        # TrafficChange plans one static topology over {incumbent DAGs +
        # the arriving workload} (DELTA-Robust), bounded to the last
        # `robust_history` distinct incumbent phases.  Validate the
        # objective HERE: plan_robust degrades an unplannable ensemble
        # (`ga.InfeasiblePlacement`: empty union space) or infeasible
        # member refs to a plain plan, and a configuration typo must fail
        # before any event, not midway through the trace
        if robust_objective not in ROBUST_OBJECTIVES:
            raise ValueError(
                f"unknown robust_objective {robust_objective!r}; "
                f"pick from {ROBUST_OBJECTIVES}")
        self.robust_replan = robust_replan
        self.robust_objective = robust_objective
        self.robust_history = robust_history
        self.rng = np.random.default_rng(seed)
        self.realloc_batches = 0        # batched TorchDES calls issued
        self.realloc_candidates = 0     # topologies evaluated inside them
        # fabric failure state + repair-pricing knobs (DELTA-Failsafe).
        # `dwell_s` is the phase-dwell PRIOR (DEFAULT_DWELL_S): every
        # priced decision asks `dwell_for(name)`, which prefers the
        # per-tenant estimate a ControlPlane keeps current from telemetry
        self.health = FabricHealth(fleet.num_pods, num_planes)
        self.dwell_s = float(dwell_s)
        self.dwell_estimates: dict[str, float] = {}
        self.reconfig_s_per_circuit = float(reconfig_s_per_circuit)
        self.replan_threshold = float(replan_threshold)
        self.snapshot_every = int(snapshot_every)
        # DELTA-Planes: per-tenant lane decompositions + staggered rewires.
        # Topology changes on live tenants (traffic replans, fault repairs,
        # surplus boosts) apply through a `StaggeredTransition` -- one plane
        # dark at a time, each step SLO-checked -- instead of an atomic
        # full-fabric swap.  Unsplittable plans fall back to the atomic
        # path (pre-planes behavior), recorded per transition
        self.num_planes = int(num_planes)
        self.plane_slo = float(plane_slo)
        self.staggered = bool(staggered) and self.num_planes >= 2
        self.planes = PlaneBook(self.num_planes)
        self.transitions: list[dict] = []
        self._transition_seq = 0
        self._events_handled = 0
        self._degraded: set[str] = set()   # tenants priced under a mask
        self._shrunk: set[str] = set()     # tenants replanned under seizure
        self.history: list[dict] = []
        # structured decision log (JSONL-backed when given a path)
        self.journal = journal if journal is not None else FleetJournal()
        # planner-scoped metric view: report() reads DELTAS against this
        # snapshot, so two planners in one process never pollute each
        # other's compile-cache hit rate
        self._obs_scope = REGISTRY.scope()

    # ---------------------------------------------------------------- dwell
    def dwell_for(self, name: str) -> float:
        """Expected remaining phase dwell for a tenant: the telemetry
        estimate when a control plane maintains one, else the prior."""
        return float(self.dwell_estimates.get(name, self.dwell_s))

    def set_dwell_estimate(self, name: str, dwell_s: float) -> None:
        self.dwell_estimates[name] = float(dwell_s)

    # -------------------------------------------------------------- events
    def handle(self, event: FleetEvent) -> dict:
        # surplus grants are revocable leases: take them all back (restoring
        # each tenant's cached within-entitlement plan) before mutating the
        # fleet, then let the end-of-event surplus pass redistribute from
        # scratch over the new tenant mix
        kind = {JobArrival: "arrival", JobDeparture: "departure",
                TrafficChange: "traffic_change",
                LinkFailure: "link_failure", LinkRecovery: "link_recovery",
                PortFailure: "port_failure", PortRecovery: "port_recovery",
                PlaneFailure: "plane_failure",
                PlaneRecovery: "plane_recovery"}.get(type(event), "unknown")
        who = getattr(event, "name", "fabric")
        with span("fleet.handle", kind=kind, tenant=who):
            self.revoke_grants()
            try:
                if isinstance(event, JobArrival):
                    record = self._on_arrival(event)
                elif isinstance(event, JobDeparture):
                    record = self._on_departure(event)
                elif isinstance(event, TrafficChange):
                    record = self._on_traffic_change(event)
                elif isinstance(event, (LinkFailure, LinkRecovery,
                                        PlaneFailure, PlaneRecovery)):
                    record = self._on_fabric_change(event, kind)
                elif isinstance(event, (PortFailure, PortRecovery)):
                    record = self._on_port_change(event, kind)
                else:
                    raise TypeError(f"unknown fleet event {event!r}")
            except Exception as exc:
                # the event failed after grants were revoked: re-run the
                # surplus pass so running tenants get their boosts back,
                # then propagate
                _EVENTS.inc(kind=kind, outcome="error")
                self.journal.record("fleet_error", event_kind=kind,
                                    tenant=who,
                                    error=type(exc).__name__)
                if self.auto_realloc:
                    self.replan_surplus()
                raise
            if self.auto_realloc:
                record["realloc"] = self.replan_surplus()
            self.ledger.check()
            self._sync_planes()
            self.history.append(record)
            _EVENTS.inc(kind=kind, outcome="ok")
            _TENANTS.set(len(self.tenants))
            self.journal.record_event(event, record)
            self._events_handled += 1
            if self.snapshot_every > 0 \
                    and self._events_handled % self.snapshot_every == 0:
                self.journal.record("fleet_snapshot", state=self.snapshot())
                _SNAPSHOTS.inc()
            return record

    def process(self, events) -> list[dict]:
        return [self.handle(e) for e in events]

    # ------------------------------------------------------------- arrival
    def _on_arrival(self, ev: JobArrival) -> dict:
        if ev.name in self.tenants:
            raise AdmissionError(f"tenant {ev.name!r} already admitted")
        tenant = self.admission.admit(
            ev.name, ev.job, reverse_stages=ev.reverse_stages,
            port_min=ev.port_min, base_pod=ev.base_pod)
        self.tenants[ev.name] = tenant
        donate = ev.port_min if ev.donate_surplus is None \
            else ev.donate_surplus
        donated = self.ledger.donate(ev.name) if donate \
            else np.zeros(self.fleet.num_pods, dtype=np.int64)
        plan = tenant.plan
        return {"event": "arrival", "tenant": ev.name,
                "pods": list(tenant.pods),
                "cache_hit": bool(plan.details.get("cache_hit")),
                "nct": plan.nct, "ports": int(plan.x.sum()),
                "donated_ports": int(donated.sum())}

    # ----------------------------------------------------------- departure
    def _on_departure(self, ev: JobDeparture) -> dict:
        tenant = self.tenants.pop(ev.name, None)
        if tenant is None:
            raise LedgerError(f"unknown tenant {ev.name!r}")
        self.admission.depart(tenant)
        self.planes.pop(ev.name)
        return {"event": "departure", "tenant": ev.name,
                "pods": list(tenant.pods)}

    # ------------------------------------------------------ traffic change
    def _on_traffic_change(self, ev: TrafficChange) -> dict:
        tenant = self.tenants.get(ev.name)
        if tenant is None:
            raise LedgerError(f"unknown tenant {ev.name!r}")
        old_ent = self.admission.entitlement(tenant.job,
                                             tenant.reverse_stages)
        new_ent = self.admission.entitlement(ev.job, tenant.reverse_stages)
        if not np.array_equal(old_ent, new_ent):
            raise AdmissionError(
                f"traffic change for {ev.name!r} alters the placement "
                f"footprint; depart + re-arrive instead")
        # grants were already revoked in handle(); take donations back too
        self.ledger.withdraw_donation(ev.name)
        nct_before = tenant.plan.nct if tenant.plan else float("inf")
        x_before = None if tenant.plan is None else \
            np.asarray(tenant.plan.x, dtype=np.int64).copy()
        incumbents = (tenant.dag_history + [tenant.dag])[
            -self.robust_history:] if self.robust_history > 0 else []
        new_tenant = Tenant(
            name=ev.name, job=ev.job, pods=tenant.pods,
            reverse_stages=tenant.reverse_stages, port_min=tenant.port_min,
            dag=self.admission.build_dag(ev.name, ev.job, tenant.pods,
                                         tenant.reverse_stages),
            dag_history=incumbents)
        decision = None
        if ev.steered and tenant.plan is not None:
            # control-plane change: price keep-vs-replan with the tenant's
            # estimated remaining dwell (FastReChain break-even) instead
            # of replanning unconditionally
            mask = self.health.local_mask(tenant.pods)
            if float(mask.min(initial=1.0)) >= 1.0 - 1e-12:
                mask = None
            decision = self.admission.change(
                new_tenant, x_incumbent=tenant.plan.x,
                dwell_s=self.dwell_for(ev.name),
                reconfig_s_per_circuit=self.reconfig_s_per_circuit,
                mask=mask)
            if mask is None:
                self._degraded.discard(ev.name)
            else:
                self._degraded.add(ev.name)
        elif self.robust_replan:
            self.admission.plan_robust(new_tenant, incumbents,
                                       objective=self.robust_objective)
        else:
            self.admission.plan(new_tenant)
        self.tenants[ev.name] = new_tenant
        transition = None
        if x_before is not None and new_tenant.plan is not None:
            transition = self._apply_staggered(
                {ev.name: (x_before, new_tenant.plan.x)}, "traffic_change")
            if transition is not None \
                    and transition["status"] == "rolled_back":
                # the new topology could not be reached within the SLO:
                # keep the OLD circuits, priced on the NEW dag
                self._revert_plan(ev.name, x_before)
        donated = self.ledger.donate(ev.name) if tenant.port_min \
            else np.zeros(self.fleet.num_pods, dtype=np.int64)
        details = new_tenant.plan.details
        record = {"event": "traffic_change", "tenant": ev.name,
                  "nct_before": nct_before, "nct": new_tenant.plan.nct,
                  "cache_hit": bool(details.get("cache_hit")),
                  "robust": bool(details.get("robust")),
                  "robust_members": details.get("num_members", 1),
                  "worst_regret": details.get("worst_regret"),
                  "donated_ports": int(donated.sum())}
        if decision is not None:
            record["steered"] = True
            record["decision"] = decision
        if transition is not None:
            record["transition"] = transition
        return record

    # ------------------------------------------------------- fabric faults
    def _on_fabric_change(self, ev, kind: str) -> dict:
        """Link / plane capacity events: mutate FabricHealth, then run the
        priced repair decision for every tenant the damage (old or new)
        touches, plus every tenant still priced under a previous mask."""
        affected = {n for n, t in self.tenants.items()
                    if self.health.affects(t.pods)}
        if isinstance(ev, LinkFailure):
            self.health.fail_link(ev.pair, ev.fraction)
        elif isinstance(ev, LinkRecovery):
            self.health.recover_link(ev.pair)
        elif isinstance(ev, PlaneFailure):
            self.health.fail_plane(ev.plane)
        else:
            self.health.recover_plane(ev.plane)
        affected |= {n for n, t in self.tenants.items()
                     if self.health.affects(t.pods)}
        affected |= self._degraded & set(self.tenants)
        repairs = []
        for name in sorted(affected):
            if self.tenants[name].plan is None:  # pragma: no cover
                continue
            repairs.append(self._repair_tenant(name))
        mask = self.health.mask()
        record = {"event": kind,
                  "mask_min": float(mask.min()) if mask.size else 1.0,
                  "healthy": self.health.healthy, "repairs": repairs}
        if hasattr(ev, "pair"):
            record["pair"] = list(ev.pair)
        else:
            record["plane"] = ev.plane
        return record

    def _repair_tenant(self, name: str) -> dict:
        """One priced repair decision + ledger commit + degraded-set
        bookkeeping for a single tenant under the current fabric mask."""
        tenant = self.tenants[name]
        x_before = None if tenant.plan is None else \
            np.asarray(tenant.plan.x, dtype=np.int64).copy()
        decision = self.admission.repair(
            tenant, self.health.local_mask(tenant.pods), rng=self.rng,
            num_random=self.num_random_candidates,
            dwell_s=self.dwell_for(name),
            reconfig_s_per_circuit=self.reconfig_s_per_circuit,
            replan_threshold=self.replan_threshold)
        self.ledger.commit(name, tenant.fleet_usage(self.fleet.num_pods))
        if decision["option"] == "healthy":
            self._degraded.discard(name)
        else:
            self._degraded.add(name)
        if x_before is not None \
                and not np.array_equal(x_before, tenant.plan.x):
            # a rewire/replan repair moves circuits: stagger it too.  The
            # engine reads the CURRENT dark planes live, so a repair fired
            # by a PlaneFailure prices every step against the already-
            # degraded fabric (doubly-dark intermediate states)
            transition = self._apply_staggered(
                {name: (x_before, tenant.plan.x)}, "repair")
            if transition is not None \
                    and transition["status"] == "rolled_back":
                self._revert_plan(name, x_before)
            if transition is not None:
                decision["transition"] = transition
        return decision

    def _on_port_change(self, ev, kind: str) -> dict:
        """Port failures hit the ledger (escalating pool -> grants ->
        seized entitlement -> stranding); stranded tenants are replanned
        under their reduced limits before the end-of-event check()."""
        record: dict = {"event": kind, "pod": ev.pod, "count": ev.count}
        replans: list[dict] = []
        replanned: list[str] = []
        if isinstance(ev, PortFailure):
            stranded = self.ledger.fail_ports(ev.pod, ev.count)
            for name in sorted(stranded):
                tenant = self.tenants.get(name)
                if tenant is None:   # pragma: no cover - defensive
                    continue
                replans.append(self.admission.replan_reduced(tenant))
                self._shrunk.add(name)
                replanned.append(name)
            record["stranded"] = sorted(stranded)
        else:
            record["restored"] = int(
                self.ledger.restore_ports(ev.pod, ev.count))
            # shrunk tenants whose seizures are fully healed get their
            # original budget (and, via the cache, original plan) back
            for name in sorted(self._shrunk & set(self.tenants)):
                if self.ledger.account(name).seized.sum() == 0:
                    replans.append(
                        self.admission.replan_reduced(self.tenants[name]))
                    self._shrunk.discard(name)
                    replanned.append(name)
        # replan_reduced prices against the healthy fabric; on a damaged
        # fabric the committed plan must carry masked pricing, so run the
        # repair decision on every tenant that was just replanned
        repairs = [self._repair_tenant(name) for name in replanned
                   if self.health.affects(self.tenants[name].pods)]
        if repairs:
            record["repairs"] = repairs
        record["replans"] = replans
        record["failed_ports"] = int(self.ledger.failed.sum())
        return record

    # ------------------------------------------- staggered plane rewires
    def _tenant_budgets(self, name: str, pods) -> np.ndarray:
        """Per-plane port budgets for a tenant's local pod window, derived
        from its CURRENT ledger limits (entitlement + grants - seizures)
        by the deterministic `split_port_budgets` rule -- a pure function
        of the event stream, so journal replay reproduces bit-identical
        lane stacks."""
        limits = gather(self.ledger.limits(name), pods)
        return np.asarray(
            split_port_budgets(tuple(int(u) for u in limits),
                               self.num_planes), dtype=np.int64)

    def _lane_stack(self, name: str, x: np.ndarray) -> np.ndarray | None:
        """The tenant's lane stack for topology `x`: the book entry when
        it already sums to `x`, else a fresh deterministic split (None if
        `x` does not decompose under the per-plane budgets)."""
        book = self.planes.get(name)
        if book is not None and np.array_equal(book.sum(axis=0), x):
            return book
        return split_plan(x, self._tenant_budgets(
            name, self.tenants[name].pods))

    def _apply_staggered(self, movers: dict, reason: str) -> dict | None:
        """Apply ``{name: (x_old, x_new)}`` topology changes as ONE
        staggered transition.  Returns the JSON-safe transition record,
        or None when staggering is off, nothing actually moved, or any
        mover's plan does not decompose (the caller keeps the atomic
        swap it already made -- pre-planes behavior).  A ``rolled_back``
        record means the caller must revert the movers to x_old
        (`_revert_plan`)."""
        if not self.staggered:
            return None
        movers = {n: (np.asarray(a, dtype=np.int64),
                      np.asarray(b, dtype=np.int64))
                  for n, (a, b) in movers.items()
                  if not np.array_equal(a, b)}
        if not movers:
            return None
        lanes: list[TenantLane] = []
        assignments: dict[str, np.ndarray] = {}
        for name in sorted(movers):
            x_old, x_new = movers[name]
            tenant = self.tenants[name]
            planes_a = self._lane_stack(name, x_old)
            budgets = self._tenant_budgets(name, tenant.pods)
            planes_b = split_plan(x_new, budgets)
            if planes_a is None or planes_b is None:
                return None
            lanes.append(TenantLane(name=name, dag=tenant.dag,
                                    pods=tenant.pods, planes_a=planes_a,
                                    planes_b=planes_b))
            assignments[name] = planes_b
        # bystanders suffer every intermediate dark plane too and count
        # toward the SLO; an unsplittable bystander simply is not priced
        for name in sorted(set(self.tenants) - set(movers)):
            tenant = self.tenants[name]
            if tenant.plan is None:
                continue
            planes = self._lane_stack(
                name, np.asarray(tenant.plan.x, dtype=np.int64))
            if planes is None:
                continue
            lanes.append(TenantLane(name=name, dag=tenant.dag,
                                    pods=tenant.pods, planes_a=planes,
                                    planes_b=planes))
        tid = f"t{self._transition_seq}"
        self._transition_seq += 1
        engine = StaggeredTransition(
            lanes, self.health, slo=self.plane_slo,
            reconfig_s_per_circuit=self.reconfig_s_per_circuit,
            transition_id=tid)
        result = engine.run()
        # plane events are decision OUTPUTS: journaled for audit under
        # their own record kind (EVENTS_VERSION 3), skipped by replay --
        # the replaying planner regenerates identical steps by re-driving
        # this deterministic scheduler
        for step in result.steps:
            self.journal.record("plane_event",
                                event=serialize_event(step))
        self.journal.record("plane_event",
                            event=serialize_event(result.summary))
        if result.committed:
            for name, planes in assignments.items():
                self.planes.assign(name, planes)
        record = result.record()
        record["reason"] = reason
        self.transitions.append(record)
        return record

    def _revert_plan(self, name: str, x_old: np.ndarray) -> None:
        """Roll a tenant's committed plan back to `x_old` after a
        rolled-back transition, certified on its CURRENT dag under the
        fabric mask (the admission.repair keep-path conventions)."""
        tenant = self.tenants[name]
        x_old = np.asarray(x_old, dtype=np.int64)
        problem = DESProblem(tenant.dag)
        mask = self.health.local_mask(tenant.pods)
        degraded = float(mask.min(initial=1.0)) < 1.0 - 1e-12
        res = simulate(problem, x_old.astype(np.float64) * mask) \
            if degraded else simulate(problem, x_old)
        ideal = tenant.plan.ideal_comm_time
        tenant.plan.x = x_old
        tenant.plan.makespan = res.makespan
        tenant.plan.comm_time = res.comm_time
        tenant.plan.nct = res.comm_time / ideal if ideal > 0 \
            else float("inf")
        tenant.base_plan = tenant.plan.copy()
        self.ledger.commit(name, tenant.fleet_usage(self.fleet.num_pods))
        if degraded:
            self._degraded.add(name)

    def _sync_planes(self) -> None:
        """End-of-event safety net: every tenant whose committed plan.x
        is not what its book entry sums to gets a fresh deterministic
        split.  This covers the atomic-exempt paths -- arrival's initial
        assignment, grant revocation restoring base plans, seizure
        shrinks -- where no incumbent circuits move plane-by-plane.
        Unsplittable plans leave no entry (a pure atomic tenant)."""
        if not self.staggered:
            return
        for name in sorted(set(self.planes.lanes) - set(self.tenants)):
            self.planes.pop(name)
        for name in sorted(self.tenants):
            tenant = self.tenants[name]
            if tenant.plan is None:
                continue
            x = np.asarray(tenant.plan.x, dtype=np.int64)
            total = self.planes.total(name)
            if total is not None and np.array_equal(total, x):
                continue
            planes = split_plan(x, self._tenant_budgets(name, tenant.pods))
            if planes is None:
                self.planes.pop(name)
            else:
                self.planes.assign(name, planes)

    # -------------------------------------------------------- surplus pass
    def revoke_grants(self) -> int:
        """Take back every outstanding grant, restoring base plans."""
        revoked = 0
        for tenant in self.tenants.values():
            acct = self.ledger.account(tenant.name)
            if acct.granted.sum() == 0:
                continue
            if tenant.base_plan is not None:
                tenant.plan = tenant.base_plan.copy()
            self.ledger.commit(tenant.name,
                               tenant.fleet_usage(self.fleet.num_pods))
            revoked += int(self.ledger.reclaim(tenant.name).sum())
        return revoked

    def bottlenecked(self) -> list[Tenant]:
        """Tenants whose comm time exceeds the non-blocking ideal by more
        than the threshold.  Port-minimized donors opted into minimal ports
        (their savings belong to co-tenants, Fig. 10) and are excluded
        unless `donors_can_receive` is set."""
        return [t for t in self.tenants.values()
                if t.plan is not None and np.isfinite(t.plan.nct)
                and t.plan.nct > self.nct_threshold
                and (self.donors_can_receive or not t.port_min)]

    def replan_surplus(self) -> list[dict]:
        """Waterfill the pool across bottlenecked tenants, re-optimize each
        boosted tenant with one batched DES evaluation."""
        pool = self.ledger.pool()
        needy = self.bottlenecked()
        if pool.sum() <= 0 or not needy:
            return []
        with span("fleet.surplus_pass", needy=len(needy),
                  pool=int(pool.sum())):
            return self._surplus_pass(pool, needy)

    def _surplus_pass(self, pool: np.ndarray,
                      needy: list[Tenant]) -> list[dict]:
        demands = np.stack([
            scatter(port_demand(t.dag, t.plan.x, xbar=t.xbar()), t.pods,
                    self.fleet.num_pods) for t in needy])
        grants = waterfill_grants(demands, pool, device=self.device)
        outcomes: list[dict] = []
        for tenant, g in zip(needy, grants):
            if g.sum() <= 0:
                continue
            self.ledger.grant(tenant.name, g)
            _GRANTS.inc(int(g.sum()))
            boosted = gather(self.ledger.limits(tenant.name), tenant.pods)
            # a degraded tenant's committed plan is priced against the
            # fabric mask; the surplus pass must keep pricing it that way
            # or a grant would silently revert the plan to healthy numbers
            mask = (self.health.local_mask(tenant.pods)
                    if tenant.name in self._degraded else None)
            res = reallocate(
                tenant.dag, tenant.plan.x, boosted,
                tenant.plan.ideal_comm_time,
                des=tenant.des(self.admission.des_options), rng=self.rng,
                num_random=self.num_random_candidates,
                base_makespan=tenant.plan.makespan,
                base_comm_time=tenant.plan.comm_time, mask=mask,
                dwell_s=self.dwell_for(tenant.name),
                reconfig_s_per_circuit=self.reconfig_s_per_circuit)
            self.realloc_batches += res.batch_calls
            self.realloc_candidates += res.num_candidates
            nct_before = tenant.plan.nct
            improved = res.improved
            transition = None
            if improved:
                # stagger the boost BEFORE committing it; a rolled-back
                # transition declines the boost (plan unchanged, the
                # grant goes back to the pool below)
                transition = self._apply_staggered(
                    {tenant.name: (tenant.plan.x, res.x)}, "surplus")
                if transition is not None \
                        and transition["status"] == "rolled_back":
                    improved = False
            if improved:
                tenant.plan.x = res.x
                tenant.plan.makespan = res.makespan
                tenant.plan.comm_time = res.comm_time
                tenant.plan.nct = res.nct
                self.ledger.commit(tenant.name,
                                   tenant.fleet_usage(self.fleet.num_pods))
            # hand unused grant back to the pool either way
            acct = self.ledger.account(tenant.name)
            returned = self.ledger.reclaim(
                tenant.name, np.minimum(acct.granted, acct.surplus))
            outcome = {
                "tenant": tenant.name, "granted": int(g.sum()),
                "kept": int(g.sum() - returned.sum()),
                "nct_before": nct_before, "nct_after": tenant.plan.nct,
                "improved": improved,
                "candidates": res.num_candidates}
            if transition is not None:
                outcome["transition"] = transition
            outcomes.append(outcome)
        return outcomes

    # ---------------------------------------------------- crash recovery
    def snapshot(self) -> dict:
        """Full JSON-safe planner state: ledger, fabric health, rng,
        tenants (DAGs + plans), plan cache and decision history.  Written
        to the journal every `snapshot_every` events; `restore`/`recover`
        are the inverse."""
        from repro_torch.obs.journal import (_jobspec_to_dict, serialize_dag,
                                             serialize_plan)
        return {
            "ledger": self.ledger.snapshot(),
            "health": self.health.snapshot(),
            "planes": self.planes.snapshot(),
            "transition_seq": self._transition_seq,
            "transitions": list(self.transitions),
            "rng_state": self.rng.bit_generator.state,
            "dwell_estimates": dict(self.dwell_estimates),
            "degraded": sorted(self._degraded),
            "shrunk": sorted(self._shrunk),
            "events_handled": self._events_handled,
            "realloc": {"batches": self.realloc_batches,
                        "candidates": self.realloc_candidates},
            "cache_stats": [self.cache.hits, self.cache.misses],
            "cache": {sig: serialize_plan(p)
                      for sig, p in self.cache._store.items()},
            "tenants": {
                name: {"job": _jobspec_to_dict(t.job),
                       "pods": list(t.pods),
                       "reverse_stages": t.reverse_stages,
                       "port_min": t.port_min,
                       "dag": serialize_dag(t.dag),
                       "dag_history": [serialize_dag(d)
                                       for d in t.dag_history],
                       "plan": serialize_plan(t.plan),
                       "base_plan": serialize_plan(t.base_plan)}
                for name, t in self.tenants.items()},
            # copy: the in-memory journal keeps snapshot dicts by
            # reference, and the live history keeps growing after this
            "history": list(self.history),
        }

    @classmethod
    def restore(cls, snap: dict, fleet: FleetSpec,
                **kwargs) -> "FleetPlanner":
        """Rebuild a planner from a `snapshot()` dict.  Constructor
        options (`ga_options`, thresholds, `journal`, ...) are re-supplied
        via kwargs; everything stateful comes from the snapshot."""
        from repro_torch.obs.journal import (_jobspec_from_dict, rebuild_dag,
                                             rebuild_plan)
        planner = cls(fleet, **kwargs)
        planner.ledger = PortLedger.from_snapshot(snap["ledger"])
        planner.admission.ledger = planner.ledger
        planner.health = FabricHealth.from_snapshot(snap["health"])
        # pre-v3 snapshots carry no plane book; `_sync_planes` rebuilds it
        # deterministically on the next handled event
        if "planes" in snap:
            planner.planes = PlaneBook.from_snapshot(snap["planes"])
        planner._transition_seq = int(snap.get("transition_seq", 0))
        planner.transitions = list(snap.get("transitions", []))
        planner.rng = np.random.default_rng(0)
        planner.rng.bit_generator.state = snap["rng_state"]
        planner.dwell_estimates = {
            k: float(v) for k, v in snap.get("dwell_estimates", {}).items()}
        planner._degraded = set(snap.get("degraded", ()))
        planner._shrunk = set(snap.get("shrunk", ()))
        planner._events_handled = int(snap.get("events_handled", 0))
        planner.realloc_batches = int(snap["realloc"]["batches"])
        planner.realloc_candidates = int(snap["realloc"]["candidates"])
        hits, misses = snap.get("cache_stats", (0, 0))
        planner.cache.hits, planner.cache.misses = int(hits), int(misses)
        # in-place: admission shares this PlanCache object
        planner.cache._store.clear()
        planner.cache._store.update(
            {sig: rebuild_plan(p) for sig, p in snap.get("cache",
                                                         {}).items()})
        for name, ts in snap.get("tenants", {}).items():
            planner.tenants[name] = Tenant(
                name=name, job=_jobspec_from_dict(ts["job"]),
                pods=tuple(ts["pods"]),
                reverse_stages=bool(ts["reverse_stages"]),
                port_min=bool(ts["port_min"]),
                dag=rebuild_dag(ts["dag"]),
                dag_history=[rebuild_dag(d) for d in ts["dag_history"]],
                plan=rebuild_plan(ts["plan"]),
                base_plan=rebuild_plan(ts["base_plan"]))
        planner.history = list(snap.get("history", []))
        planner.ledger.check()
        _TENANTS.set(len(planner.tenants))
        return planner

    @classmethod
    def recover(cls, entries, fleet: FleetSpec, **kwargs) -> "FleetPlanner":
        """Crash recovery from a journal (a path or its entry list):
        restore the most recent `fleet_snapshot`, then replay the tail of
        `fleet_event` entries through `handle()`.  With no snapshot the
        whole journal is replayed from a fresh planner."""
        from repro_torch.obs.journal import rebuild_event
        if isinstance(entries, (str, os.PathLike)):
            entries = FleetJournal.load(entries)
        snap_idx = max((i for i, e in enumerate(entries)
                        if e.get("kind") == "fleet_snapshot"), default=None)
        if snap_idx is None:
            planner = cls(fleet, **kwargs)
            tail = entries
        else:
            planner = cls.restore(entries[snap_idx]["state"], fleet,
                                  **kwargs)
            tail = entries[snap_idx + 1:]
        for e in tail:
            if e.get("kind") == "fleet_event":
                planner.handle(rebuild_event(e["event"]))
        return planner

    # ------------------------------------------------------------- reports
    def report(self) -> dict:
        sc = self._obs_scope
        return {
            "tenants": {
                name: {"pods": list(t.pods), "nct": t.plan.nct,
                       "makespan": t.plan.makespan,
                       "ports": int(t.plan.x.sum()),
                       "reverse_stages": t.reverse_stages,
                       "port_min": t.port_min}
                for name, t in self.tenants.items() if t.plan is not None},
            "ledger": self.ledger.snapshot(),
            "cache": self.cache.stats(),
            # engine-cache churn: misses are new buckets; a healthy fleet
            # loop is all hits after warm-up.  Hits/misses/evictions
            # are DELTAS against the registry scope captured at planner
            # construction, so a second planner in the same process does
            # not pollute this planner's numbers; `entries` is the live
            # process-wide cache size (a gauge, not attributable)
            "des_cache": {
                "hits": int(sc.delta("des_compile_hits_total")),
                "misses": int(sc.delta("des_compile_miss_total")),
                "evictions": int(sc.delta("des_compile_evictions_total")),
                "entries": des_cache_stats()["entries"]},
            "events": {k or "total": int(v) for k, v in
                       sc.deltas("fleet_events_total").items() if v},
            "realloc": {"batches": self.realloc_batches,
                        "candidates": self.realloc_candidates,
                        "granted_ports": int(
                            sc.delta("fleet_granted_ports_total"))},
            "planes": {
                "staggered": self.staggered,
                "num_planes": self.num_planes,
                "tracked": sorted(self.planes.lanes),
                "transitions": len(self.transitions),
                "committed": sum(t["status"] == "committed"
                                 for t in self.transitions),
                "rolled_back": sum(t["status"] == "rolled_back"
                                   for t in self.transitions),
                "rewire_steps": int(sc.delta("planes_rewire_steps_total")),
                "peak_inflation": max(
                    (t["peak_inflation"] for t in self.transitions),
                    default=1.0)},
        }


def arrivals(*specs) -> list[JobArrival]:
    """Convenience: (name, job[, kwargs]) tuples -> JobArrival events.
    JobArrival instances pass through unchanged."""
    events = []
    for spec in specs:
        if isinstance(spec, JobArrival):
            events.append(spec)
            continue
        name, job = spec[0], spec[1]
        kw = dict(spec[2]) if len(spec) > 2 else {}
        events.append(JobArrival(name=name, job=job, **kw))
    return events
