"""DELTA-Planes: k-plane fabric decomposition + staggered, SLO-guarded
zero-downtime transitions.

The fabric is k parallel OCS planes; a tenant's logical topology x is
carried as k per-plane lane allocations summing to x (`PlaneBook`,
`split_plan` -- the balanced split of `repro_torch.core.ga.split_across_planes`
under the deterministic `split_port_budgets` budgets).  Moving the fleet
from incumbent plan A to target plan B then never needs a full-fabric
dark window: `StaggeredTransition` rewires one plane at a time, and every
intermediate state is exactly "one plane dark" (the plane being rewired;
`FabricHealth.fail_plane` physics) plus the already-rewired planes'
*new* circuits.

Every step is priced with the masked numpy DES oracle
(`repro_torch.core.des.simulate` on the float effective topology -- certified,
never the float32 torch path), steps are greedily ordered to minimize the
certified peak per-tenant makespan inflation, and a round where every
remaining step would breach the inflation SLO triggers rollback to plan A
(rollback steps are forced -- the fleet is never stranded between plans).
The scheduler reads its `FabricHealth` reference LIVE at every step: a
`PlaneFailure` landing mid-transition changes the next round's reference
and candidate pricing, so the engine re-prices against the doubly-
degraded fabric and either continues or rolls back.

Pricing conventions (shared with `plane_state_genomes` and
`failure_scenarios`):

  * the reference makespan is re-measured each round from the CURRENT
    mixed state under the fabric's own damage (marginal-cost semantics:
    a step's inflation is its slowdown on top of what the fabric already
    imposes);
  * a pair carried entirely by dark planes keeps a fractional ``x/k``
    trickle while at least one plane is lit (transient buffering);
    with ALL planes dark it prices as a true blackout (capacity 0 ->
    infinite makespan), so a full-fabric dark window can never pass an
    SLO check;
  * link damage (`FabricHealth.link_frac`) multiplies on top; the
    fabric's dark planes enter through the explicit lane subtraction,
    NOT through `plane_factor` (that would double-count them).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.des import DESProblem, simulate
from repro_torch.fleet.events import PlaneRewireStep, PlaneTransitionSummary
from repro_torch.fleet.faults import FabricHealth
from repro_torch.fleet.realloc import plane_circuit_changes
from repro_torch.obs import get_counter, span

INF = float("inf")

_STEPS = get_counter("planes_rewire_steps_total",
                     "staggered single-plane rewire steps performed")
_ROLLBACKS = get_counter("planes_rollbacks_total",
                         "staggered transitions rolled back to plan A")


def split_plan(x: np.ndarray, budgets) -> np.ndarray | None:
    """Balanced per-plane split of a tenant plan, or None when the plan
    does not decompose under the per-plane budgets (integrality can make
    the split infeasible even when x fits the summed budget -- the fleet
    then falls back to an atomic swap for that tenant)."""
    from repro_torch.core.ga import split_across_planes
    try:
        return split_across_planes(x, budgets)
    except ValueError:
        return None


def effective_topology(planes: np.ndarray, dark: set[int] | frozenset[int]
                       ) -> np.ndarray:
    """Float effective topology of a (k, P, P) lane stack with the given
    planes dark.  Pairs carried entirely by dark planes keep an ``x/k``
    trickle while any plane is lit, and collapse to 0 (blackout) when
    every plane is dark -- see the module docstring."""
    planes = np.asarray(planes)
    k = len(planes)
    x = planes.sum(axis=0).astype(np.float64)
    idx = [p for p in dark if 0 <= p < k]
    eff = x - planes[idx].sum(axis=0) if idx else x.copy().astype(np.float64)
    if len(idx) >= k:
        return np.zeros_like(x)
    return np.where((eff <= 0) & (x > 0), x / k, eff)


@dataclass
class PlaneBook:
    """Fleet-level registry of per-tenant lane decompositions.

    One (k, P_local, P_local) int array per tenant, planes summing to the
    tenant's committed plan.x.  The book is part of the planner snapshot
    and must restore / replay to bit-identical arrays."""

    num_planes: int
    lanes: dict[str, np.ndarray] = field(default_factory=dict)

    def assign(self, name: str, planes: np.ndarray) -> None:
        planes = np.asarray(planes, dtype=np.int64)
        if planes.ndim != 3 or len(planes) != self.num_planes:
            raise ValueError(f"need a ({self.num_planes}, P, P) stack, "
                             f"got shape {planes.shape}")
        self.lanes[name] = planes

    def get(self, name: str) -> np.ndarray | None:
        return self.lanes.get(name)

    def pop(self, name: str) -> None:
        self.lanes.pop(name, None)

    def total(self, name: str) -> np.ndarray | None:
        planes = self.lanes.get(name)
        return None if planes is None else planes.sum(axis=0)

    def snapshot(self) -> dict:
        return {"num_planes": self.num_planes,
                "lanes": {name: planes.tolist()
                          for name, planes in sorted(self.lanes.items())}}

    @classmethod
    def from_snapshot(cls, snap: dict) -> "PlaneBook":
        book = cls(num_planes=int(snap["num_planes"]))
        for name, planes in snap.get("lanes", {}).items():
            book.assign(name, np.asarray(planes, dtype=np.int64))
        return book


@dataclass
class TenantLane:
    """One tenant's A->B lane pair inside a transition.  Bystanders (not
    changing topology) carry planes_a == planes_b: they still suffer each
    intermediate dark plane and count toward the SLO."""

    name: str
    dag: object                  # CommDAG (local pod ids)
    pods: tuple[int, ...]        # fleet pod ids (for link_frac windows)
    planes_a: np.ndarray         # (k, P_local, P_local)
    planes_b: np.ndarray

    def __post_init__(self) -> None:
        self.planes_a = np.asarray(self.planes_a, dtype=np.int64)
        self.planes_b = np.asarray(self.planes_b, dtype=np.int64)
        if self.planes_a.shape != self.planes_b.shape:
            raise ValueError(
                f"{self.name}: lane stacks disagree "
                f"{self.planes_a.shape} vs {self.planes_b.shape}")


@dataclass
class TransitionResult:
    transition: str
    committed: bool
    status: str                       # "committed" | "rolled_back"
    steps: list[PlaneRewireStep]
    summary: PlaneTransitionSummary

    @property
    def peak_inflation(self) -> float:
        return self.summary.peak_inflation

    @property
    def total_delay_s(self) -> float:
        return self.summary.total_delay_s

    def record(self) -> dict:
        """JSON-safe report payload."""
        return {"transition": self.transition, "status": self.status,
                "steps": len(self.steps),
                "peak_inflation": self.summary.peak_inflation,
                "total_delay_s": self.summary.total_delay_s,
                "planes": list(self.summary.planes),
                "tenants": list(self.summary.tenants)}


class StaggeredTransition:
    """One staggered A->B fleet transition (see the module docstring).

    Drive it with `run()` (loops `step()` until committed or rolled
    back), or step manually -- `step()` returns the performed
    `PlaneRewireStep` or None when every remaining candidate breaches
    the SLO (the caller then calls `rollback()`).  `health` is read live
    at each pricing round, so fabric damage landing between steps is
    priced into the remaining schedule automatically.
    """

    def __init__(self, lanes: list[TenantLane], health: FabricHealth, *,
                 slo: float = 3.0, reconfig_s_per_circuit: float = 0.01,
                 transition_id: str = "t0"):
        if not lanes:
            raise ValueError("a transition needs at least one tenant lane")
        ks = {len(t.planes_a) for t in lanes}
        if len(ks) != 1:
            raise ValueError(f"tenants disagree on plane count: {ks}")
        self.num_planes = ks.pop()
        self.lanes = lanes
        self.health = health
        self.slo = float(slo)
        self.reconfig_s_per_circuit = float(reconfig_s_per_circuit)
        self.transition_id = str(transition_id)
        self._problems = {t.name: DESProblem(t.dag) for t in lanes}
        self._deltas = {t.name: plane_circuit_changes(t.planes_b,
                                                      t.planes_a)
                        for t in lanes}
        # planes whose target lanes differ from the incumbent for any
        # tenant; the rest are no-ops and never go dark
        self.pending = [p for p in range(self.num_planes)
                        if any(int(self._deltas[t.name][p]) for t in lanes)]
        self.done: list[int] = []     # rewire order, for rollback
        self.steps: list[PlaneRewireStep] = []
        self._seq = 0

    # ------------------------------------------------------------- pricing
    def mixed_planes(self, lane: TenantLane) -> np.ndarray:
        """The tenant's CURRENT lane stack: rewired planes carry B lanes,
        the rest still carry A."""
        planes = lane.planes_a.copy()
        for p in self.done:
            planes[p] = lane.planes_b[p]
        return planes

    def _link_local(self, lane: TenantLane) -> np.ndarray:
        idx = np.asarray(lane.pods, dtype=np.int64)
        return self.health.link_frac[np.ix_(idx, idx)]

    def _price(self, dark: set[int]) -> dict[str, float]:
        """Certified per-tenant makespans of the current mixed state with
        `dark` planes down (numpy oracle; float effective topology)."""
        out = {}
        for lane in self.lanes:
            eff = effective_topology(self.mixed_planes(lane), dark)
            out[lane.name] = float(simulate(
                self._problems[lane.name],
                eff * self._link_local(lane)).makespan)
        return out

    def _peak_inflation(self, refs: dict[str, float],
                        dark: set[int]) -> float:
        """Worst per-tenant inflation of a candidate state vs the current
        references (both oracle numbers)."""
        peak = 1.0
        for name, ms in self._price(dark).items():
            ref = refs[name]
            if not np.isfinite(ms):
                return INF
            if np.isfinite(ref) and ref > 0:
                peak = max(peak, ms / ref)
        return peak

    def _step_delay(self, plane: int) -> tuple[float, int]:
        changed = sum(int(self._deltas[t.name][plane]) for t in self.lanes)
        return changed * self.reconfig_s_per_circuit, changed

    # ------------------------------------------------------------ stepping
    def step(self) -> PlaneRewireStep | None:
        """Price every pending single-plane rewire against the live
        fabric, perform the cheapest one.  Returns the step record, or
        None when all remaining candidates breach the SLO (caller must
        `rollback()`); raises if nothing is pending."""
        if not self.pending:
            raise RuntimeError("transition already complete")
        fabric_dark = set(self.health.dark_planes)
        refs = self._price(fabric_dark)
        best: tuple[float, int] | None = None
        for q in self.pending:
            peak = self._peak_inflation(refs, fabric_dark | {q})
            if best is None or (peak, q) < best:
                best = (peak, q)
        peak, q = best
        if peak > self.slo:
            return None
        return self._perform(q, peak, "forward")

    def _perform(self, plane: int, peak: float,
                 direction: str) -> PlaneRewireStep:
        delay_s, changed = self._step_delay(plane)
        if direction == "forward":
            self.pending.remove(plane)
            self.done.append(plane)
        else:
            self.done.remove(plane)
            self.pending.append(plane)
            self.pending.sort()
        rec = PlaneRewireStep(
            transition=self.transition_id, plane=int(plane), seq=self._seq,
            direction=direction, peak_inflation=float(peak),
            delay_s=float(delay_s), changed_circuits=int(changed),
            tenants=tuple(t.name for t in self.lanes))
        self._seq += 1
        self.steps.append(rec)
        _STEPS.inc()
        return rec

    def rollback(self) -> list[PlaneRewireStep]:
        """Un-rewire the done planes in reverse order, back to plan A.
        Rollback steps are priced (certified, for the record) but FORCED
        regardless of the SLO: stranding the fleet between plans is worse
        than a breaching step."""
        out = []
        fabric_dark = set(self.health.dark_planes)
        for p in list(reversed(self.done)):
            refs = self._price(fabric_dark)
            peak = self._peak_inflation(refs, fabric_dark | {p})
            out.append(self._perform(p, peak, "rollback"))
        _ROLLBACKS.inc()
        return out

    def run(self) -> TransitionResult:
        with span("planes.transition", id=self.transition_id,
                  tenants=len(self.lanes), planes=self.num_planes):
            while self.pending:
                if self.step() is None:
                    self.rollback()
                    return self._result("rolled_back")
        return self._result("committed")

    def _result(self, status: str) -> TransitionResult:
        peak = max((s.peak_inflation for s in self.steps), default=1.0)
        summary = PlaneTransitionSummary(
            transition=self.transition_id, outcome=status,
            steps=len(self.steps), peak_inflation=float(peak),
            total_delay_s=float(sum(s.delay_s for s in self.steps)),
            tenants=tuple(t.name for t in self.lanes),
            planes=tuple(s.plane for s in self.steps))
        return TransitionResult(
            transition=self.transition_id, committed=(status == "committed"),
            status=status, steps=list(self.steps), summary=summary)
