"""Telemetry-driven fleet control plane: monitor -> decide -> apply.

`ControlPlane` wraps a `FleetPlanner` and closes the ROADMAP's feedback
loop.  It ingests the per-tenant telemetry stream (`TelemetrySample` rate
windows + `PhaseTransition` markers, see `repro_torch.fleet.telemetry`),
maintains online estimators -- EWMA phase dwell and traffic-matrix drift
against each tenant's *planned* DAG -- and, at a fixed steering cadence,
drives the planner's priced replan machinery from those estimates:

  monitor   `observe()` journals every telemetry event (the session is
            bit-identically replayable) and updates the estimators +
            `control_*` gauges;
  decide    `step()` fires at the cadence; a tenant whose reported phase
            differs from its planned one must hold drift above the
            threshold for `confirm_ticks` consecutive ticks (and be out
            of `cooldown_s`) before any action -- the hysteresis that
            keeps short flaps and noisy rates from triggering rewires;
  apply     a confirmed change is issued as `TrafficChange(steered=True)`
            through `FleetPlanner.handle`, where the admission layer
            prices keep-vs-replan with the FastReChain break-even:
            replan only if  estimated_dwell x inflation > reconfig delay,
            using this controller's `expected_remaining` dwell estimate
            instead of the `DEFAULT_DWELL_S` prior.

Because every input is journaled and every decision is a deterministic
function of the journaled inputs (seeded GA, exact DES pricing),
`ControlPlane.replay` re-drives a recorded session on a fresh planner to
identical decisions -- steered events in the journal are *skipped* on
replay and regenerated by the replaying controller itself.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.fleet.events import (PhaseTransition, TelemetrySample,
                                       TrafficChange, rebuild_event,
                                       serialize_event)
from repro_torch.fleet.loop import FleetPlanner
from repro_torch.fleet.telemetry import (DEFAULT_DWELL_S, DriftEstimator,
                                         DwellEstimator)
from repro_torch.obs import FleetJournal, get_counter, get_gauge, span

__all__ = ["ControllerConfig", "ControlPlane"]

INF = float("inf")

_SAMPLES = get_counter("control_samples_total",
                       "telemetry events ingested, by kind")
_STEER_ACTIONS = get_counter("control_steer_total",
                             "steering decisions issued, by action")
_DWELL_G = get_gauge("control_dwell_estimate_seconds",
                     "estimated remaining phase dwell per tenant")
_DRIFT_G = get_gauge("control_traffic_drift",
                     "TV drift of observed rates vs the planned DAG")
_QUEUE_G = get_gauge("control_queue_backlog_gb",
                     "total queued volume reported per tenant")


@dataclass
class ControllerConfig:
    """Steering knobs (see README "Control plane" for the tuning story).

    cadence_s       decision clock: `step()` runs when the telemetry clock
                    has advanced this far since the last tick
    drift_threshold minimum TV drift (0..1) counted as evidence of a real
                    phase change; within-phase drift of the integrated
                    rates sits near zero, a real phase shift pulls it
                    toward the phases' volume-shape TV distance
    confirm_ticks   consecutive over-threshold ticks required before a
                    steered change is issued (flap suppression: markers
                    that revert within confirm_ticks x cadence_s never
                    reach the planner)
    cooldown_s      minimum time between steered changes per tenant
    dwell_prior_s   dwell prior handed to fresh estimators
    dwell_alpha     EWMA smoothing factor for the dwell estimator
    drift_tau_s     decay timescale of the rate integrator (a few
                    schedule periods; also bounds detection latency)
    """

    cadence_s: float = 30.0
    drift_threshold: float = 0.05
    confirm_ticks: int = 2
    cooldown_s: float = 120.0
    dwell_prior_s: float = DEFAULT_DWELL_S
    dwell_alpha: float = 0.3
    drift_tau_s: float = 5.0


class ControlPlane:
    """Long-running steering service over one `FleetPlanner`.

    `phase_book` maps tenant -> {phase label -> JobSpec}: the workloads
    the controller may steer a tenant to when its telemetry reports that
    phase.  A tenant's first observed phase is taken as its planned one
    (drive sessions start with the `PhaseTransition` marker
    `synthesize_telemetry` emits), so replaying the journaled stream
    reconstructs the planned-phase state exactly.
    """

    def __init__(self, planner: FleetPlanner,
                 config: ControllerConfig | None = None,
                 phase_book: dict[str, dict] | None = None):
        self.planner = planner
        self.config = config if config is not None else ControllerConfig()
        self.phase_book: dict[str, dict] = {
            t: dict(jobs) for t, jobs in (phase_book or {}).items()}
        self.dwell: dict[str, DwellEstimator] = {}
        self.drift: dict[str, DriftEstimator] = {}
        self.decisions: list[dict] = []
        self.clock: float = 0.0
        self._planned_phase: dict[str, str] = {}
        self._pending: dict[str, str] = {}    # tenant -> off-plan phase
        self._confirm: dict[str, int] = {}
        self._last_change: dict[str, float] = {}
        self._last_tick: float | None = None

    # ------------------------------------------------------------- wiring
    def register_phase(self, tenant: str, phase: str, job) -> None:
        """Teach the controller which JobSpec a phase label maps to."""
        self.phase_book.setdefault(tenant, {})[phase] = job

    def _dwell(self, tenant: str) -> DwellEstimator:
        if tenant not in self.dwell:
            self.dwell[tenant] = DwellEstimator(
                prior_s=self.config.dwell_prior_s,
                alpha=self.config.dwell_alpha)
        return self.dwell[tenant]

    def _drift(self, tenant: str) -> DriftEstimator:
        if tenant not in self.drift:
            self.drift[tenant] = DriftEstimator(
                tau_s=self.config.drift_tau_s)
        return self.drift[tenant]

    # ------------------------------------------------------------ monitor
    def observe(self, event) -> list[dict]:
        """Ingest one telemetry event; returns steering decisions (if the
        cadence fired).  Every event is journaled before it can influence
        a decision, so the journal is a complete replay transcript."""
        name = event.tenant
        self.planner.journal.record("telemetry",
                                    event=serialize_event(event))
        if isinstance(event, PhaseTransition):
            _SAMPLES.inc(kind="phase_transition")
            self.clock = max(self.clock, float(event.t))
            est = self._dwell(name)
            est.observe_transition(event.t, event.phase)
            if name not in self._planned_phase:
                # first report defines the planned phase (admission built
                # the tenant's DAG from exactly this workload)
                self._planned_phase[name] = event.phase
            if event.phase != self._planned_phase.get(name):
                if self._pending.get(name) != event.phase:
                    self._pending[name] = event.phase
                    self._confirm[name] = 0
            else:
                self._pending.pop(name, None)
                self._confirm.pop(name, None)
            self._push_dwell(name)
        elif isinstance(event, TelemetrySample):
            _SAMPLES.inc(kind="sample")
            self.clock = max(self.clock, float(event.t) + float(event.dt))
            self._drift(name).observe(event.rates, event.dt)
            if event.queues:
                _QUEUE_G.set(float(sum(sum(row) for row in event.queues)),
                             tenant=name)
            tenant = self.planner.tenants.get(name)
            if tenant is not None:
                _DRIFT_G.set(self._drift(name).drift(
                    tenant.dag.traffic_matrix()), tenant=name)
            self._push_dwell(name)
        else:
            raise TypeError(f"not a telemetry event: {event!r}")

        if self._last_tick is None:
            self._last_tick = self.clock
            return []
        if self.clock - self._last_tick >= self.config.cadence_s:
            self._last_tick = self.clock
            return self.step(self.clock)
        return []

    def _push_dwell(self, name: str) -> None:
        """Keep the planner's per-tenant dwell estimate current, so *any*
        priced decision (steered change, fault repair, surplus realloc)
        uses the measured dwell instead of the prior."""
        est = self._dwell(name)
        remaining = est.expected_remaining(self.clock)
        self.planner.set_dwell_estimate(name, remaining)
        _DWELL_G.set(remaining, tenant=name)

    # ------------------------------------------------------------- decide
    def step(self, now: float) -> list[dict]:
        """One steering tick: evaluate every tenant reporting an off-plan
        phase; issue a priced `TrafficChange(steered=True)` for those that
        clear the hysteresis gates.  Every evaluation is journaled."""
        cfg = self.config
        out: list[dict] = []
        for name in sorted(self._pending):
            tenant = self.planner.tenants.get(name)
            if tenant is None:
                self._pending.pop(name, None)
                self._confirm.pop(name, None)
                continue
            target = self._pending[name]
            est = self._dwell(name)
            drift = self._drift(name).drift(tenant.dag.traffic_matrix())
            self._confirm[name] = self._confirm.get(name, 0) + 1 \
                if drift >= cfg.drift_threshold else 0
            in_cooldown = (now - self._last_change.get(name, -INF)
                           < cfg.cooldown_s)
            rec = {"t": float(now), "tenant": name,
                   "target_phase": target, "drift": float(drift),
                   "confirm": self._confirm[name],
                   "dwell_estimate_s": est.expected_remaining(now),
                   "action": "wait"}
            if in_cooldown:
                rec["action"] = "cooldown"
            elif self._confirm[name] >= cfg.confirm_ticks:
                job = self.phase_book.get(name, {}).get(target)
                if job is None:
                    rec["action"] = "unknown_phase"
                else:
                    rec.update(self._apply(name, target, job, now))
            self.decisions.append(rec)
            self.planner.journal.record("steer", **rec)
            _STEER_ACTIONS.inc(action=rec["action"])
            out.append(rec)
        return out

    # -------------------------------------------------------------- apply
    def _apply(self, name: str, target: str, job, now: float) -> dict:
        """Issue the steered change; admission prices keep-vs-replan with
        this tenant's estimated remaining dwell (already pushed to the
        planner by `_push_dwell`)."""
        with span("control.apply", tenant=name, phase=target):
            record = self.planner.handle(
                TrafficChange(name=name, job=job, steered=True))
        self._planned_phase[name] = target
        self._pending.pop(name, None)
        self._confirm.pop(name, None)
        self._last_change[name] = float(now)
        decision = record.get("decision", {})
        return {"action": decision.get("option", "replan"),
                "decision": decision}

    # ------------------------------------------------------------- replay
    @classmethod
    def replay(cls, entries, planner: FleetPlanner, *,
               config: ControllerConfig | None = None,
               phase_book: dict[str, dict] | None = None) -> "ControlPlane":
        """Re-drive a recorded session (journal entries or a JSONL path)
        on a fresh planner.  External fleet events replay through
        `planner.handle`; telemetry replays through `observe`, which
        regenerates the steered changes -- journaled steered events are
        skipped so they are not applied twice.  ``plane_event`` records
        (staggered-rewire steps + summaries, EVENTS_VERSION 3) are
        decision *outputs* and are likewise skipped: the replaying
        planner re-drives its deterministic scheduler and regenerates
        bit-identical plane states and step records.  With the same
        config, phase book and planner construction, the rebuilt
        controller's `decisions` match the recorded session exactly."""
        import os
        if isinstance(entries, (str, os.PathLike)):
            entries = FleetJournal.load(entries)
        cp = cls(planner, config=config, phase_book=phase_book)
        for e in entries:
            kind = e.get("kind")
            if kind == "fleet_event":
                ev = rebuild_event(e["event"])
                if getattr(ev, "steered", False):
                    continue        # the replaying controller re-issues it
                planner.handle(ev)
            elif kind == "telemetry":
                cp.observe(rebuild_event(e["event"]))
        return cp

    # ------------------------------------------------------------- report
    def report(self) -> dict:
        """Controller state summary: per-tenant estimator readouts plus
        the decision mix (the `control_*` metrics, snapshotted)."""
        tenants = {}
        for name, est in self.dwell.items():
            drift = self.drift.get(name)
            tenant = self.planner.tenants.get(name)
            tenants[name] = {
                "phase": est.phase,
                "planned_phase": self._planned_phase.get(name),
                "dwell_estimate_s": est.expected_remaining(self.clock),
                "closed_dwells": est.count,
                "drift": drift.drift(tenant.dag.traffic_matrix())
                if drift is not None and tenant is not None else 0.0,
                "pending": self._pending.get(name),
            }
        actions: dict[str, int] = {}
        for rec in self.decisions:
            actions[rec["action"]] = actions.get(rec["action"], 0) + 1
        return {"clock": self.clock, "tenants": tenants,
                "decisions": len(self.decisions), "actions": actions}
