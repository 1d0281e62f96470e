"""Telemetry stream + online estimators for the fleet control plane.

The planner's FastReChain-style break-even (reconfigure only when the
phase dwell amortizes the reconfiguration delay) previously priced every
decision against a hardcoded ``dwell_s = 600.0``.  This module turns that
constant into a *prior* (`DEFAULT_DWELL_S`) behind two measurement-driven
estimators:

  `DwellEstimator`    EWMA over observed phase dwell times, seeded by the
                      prior; ``expected_remaining`` is ``max(ewma,
                      elapsed)`` -- phase dwells are heavy-tailed, so the
                      longer a phase has already run, the longer it is
                      expected to keep running.
  `DriftEstimator`    leaky integrator of the observed per-pair rate
                      matrix (dt-weighted, decay timescale `tau_s`); over
                      a few schedule periods the integral's shape
                      converges to the iteration's *volume* shape, so
                      drift against a planned DAG is the total-variation
                      distance between normalized shapes (0 = traffic
                      matches the plan, 1 = disjoint support).  Window
                      rates alone cannot be compared to the plan: the
                      schedule moves pairs in bursts, so any single
                      window looks nothing like the volume matrix.

`synthesize_telemetry` manufactures the stream the estimators consume --
`TelemetrySample` / `PhaseTransition` events (see `repro_torch.fleet.events`)
derived from the exact DES rate trace of a (dag, topology) pair -- which
is both the test harness and the METTEOR-style trace-replay path: a
recorded journal of these events re-drives a controller bit-identically
(`repro_torch.fleet.control.ControlPlane.replay`).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.dag import CommDAG
from repro_torch.core.des import DESProblem, DESResult, simulate
from repro_torch.fleet.events import PhaseTransition, TelemetrySample

__all__ = ["DEFAULT_DWELL_S", "DwellEstimator", "DriftEstimator",
           "traffic_drift", "synthesize_telemetry"]

INF = float("inf")

# The single source of the phase-dwell prior: how long a tenant is assumed
# to keep its current traffic pattern when no dwell has been measured yet.
# `AdmissionController.repair`/`change` and `FleetPlanner` default to it;
# the control plane replaces it with the per-tenant EWMA estimate.
DEFAULT_DWELL_S = 600.0


# -------------------------------------------------------------- estimators
@dataclass
class DwellEstimator:
    """EWMA of observed phase dwell times for one tenant.

    `observe_transition(t, phase)` closes the currently-open phase (if the
    label changed) and folds its dwell into the EWMA; before any closed
    dwell the estimate is the prior.  The first observation replaces the
    prior outright (the prior carries no evidence worth averaging in).
    """

    prior_s: float = DEFAULT_DWELL_S
    alpha: float = 0.3
    _ewma: float | None = field(default=None, repr=False)
    _count: int = field(default=0, repr=False)
    _phase: str | None = field(default=None, repr=False)
    _since: float | None = field(default=None, repr=False)

    @property
    def phase(self) -> str | None:
        """The currently-open phase label (None before any transition)."""
        return self._phase

    @property
    def count(self) -> int:
        """Closed dwells folded into the EWMA so far."""
        return self._count

    def observe_transition(self, t: float, phase: str) -> float | None:
        """Record a phase marker; returns the dwell it closed (or None)."""
        t = float(t)
        closed = None
        if self._phase is not None and phase != self._phase:
            closed = max(t - float(self._since), 0.0)
            self._ewma = closed if self._ewma is None else \
                (1.0 - self.alpha) * self._ewma + self.alpha * closed
            self._count += 1
        if self._phase != phase:
            self._phase = phase
            self._since = t
        return closed

    def estimate(self) -> float:
        return self.prior_s if self._ewma is None else self._ewma

    def elapsed(self, now: float) -> float:
        if self._since is None:
            return 0.0
        return max(float(now) - self._since, 0.0)

    def expected_remaining(self, now: float) -> float:
        """Expected remaining dwell of the open phase at time `now`."""
        return max(self.estimate(), self.elapsed(now))


def traffic_drift(observed: np.ndarray, expected: np.ndarray) -> float:
    """Total-variation distance between two traffic shapes in [0, 1].

    Both matrices are normalized to unit mass first, so only the *shape*
    of the traffic matters, not its magnitude (observed rates are bytes/s,
    planned volumes are bytes).  Zero-mass inputs carry no signal and
    report zero drift.
    """
    a = np.asarray(observed, dtype=np.float64)
    b = np.asarray(expected, dtype=np.float64)
    sa, sb = float(a.sum()), float(b.sum())
    if sa <= 0.0 or sb <= 0.0:
        return 0.0
    return 0.5 * float(np.abs(a / sa - b / sb).sum())


@dataclass
class DriftEstimator:
    """Leaky time-integral of one tenant's observed rate matrix.

    `observe(rates, dt)` folds one telemetry window in as `rates * dt`
    after decaying the running integral by `exp(-dt / tau_s)`.  With
    `tau_s` spanning a few schedule periods the integral's *shape*
    converges to the per-iteration volume shape (what
    `CommDAG.traffic_matrix` predicts), so within-phase drift sits near
    zero even under heavy rate noise, while a real phase change pulls it
    toward the TV distance between the phases' volume shapes within a
    couple of `tau_s`.  That gap is the signal the controller's
    confirm-ticks hysteresis builds on.
    """

    tau_s: float = 5.0
    _acc: np.ndarray | None = field(default=None, repr=False)

    def observe(self, rates, dt: float = 1.0) -> np.ndarray:
        r = np.asarray(rates, dtype=np.float64) * float(dt)
        self._acc = r.copy() if self._acc is None else \
            self._acc * float(np.exp(-float(dt) / self.tau_s)) + r
        return self._acc

    def drift(self, expected: np.ndarray) -> float:
        """TV drift of the integrated observation vs a planned shape."""
        if self._acc is None:
            return 0.0
        return traffic_drift(self._acc, expected)


# ------------------------------------------------------- stream synthesis
def _freeze(mat: np.ndarray) -> tuple[tuple[float, ...], ...]:
    return tuple(tuple(float(v) for v in row) for row in np.asarray(mat))


def synthesize_telemetry(dag: CommDAG, x: np.ndarray, *, tenant: str,
                         phase: str | None = None, t0: float = 0.0,
                         iterations: int = 1,
                         result: DESResult | None = None,
                         mask: np.ndarray | None = None,
                         noise: float = 0.0,
                         rng: np.random.Generator | None = None) -> list:
    """Manufacture the telemetry a tenant running `dag` on topology `x`
    would emit: one `PhaseTransition` marker at `t0` (when `phase` is
    given) followed by one `TelemetrySample` per DES rate interval, tiled
    over `iterations` training iterations.

    Rates come from the exact fair-share DES rate trace (optionally under
    a fabric `mask`); queue depths are the per-pair bytes still unmoved at
    each window start.  `noise` adds multiplicative Gaussian jitter to the
    *reported* rates (the ground-truth transfer accounting stays exact),
    which is how the hysteresis tests stress the drift estimator.
    """
    from repro_torch.obs.timeline import interval_rate_matrices
    problem = DESProblem(dag)
    if result is None:
        xe = np.asarray(x, dtype=np.float64)
        result = simulate(problem, xe * mask if mask is not None else xe,
                          record_rates=True)
    if not result.feasible or not np.isfinite(result.makespan):
        raise ValueError("cannot synthesize telemetry from an infeasible "
                         "schedule")
    if not result.rate_trace:
        raise ValueError("synthesize_telemetry needs a rate trace; "
                         "simulate with record_rates=True")
    mats = interval_rate_matrices(problem, result)
    vol = dag.traffic_matrix()
    if noise > 0.0 and rng is None:
        rng = np.random.default_rng(0)

    events: list = []
    if phase is not None:
        events.append(PhaseTransition(t=float(t0), tenant=tenant,
                                      phase=phase))
    period = float(result.makespan)
    for it in range(int(iterations)):
        base = float(t0) + it * period
        moved = np.zeros_like(vol)
        for s0, s1, mat in mats:
            dt = s1 - s0
            if dt <= 0.0:
                continue
            queues = np.maximum(vol - moved, 0.0)
            reported = mat
            if noise > 0.0:
                jitter = 1.0 + noise * rng.standard_normal(mat.shape)
                reported = np.maximum(mat * jitter, 0.0)
            events.append(TelemetrySample(
                t=base + s0, tenant=tenant, dt=float(dt),
                rates=_freeze(reported), queues=_freeze(queues),
                phase=phase))
            moved += mat * dt
    return events
