"""Versioned fleet event schema: every event the planner or the control
plane consumes, with ONE serialize/rebuild path.

Before this module, `repro_torch.obs.journal` hand-maintained a per-kind
serializer for every event class living in `repro_torch.fleet.loop` -- adding an
event meant editing two files and keeping their shapes in sync by hand.
Now the schema lives here: frozen dataclasses registered under a stable
``kind`` string, serialized generically from their fields (tuples <->
lists, JobSpec <-> its field dict, numpy scalars unboxed) and rebuilt by
the field annotations.  `obs.journal` just delegates.

Schema versioning: `serialize_event` stamps ``"v": EVENTS_VERSION`` on
every entry.  Version history:

  1  PR-7 journal shapes (arrival/departure/traffic_change + fault events)
  2  adds the control-plane telemetry events (`TelemetrySample`,
     `PhaseTransition`) and the ``steered`` flag on `TrafficChange`
  3  adds the staggered-reconfiguration plane events (`PlaneRewireStep`,
     `PlaneTransitionSummary`) -- decision *outputs* journaled under the
     ``plane_event`` record kind, not replayable inputs, so
     `ControlPlane.replay` skips them and regenerates identical steps by
     re-driving the deterministic scheduler

Rebuild is backward compatible: missing fields take their dataclass
defaults, so v1/v2 journals replay unchanged.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.core.traffic import JobSpec

__all__ = [
    "EVENTS_VERSION", "EVENT_KINDS", "FAULT_EVENTS", "PLANE_EVENTS",
    "TELEMETRY_EVENTS", "FleetEvent", "JobArrival", "JobDeparture",
    "TrafficChange", "LinkFailure", "LinkRecovery", "PortFailure",
    "PortRecovery", "PlaneFailure", "PlaneRecovery", "PlaneRewireStep",
    "PlaneTransitionSummary", "TelemetrySample", "PhaseTransition",
    "serialize_event", "rebuild_event", "event_kind",
]

EVENTS_VERSION = 3


# ------------------------------------------------------------ fleet events
@dataclass(frozen=True)
class JobArrival:
    name: str
    job: JobSpec
    reverse_stages: bool = False
    port_min: bool = False
    donate_surplus: bool | None = None   # default: == port_min
    base_pod: int | None = None


@dataclass(frozen=True)
class JobDeparture:
    name: str


@dataclass(frozen=True)
class TrafficChange:
    """Replace a tenant's JobSpec in place (same placement footprint).

    ``steered=True`` marks a change issued by the control plane: the
    planner prices keep-vs-replan against the tenant's estimated dwell
    (FastReChain break-even) instead of replanning unconditionally, and
    journal replay skips the entry (the replaying controller re-issues it
    from the telemetry stream)."""
    name: str
    job: JobSpec
    steered: bool = False


@dataclass(frozen=True)
class LinkFailure:
    """A pod pair loses `fraction` of its circuit capacity (OCS plane
    segment or fiber bundle serving that pair)."""
    pair: tuple[int, int]
    fraction: float = 1.0


@dataclass(frozen=True)
class LinkRecovery:
    pair: tuple[int, int]


@dataclass(frozen=True)
class PortFailure:
    """`count` physical OCS ports on `pod` go dark (ledger-visible)."""
    pod: int
    count: int = 1


@dataclass(frozen=True)
class PortRecovery:
    pod: int
    count: int = 1


@dataclass(frozen=True)
class PlaneFailure:
    """A whole OCS plane goes dark: a uniform 1/num_planes capacity
    haircut on every pod pair (also what staggered reconfiguration of a
    parallel-plane fabric looks like)."""
    plane: int


@dataclass(frozen=True)
class PlaneRecovery:
    plane: int


# ------------------------------------------------ staggered-rewire events
@dataclass(frozen=True)
class PlaneRewireStep:
    """One single-plane rewire inside a staggered A->B transition.

    The plane is dark for `delay_s` while its circuits move; the recorded
    `peak_inflation` is the CERTIFIED (numpy-oracle) worst per-tenant
    makespan inflation of the intermediate fabric state, the exact number
    the SLO was checked against.  `direction` is ``forward`` for the
    planned order and ``rollback`` when the scheduler is un-rewiring an
    already-done plane to return to plan A."""
    transition: str                     # transition id (journal-scoped)
    plane: int
    seq: int                            # step index within the transition
    direction: str = "forward"
    peak_inflation: float = 1.0
    delay_s: float = 0.0
    changed_circuits: int = 0
    tenants: tuple[str, ...] = ()


@dataclass(frozen=True)
class PlaneTransitionSummary:
    """Terminal record of one staggered transition: either every plane
    was rewired to plan B (`outcome='committed'`) or the scheduler rolled
    back to plan A (`outcome='rolled_back'`); the fleet is never left
    between plans."""
    transition: str
    outcome: str
    steps: int = 0
    peak_inflation: float = 1.0
    total_delay_s: float = 0.0
    tenants: tuple[str, ...] = ()
    planes: tuple[int, ...] = ()


# -------------------------------------------------------- telemetry events
@dataclass(frozen=True)
class TelemetrySample:
    """One measurement window from a tenant's fabric: the observed per-pod-
    pair rate matrix (bytes/s, local pod ids) over [t, t + dt), plus the
    per-pair queue depth (bytes still to move) at the window start."""
    t: float
    tenant: str
    dt: float
    rates: tuple[tuple[float, ...], ...]
    queues: tuple[tuple[float, ...], ...] = ()
    phase: str | None = None


@dataclass(frozen=True)
class PhaseTransition:
    """A workload self-reports entering a named phase at time `t` (the
    marker the dwell estimator closes its previous phase against)."""
    t: float
    tenant: str
    phase: str


FleetEvent = (JobArrival | JobDeparture | TrafficChange | LinkFailure
              | LinkRecovery | PortFailure | PortRecovery | PlaneFailure
              | PlaneRecovery)

FAULT_EVENTS = (LinkFailure, LinkRecovery, PortFailure, PortRecovery,
                PlaneFailure, PlaneRecovery)

PLANE_EVENTS = (PlaneRewireStep, PlaneTransitionSummary)

TELEMETRY_EVENTS = (TelemetrySample, PhaseTransition)

EVENT_KINDS: dict[str, type] = {
    "arrival": JobArrival,
    "departure": JobDeparture,
    "traffic_change": TrafficChange,
    "link_failure": LinkFailure,
    "link_recovery": LinkRecovery,
    "port_failure": PortFailure,
    "port_recovery": PortRecovery,
    "plane_failure": PlaneFailure,
    "plane_recovery": PlaneRecovery,
    "plane_rewire": PlaneRewireStep,
    "plane_transition": PlaneTransitionSummary,
    "telemetry": TelemetrySample,
    "phase_transition": PhaseTransition,
}

_KIND_OF = {cls: kind for kind, cls in EVENT_KINDS.items()}


def event_kind(event) -> str:
    """The stable journal ``kind`` string for a live event."""
    try:
        return _KIND_OF[type(event)]
    except KeyError:
        raise TypeError(f"unknown fleet event {event!r}") from None


# ------------------------------------------------------------ single serde
def _encode(value):
    if isinstance(value, JobSpec):
        return dataclasses.asdict(value)
    if isinstance(value, (tuple, list)):
        return [_encode(v) for v in value]
    # numpy scalars sneak in via event constructors fed from arrays
    if hasattr(value, "item") and not isinstance(value, (str, bytes)):
        return value.item()
    return value


def serialize_event(event) -> dict:
    """FleetEvent / telemetry event -> JSON-safe dict (kind + fields)."""
    kind = event_kind(event)
    out: dict = {"kind": kind, "v": EVENTS_VERSION}
    for f in dataclasses.fields(event):
        out[f.name] = _encode(getattr(event, f.name))
    return out


def _jobspec_from_dict(data: dict) -> JobSpec:
    kw = dict(data)
    for f in dataclasses.fields(JobSpec):
        # JSON round-trips tuples as lists; restore tuple-typed fields
        if f.name in kw and isinstance(kw[f.name], list):
            kw[f.name] = tuple(kw[f.name])
    return JobSpec(**kw)


def _deep_tuple(value):
    if isinstance(value, (list, tuple)):
        return tuple(_deep_tuple(v) for v in value)
    return value


def _decode(annotation: str, value):
    """Coerce a JSON value back to its dataclass field type.  Annotations
    are strings (PEP 563 is active in this module); optional fields keep
    None as-is."""
    if value is None:
        return None
    ann = annotation.replace(" ", "")
    if ann == "JobSpec":
        return _jobspec_from_dict(value)
    if ann.startswith("tuple"):
        return _deep_tuple(value)
    if ann.startswith("bool"):
        return bool(value)
    if ann.startswith("int"):
        return int(value)
    if ann.startswith("float"):
        return float(value)
    if ann.startswith("str"):
        return str(value)
    return value


def rebuild_event(data: dict):
    """Inverse of `serialize_event`.  Fields absent from the entry (older
    schema versions) take their dataclass defaults."""
    kind = data.get("kind")
    cls = EVENT_KINDS.get(kind)
    if cls is None:
        raise ValueError(f"unknown journal event kind {kind!r}")
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            kw[f.name] = _decode(str(f.type), data[f.name])
    return cls(**kw)
