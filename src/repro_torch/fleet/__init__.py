"""Multi-tenant fleet planner: port ledger, admission, surplus reallocation,
the event-driven replanning loop (paper Sec. VI as a long-lived service)
and the telemetry-driven control plane that steers it.  Entry point:
`repro_torch.core.api.plan` (kind="fleet") or `FleetPlanner` + `ControlPlane`.
"""
from repro_torch.fleet.admission import (AdmissionController, AdmissionError,
                                         FleetSpec, Tenant, shrink_to_limits)
from repro_torch.fleet.control import ControllerConfig, ControlPlane
from repro_torch.fleet.events import (EVENT_KINDS, EVENTS_VERSION,
                                      FAULT_EVENTS, PLANE_EVENTS,
                                      TELEMETRY_EVENTS, JobArrival,
                                      JobDeparture, LinkFailure, LinkRecovery,
                                      PhaseTransition, PlaneFailure,
                                      PlaneRecovery, PlaneRewireStep,
                                      PlaneTransitionSummary, PortFailure,
                                      PortRecovery, TelemetrySample,
                                      TrafficChange, event_kind, rebuild_event,
                                      serialize_event)
from repro_torch.fleet.faults import (FabricHealth, FaultInjector,
                                      step_failure_trace)
from repro_torch.fleet.ledger import LedgerError, PortLedger, TenantAccount
from repro_torch.fleet.loop import FleetPlanner, arrivals, fault_events_from_trace
from repro_torch.fleet.plancache import CachedPlan, PlanCache, dag_signature
from repro_torch.fleet.planes import (PlaneBook, StaggeredTransition,
                                      TenantLane, TransitionResult,
                                      effective_topology, split_plan)
from repro_torch.fleet.realloc import (ReallocResult, candidate_boosts,
                                       circuit_changes, port_demand,
                                       reallocate, waterfill_grants)
from repro_torch.fleet.telemetry import (DEFAULT_DWELL_S, DriftEstimator,
                                         DwellEstimator, synthesize_telemetry,
                                         traffic_drift)

__all__ = [
    "AdmissionController", "AdmissionError", "FleetSpec", "Tenant",
    "shrink_to_limits", "ControllerConfig", "ControlPlane",
    "EVENT_KINDS", "EVENTS_VERSION", "FAULT_EVENTS", "PLANE_EVENTS",
    "TELEMETRY_EVENTS", "JobArrival", "JobDeparture", "LinkFailure",
    "LinkRecovery", "PhaseTransition", "PlaneFailure", "PlaneRecovery",
    "PlaneRewireStep", "PlaneTransitionSummary", "PortFailure",
    "PortRecovery", "TelemetrySample", "TrafficChange", "event_kind",
    "rebuild_event", "serialize_event", "FabricHealth", "FaultInjector",
    "step_failure_trace", "LedgerError", "PortLedger", "TenantAccount",
    "FleetPlanner", "arrivals", "fault_events_from_trace", "CachedPlan",
    "PlanCache", "dag_signature", "PlaneBook", "StaggeredTransition",
    "TenantLane", "TransitionResult", "effective_topology", "split_plan",
    "ReallocResult", "candidate_boosts",
    "circuit_changes", "port_demand", "reallocate", "waterfill_grants",
    "DEFAULT_DWELL_S", "DriftEstimator", "DwellEstimator",
    "synthesize_telemetry", "traffic_drift",
]
