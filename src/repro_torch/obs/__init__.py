"""repro_torch.obs -- tracing, metrics, schedule timelines, the fleet
journal and logging for the port.

Copies of `repro.obs`'s modules (the port imports nothing of `repro`):

  metrics   counters/gauges with labels, JSON snapshot +
            Prometheus text exposition, planner-scoped deltas
  tracing   nestable spans over the hot seams, Chrome-trace export,
            near-zero cost when disabled (the default)
  timeline  DES schedule -> Perfetto-viewable trace with per-link tracks
            + the critical-path / per-task-slack report
  journal   structured JSONL log of fleet events + decisions, replayable
  logs      one ``repro_torch.``-hierarchy logging setup

    from repro_torch import obs
    obs.TRACER.enable()
    ... run a plan ...
    print(obs.TRACER.summary())            # where did the time go
"""
from repro_torch.obs.journal import (FleetJournal, rebuild_event,
                                     serialize_event)
from repro_torch.obs.logs import get_logger, setup_logging
from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge,
                                     MetricsRegistry, RegistryScope,
                                     get_counter, get_gauge)
from repro_torch.obs.timeline import (plane_rewire_timeline,
                                      schedule_timeline, slack_report,
                                      task_slack, validate_trace,
                                      write_trace)
from repro_torch.obs.tracing import TRACER, SpanRecord, Tracer, enabled, span

__all__ = [
    "Counter", "Gauge", "MetricsRegistry", "RegistryScope",
    "REGISTRY", "get_counter", "get_gauge",
    "Tracer", "TRACER", "SpanRecord", "span", "enabled",
    "plane_rewire_timeline", "schedule_timeline", "slack_report",
    "task_slack", "validate_trace", "write_trace",
    "FleetJournal", "serialize_event", "rebuild_event",
    "get_logger", "setup_logging",
]
