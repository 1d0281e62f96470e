"""repro_torch.obs -- span tracing, metrics and logging for the port.

Copies of `repro.obs`'s tracing, metrics and logs modules (the port
imports nothing of `repro`); the fleet journal and schedule timelines
come with the slices that use them.

    from repro_torch import obs
    obs.TRACER.enable()
    ... run a plan ...
    print(obs.TRACER.summary())            # where did the time go
"""
from repro_torch.obs.logs import get_logger, setup_logging
from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge, Histogram,
                                     MetricsRegistry, RegistryScope,
                                     get_counter, get_gauge, get_histogram)
from repro_torch.obs.tracing import TRACER, SpanRecord, Tracer, enabled, span

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "RegistryScope",
    "REGISTRY", "get_counter", "get_gauge", "get_histogram",
    "Tracer", "TRACER", "SpanRecord", "span", "enabled",
    "get_logger", "setup_logging",
]
