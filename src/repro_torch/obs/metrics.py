"""Lightweight metrics registry: counters and gauges with labels.

The fleet control plane (monitor -> decide -> apply) needs exported,
*scopable* measurements instead of ad-hoc process-wide dicts: two
`FleetPlanner`s in one process must not pollute each other's compile-cache
hit rate, and an external scraper must be able to read the same numbers the
planner's own `report()` uses.  This module provides exactly that substrate:

  * `MetricsRegistry` holds named metrics; every metric supports key=value
    labels (one time series per label combination, Prometheus-style);
  * `snapshot()` returns a plain-dict JSON view; `render_prometheus()` the
    text exposition format (``# HELP`` / ``# TYPE`` + one line per series);
  * `RegistryScope` (from `registry.scope()`) captures current counter
    values so callers can read *deltas* -- the planner-local view of shared
    process counters;
  * a disabled registry (``enabled=False`` or ``$REPRO_METRICS=0``) makes
    every mutation a single attribute check and an early return, so
    instrumented hot paths stay effectively free.

One process-wide default registry (`REGISTRY`) is shared by the DES compile
cache, the GA, the MILP phases and the fleet loop; tests and multi-tenant
embeddings can construct private registries.
"""
from __future__ import annotations

import json
import os
import threading

__all__ = ["Counter", "Gauge", "MetricsRegistry", "RegistryScope",
           "REGISTRY", "get_counter", "get_gauge"]

_LabelKey = tuple[tuple[str, str], ...]


def _label_key(labels: dict[str, object]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render_labels(key: _LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class _Metric:
    """Common storage: one value slot per label combination."""

    kind = "untyped"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry"):
        self.name = name
        self.help = help
        self._registry = registry
        self._series: dict[_LabelKey, float] = {}

    # the lock lives on the registry so snapshot() sees a consistent view
    @property
    def _lock(self) -> threading.Lock:
        return self._registry._lock

    @property
    def enabled(self) -> bool:
        return self._registry.enabled

    def value(self, **labels) -> float:
        return self._series.get(_label_key(labels), 0.0)

    def series(self) -> dict[_LabelKey, float]:
        with self._lock:
            return dict(self._series)

    def reset(self) -> None:
        with self._lock:
            self._series.clear()

    def _lines(self) -> list[str]:
        with self._lock:
            items = sorted(self._series.items())
        return [f"{self.name}{_render_labels(key)} {_format(v)}"
                for key, v in items]


def _format(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


class Counter(_Metric):
    """Monotonically increasing count (resets only via `reset()`)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not self.enabled:
            return
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount


class Gauge(_Metric):
    """Point-in-time value (pool sizes, cache entries, tenant counts)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not self.enabled:
            return
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


class MetricsRegistry:
    """Named metrics + consistent snapshot / exposition / scoping."""

    def __init__(self, enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("REPRO_METRICS", "1") != "0"
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    # ------------------------------------------------------------- factories
    def _get(self, cls, name: str, help: str) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, self)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    # ---------------------------------------------------------------- export
    def snapshot(self) -> dict:
        """JSON-friendly view: {metric: {kind, help, series: {labels: v}}}.

        Label keys render as ``k=v,k2=v2`` strings ('' for the bare
        series) so the snapshot survives `json.dumps` untouched.
        """
        out: dict[str, dict] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            series = {",".join(f"{k}={v}" for k, v in key) or "": val
                      for key, val in m.series().items()}
            out[m.name] = {"kind": m.kind, "help": m.help, "series": series}
        return out

    def to_json(self, **dump_kw) -> str:
        return json.dumps(self.snapshot(), **dump_kw)

    def render_prometheus(self) -> str:
        """Text exposition format (``text/plain; version=0.0.4``)."""
        lines: list[str] = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m._lines())
        return "\n".join(lines) + ("\n" if lines else "")

    # --------------------------------------------------------------- scoping
    def scope(self) -> "RegistryScope":
        """Capture current values; `delta()` then reads *scoped* counters.

        This is how a `FleetPlanner` reports its own share of process-wide
        counters (e.g. DES compile-cache hits) without a second planner in
        the same process polluting the numbers.
        """
        return RegistryScope(self)

    def reset(self) -> None:
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()


class RegistryScope:
    """Value snapshot of a registry; `delta()` returns per-metric change.

    Only scalar series are diffed (counter and gauge values); new label
    combinations appearing after the snapshot count from zero.
    """

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        with registry._lock:
            metrics = list(registry._metrics.items())
        self._base: dict[str, dict[_LabelKey, float]] = {
            name: m.series() for name, m in metrics}

    def delta(self, name: str, **labels) -> float:
        """Change of one series since the scope was captured."""
        m = self.registry._metrics.get(name)
        if m is None:
            return 0.0
        base = self._base.get(name, {}).get(_label_key(labels), 0.0)
        return m.value(**labels) - base

    def deltas(self, name: str) -> dict[str, float]:
        """All of a metric's series deltas, label-rendered keys."""
        m = self.registry._metrics.get(name)
        if m is None:
            return {}
        base = self._base.get(name, {})
        out = {}
        for key, val in m.series().items():
            d = val - base.get(key, 0.0)
            out[",".join(f"{k}={v}" for k, v in key) or ""] = d
        return out


REGISTRY = MetricsRegistry()


def get_counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def get_gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)

