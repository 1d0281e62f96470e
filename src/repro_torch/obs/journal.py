"""Structured, replayable event journal for the fleet control plane.

Every `FleetPlanner.handle()` call appends one entry: the incoming event
(serialized well enough to reconstruct it), the decision record the planner
produced, and a monotonically increasing sequence number.  The journal is

  * **structured**: entries are plain dicts, JSONL on disk (one entry per
    line, append-only -- the persisted-plan-state shape an online planner
    restarts from);
  * **replayable**: `load()` reads entries back and `rebuild_events()`
    turns them into live `FleetEvent` objects (JobSpec round-trips through
    its dataclass fields), so a journal can re-drive a fresh planner;
  * cheap: in-memory by default, file-backed when given a path.

This is deliberately NOT a metrics stream (see `repro_torch.obs.metrics`): the
journal answers "what did the planner decide, in order, and why", metrics
answer "how much / how fast".
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import threading

__all__ = ["FleetJournal", "serialize_event", "rebuild_event",
           "serialize_dag", "rebuild_dag", "serialize_plan", "rebuild_plan"]


# Event (de)serialization is owned by the versioned schema in
# `repro_torch.fleet.events` -- ONE serialize/rebuild path for planner and
# control-plane events alike.  These wrappers stay for compatibility
# (`repro_torch.obs` re-exports them) and import lazily: `repro_torch.obs` must stay
# importable without pulling the fleet package in.
def _jobspec_to_dict(job) -> dict:
    return dataclasses.asdict(job)


def _jobspec_from_dict(data: dict):
    from repro_torch.fleet.events import _jobspec_from_dict as rebuild
    return rebuild(data)


def serialize_event(event) -> dict:
    """FleetEvent -> JSON-safe dict (see `repro_torch.fleet.events`)."""
    from repro_torch.fleet.events import serialize_event as ser
    return ser(event)


def rebuild_event(data: dict):
    """Inverse of `serialize_event` (see `repro_torch.fleet.events`)."""
    from repro_torch.fleet.events import rebuild_event as rebuild
    return rebuild(data)


# ------------------------------------------------- snapshot serialization
def serialize_dag(dag) -> dict:
    """CommDAG -> JSON-safe dict (tasks / deps / cluster / meta)."""
    return {
        "tasks": [dataclasses.asdict(t) for t in dag.tasks],
        "deps": [dataclasses.asdict(d) for d in dag.deps],
        "cluster": dataclasses.asdict(dag.cluster),
        "meta": {k: v for k, v in dag.meta.items()
                 if isinstance(k, str)},
    }


def rebuild_dag(data: dict):
    """Inverse of `serialize_dag` (tuple-typed fields restored)."""
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.core.dag import CommDAG, CommTask, Dep
    tasks = []
    for t in data["tasks"]:
        kw = dict(t)
        for f in ("src_gpus", "dst_gpus", "tag"):
            kw[f] = tuple(tuple(e) if isinstance(e, list) else e
                          for e in kw.get(f, ()))
        tasks.append(CommTask(**kw))
    deps = [Dep(**d) for d in data["deps"]]
    ckw = dict(data["cluster"])
    for f in dataclasses.fields(ClusterSpec):
        if f.name in ckw and isinstance(ckw[f.name], list):
            ckw[f.name] = tuple(ckw[f.name])
    return CommDAG(tasks=tasks, deps=deps, cluster=ClusterSpec(**ckw),
                   meta=data.get("meta", {}))


def serialize_plan(plan) -> dict | None:
    """CachedPlan -> JSON-safe dict (None passes through)."""
    if plan is None:
        return None
    return {"x": plan.x.tolist(), "makespan": plan.makespan,
            "comm_time": plan.comm_time, "nct": plan.nct,
            "ideal_comm_time": plan.ideal_comm_time,
            "details": json.loads(json.dumps(plan.details,
                                             default=_json_default))}


def rebuild_plan(data: dict | None):
    """Inverse of `serialize_plan`."""
    if data is None:
        return None
    import numpy as np
    from repro_torch.fleet.plancache import CachedPlan
    return CachedPlan(
        x=np.asarray(data["x"], dtype=np.int64),
        makespan=float(data["makespan"]),
        comm_time=float(data["comm_time"]), nct=float(data["nct"]),
        ideal_comm_time=float(data["ideal_comm_time"]),
        details=dict(data.get("details", {})))


class FleetJournal:
    """Append-only planner journal; JSONL-backed when given a path."""

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = os.fspath(path) if path is not None else None
        self.entries: list[dict] = []
        self._lock = threading.Lock()
        self._fh: io.TextIOBase | None = None
        if self.path is not None:
            # long-lived append handle, closed by close()/__exit__
            self._fh = open(self.path, "a")  # noqa: SIM115

    # ------------------------------------------------------------ recording
    def record(self, kind: str, **fields) -> dict:
        """Append one structured entry; returns it (with seq stamped)."""
        with self._lock:
            entry = {"seq": len(self.entries), "kind": kind, **fields}
            self.entries.append(entry)
            if self._fh is not None:
                json.dump(entry, self._fh, default=_json_default)
                self._fh.write("\n")
                self._fh.flush()
        return entry

    def record_event(self, event, record: dict) -> dict:
        """The planner's per-`handle()` entry: event + decision record."""
        return self.record("fleet_event", event=serialize_event(event),
                           record=record)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __len__(self) -> int:
        return len(self.entries)

    # -------------------------------------------------------------- replay
    @staticmethod
    def load(path: str | os.PathLike) -> list[dict]:
        """Read a JSONL journal back into entry dicts."""
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out

    @classmethod
    def rebuild_events(cls, entries) -> list:
        """Journal entries (or a path) -> ordered live FleetEvents, ready
        to re-drive a fresh `FleetPlanner.process()`."""
        if isinstance(entries, (str, os.PathLike)):
            entries = cls.load(entries)
        return [rebuild_event(e["event"]) for e in entries
                if e.get("kind") == "fleet_event"]


def _json_default(obj):
    """Decision records carry numpy scalars / arrays; keep JSONL valid."""
    import numpy as np
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return str(obj)
