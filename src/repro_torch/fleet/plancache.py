"""Topology plan cache keyed by a structural CommDAG signature.

Production AIDC fleets see the same (model, parallelism, schedule) jobs over
and over -- LLM traffic is deterministic given those three (paper feature
F1), so two jobs with isomorphic reduced DAGs and equal port budgets have
identical optimal topologies.  The signature hashes exactly the inputs the
planner consumes: tasks, deps, port limits, NIC bandwidth and the planning
options -- *not* the fleet pod ids, so a repeated workload admitted onto a
different pod span still hits.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from repro_torch.core.dag import CommDAG


def dag_signature(dag: CommDAG, extra: tuple = ()) -> str:
    """Stable content hash of the planner-visible parts of a CommDAG."""
    h = hashlib.sha256()
    cl = dag.cluster
    h.update(repr((cl.num_pods, tuple(int(u) for u in cl.port_limits),
                   float(cl.nic_bandwidth))).encode())
    for t in dag.tasks:
        h.update(repr((t.tid, t.src_pod, t.dst_pod, t.flows,
                       round(float(t.volume), 6), t.kind)).encode())
    for d in dag.deps:
        h.update(repr((d.pre, d.succ, round(float(d.delta), 12))).encode())
    h.update(repr(extra).encode())
    return h.hexdigest()


@dataclass
class CachedPlan:
    """What re-admitting an identical workload needs: the topology and its
    quality numbers (all local-pod indexed)."""

    x: np.ndarray
    makespan: float
    comm_time: float
    nct: float
    ideal_comm_time: float
    details: dict = field(default_factory=dict)

    def copy(self) -> "CachedPlan":
        return CachedPlan(x=self.x.copy(), makespan=self.makespan,
                          comm_time=self.comm_time, nct=self.nct,
                          ideal_comm_time=self.ideal_comm_time,
                          details=dict(self.details))


class PlanCache:
    """signature -> CachedPlan with hit/miss accounting."""

    def __init__(self, max_entries: int = 1024):
        self.max_entries = max_entries
        self._store: dict[str, CachedPlan] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._store)

    def get_or_plan(self, dag: CommDAG, planner: Callable[[], CachedPlan],
                    extra: tuple = ()) -> tuple[CachedPlan, bool]:
        """Return (plan, hit).  `planner` runs only on a miss."""
        sig = dag_signature(dag, extra)
        cached = self._store.get(sig)
        if cached is not None:
            self.hits += 1
            return cached.copy(), True
        self.misses += 1
        plan = planner()
        if len(self._store) >= self.max_entries:   # drop oldest entry
            self._store.pop(next(iter(self._store)))
        self._store[sig] = plan.copy()
        return plan, False

    def stats(self) -> dict[str, Any]:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._store)}
