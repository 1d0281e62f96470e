"""A training job's reduced inter-pod communication DAG as raw arrays.

Task 0 is the virtual source task at t = 0.  Each real task m carries its
pod pair (src_pod, dst_pod), its flow count F_m, its volume V_m in bytes
and the GPUs its flows leave from and arrive at; each dependency (pre,
succ, delta) holds succ back until `delta` seconds after pre completes.
The views below are plain re-derivations of the paper's definitions: the
active ordered pod pairs, the tasks on each pair, and the per-GPU NIC
constraints collapsed into classes of identical task membership.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass

import numpy as np


@dataclass
class RawDag:
    num_pods: int
    nic_bandwidth: float             # B: one NIC == one OCS port, bytes/s
    port_limits: np.ndarray          # (P,) U_p
    src_pod: np.ndarray              # (n,) -1 for the virtual task
    dst_pod: np.ndarray              # (n,)
    flows: np.ndarray                # (n,) F_m, 0 for the virtual task
    volume: np.ndarray               # (n,) V_m bytes
    virtual: np.ndarray              # (n,) bool
    src_gpus: list[tuple[int, ...]]
    dst_gpus: list[tuple[int, ...]]
    dep_pre: np.ndarray              # (d,)
    dep_succ: np.ndarray             # (d,)
    dep_delta: np.ndarray            # (d,) seconds

    @property
    def n(self) -> int:
        return len(self.volume)

    def real(self) -> np.ndarray:
        return np.nonzero(~self.virtual)[0]

    def flow_weights(self) -> np.ndarray:
        """F_m as the rate weights, at least 1 (the virtual task's 0)."""
        return np.maximum(self.flows, 1).astype(np.float64)

    def pod_pairs(self) -> list[tuple[int, int]]:
        """Active ordered pod pairs with traffic, sorted."""
        return sorted({(int(self.src_pod[m]), int(self.dst_pod[m]))
                       for m in self.real()})

    def undirected_pairs(self) -> list[tuple[int, int]]:
        return sorted({tuple(sorted((int(self.src_pod[m]),
                                     int(self.dst_pod[m]))))
                       for m in self.real()})

    def tasks_on_pair(self) -> dict[tuple[int, int], list[int]]:
        out: dict[tuple[int, int], list[int]] = collections.defaultdict(list)
        for m in self.real():
            out[(int(self.src_pod[m]), int(self.dst_pod[m]))].append(int(m))
        return dict(out)

    def nic_classes(self) -> tuple[list[tuple[int, ...]], ...]:
        """(source classes, destination classes): the task sets of the
        per-GPU NIC constraints, each distinct set once, in the order of
        the first GPU that has it."""
        src_of: dict[int, list[int]] = collections.defaultdict(list)
        dst_of: dict[int, list[int]] = collections.defaultdict(list)
        for m in self.real():
            for g in self.src_gpus[m]:
                src_of[g].append(int(m))
            for g in self.dst_gpus[m]:
                dst_of[g].append(int(m))

        def classes(of: dict[int, list[int]]) -> list[tuple[int, ...]]:
            seen: set[tuple[int, ...]] = set()
            out: list[tuple[int, ...]] = []
            for tids in of.values():
                key = tuple(sorted(tids))
                if key not in seen:
                    seen.add(key)
                    out.append(key)
            return out

        return classes(src_of), classes(dst_of)

    def preds(self) -> dict[int, list[int]]:
        """succ -> indices of its dependencies, in dependency order."""
        out: dict[int, list[int]] = collections.defaultdict(list)
        for j, s in enumerate(self.dep_succ):
            out[int(s)].append(j)
        return dict(out)

    def succs(self) -> dict[int, list[int]]:
        """pre -> indices of its dependencies, in dependency order."""
        out: dict[int, list[int]] = collections.defaultdict(list)
        for j, p in enumerate(self.dep_pre):
            out[int(p)].append(j)
        return dict(out)

    def topo_order(self) -> list[int]:
        indeg = np.zeros(self.n, dtype=np.int64)
        np.add.at(indeg, self.dep_succ, 1)
        nxt: dict[int, list[int]] = collections.defaultdict(list)
        for p, s in zip(self.dep_pre, self.dep_succ):
            nxt[int(p)].append(int(s))
        queue = collections.deque(int(i) for i in np.nonzero(indeg == 0)[0])
        order: list[int] = []
        while queue:
            u = queue.popleft()
            order.append(u)
            for v in nxt[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    queue.append(v)
        if len(order) != self.n:
            raise ValueError("dependency graph has a cycle")
        return order
