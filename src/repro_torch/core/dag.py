"""Reduced inter-pod communication DAG data structures (paper Sec. III-A).

A `CommTask` is the paper's 6-tuple m = (i_m, j_m, F_m, V_m, G_src, G_dst);
a `Dep` is an element (m_pre, m, delta) of the temporal-dependency set D.
Task 0 is always the virtual source task occurring at t=0 that carries the
rigid delays of intra-pod work preceding the first inter-pod communication.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Iterable, Iterator

import numpy as np

from repro_torch.core.cluster import ClusterSpec

VIRTUAL = 0  # tid of the virtual source task


@dataclass(frozen=True)
class CommTask:
    tid: int
    src_pod: int
    dst_pod: int
    flows: int            # F_m: concurrent GPU-pair flows aggregated in m
    volume: float         # V_m: bytes
    src_gpus: tuple[int, ...]
    dst_gpus: tuple[int, ...]
    kind: str = "comm"    # pp_fwd | pp_bwd | dp | xattn | ep_a2a_fwd |
                          # ep_a2a_bwd | virtual
    tag: tuple = ()       # free-form (replica, stage, microbatch, ...) labels

    @property
    def is_virtual(self) -> bool:
        return self.kind == "virtual"

    @property
    def pair(self) -> tuple[int, int]:
        return (self.src_pod, self.dst_pod)


@dataclass(frozen=True)
class Dep:
    pre: int
    succ: int
    delta: float  # rigid interval (seconds) after pre completes


def make_virtual() -> CommTask:
    return CommTask(tid=VIRTUAL, src_pod=-1, dst_pod=-1, flows=0, volume=0.0,
                    src_gpus=(), dst_gpus=(), kind="virtual")


@dataclass
class CommDAG:
    """Reduced inter-pod communication DAG for one training iteration."""

    tasks: list[CommTask]
    deps: list[Dep]
    cluster: ClusterSpec
    meta: dict = field(default_factory=dict)

    # ------------------------------------------------------------------ basic
    def __post_init__(self) -> None:
        self._validate()

    @property
    def num_tasks(self) -> int:
        return len(self.tasks)

    @property
    def num_real_tasks(self) -> int:
        return sum(1 for t in self.tasks if not t.is_virtual)

    def real_tasks(self) -> Iterator[CommTask]:
        return (t for t in self.tasks if not t.is_virtual)

    def _validate(self) -> None:
        if not self.tasks or self.tasks[VIRTUAL].kind != "virtual":
            raise ValueError("task 0 must be the virtual source task")
        n = len(self.tasks)
        for i, t in enumerate(self.tasks):
            if t.tid != i:
                raise ValueError(f"task {i} has tid {t.tid}")
            if not t.is_virtual:
                if t.volume <= 0 or t.flows <= 0:
                    raise ValueError(f"task {i}: non-positive volume/flows")
                if not (0 <= t.src_pod < self.cluster.num_pods):
                    raise ValueError(f"task {i}: bad src_pod {t.src_pod}")
                if not (0 <= t.dst_pod < self.cluster.num_pods):
                    raise ValueError(f"task {i}: bad dst_pod {t.dst_pod}")
                if t.src_pod == t.dst_pod:
                    raise ValueError(f"task {i}: intra-pod task in reduced DAG")
        for d in self.deps:
            if not (0 <= d.pre < n and 0 <= d.succ < n):
                raise ValueError(f"dep {d} out of range")
            if d.delta < 0:
                raise ValueError(f"dep {d} has negative delta")
        order = self.topo_order()  # raises on cycles
        pos = {t: i for i, t in enumerate(order)}
        for d in self.deps:
            if pos[d.pre] >= pos[d.succ]:  # pragma: no cover - defensive
                raise ValueError("topological order violated")

    # ------------------------------------------------------------ graph views
    def preds(self) -> dict[int, list[Dep]]:
        out: dict[int, list[Dep]] = collections.defaultdict(list)
        for d in self.deps:
            out[d.succ].append(d)
        return dict(out)

    def succs(self) -> dict[int, list[Dep]]:
        out: dict[int, list[Dep]] = collections.defaultdict(list)
        for d in self.deps:
            out[d.pre].append(d)
        return dict(out)

    def topo_order(self) -> list[int]:
        indeg = [0] * len(self.tasks)
        succs = collections.defaultdict(list)
        for d in self.deps:
            indeg[d.succ] += 1
            succs[d.pre].append(d.succ)
        queue = collections.deque(i for i, v in enumerate(indeg) if v == 0)
        order: list[int] = []
        while queue:
            u = queue.popleft()
            order.append(u)
            for v in succs[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    queue.append(v)
        if len(order) != len(self.tasks):
            raise ValueError("dependency graph has a cycle")
        return order

    # -------------------------------------------------------------- matrices
    def pod_pairs(self) -> list[tuple[int, int]]:
        """Active ordered pod pairs (i, j) with traffic, i != j."""
        pairs = sorted({t.pair for t in self.real_tasks()})
        return pairs

    def undirected_pairs(self) -> list[tuple[int, int]]:
        pairs = sorted({tuple(sorted(t.pair)) for t in self.real_tasks()})
        return [(int(a), int(b)) for a, b in pairs]

    def traffic_matrix(self) -> np.ndarray:
        """Aggregated volume matrix (bytes) -- what TM-based baselines see."""
        P = self.cluster.num_pods
        tm = np.zeros((P, P))
        for t in self.real_tasks():
            tm[t.src_pod, t.dst_pod] += t.volume
        return tm

    def flow_matrix(self) -> np.ndarray:
        """Max single-task flow count per ordered pair (lower bound on
        concurrency; Alg. 2 computes the true concurrent bound)."""
        P = self.cluster.num_pods
        fm = np.zeros((P, P), dtype=np.int64)
        for t in self.real_tasks():
            fm[t.src_pod, t.dst_pod] = max(fm[t.src_pod, t.dst_pod], t.flows)
        return fm

    def tasks_on_pair(self) -> dict[tuple[int, int], list[int]]:
        out: dict[tuple[int, int], list[int]] = collections.defaultdict(list)
        for t in self.real_tasks():
            out[t.pair].append(t.tid)
        return dict(out)

    # ------------------------------------------------------------ NIC classes
    def nic_classes(self) -> tuple[list[tuple[tuple[int, ...], float]], ...]:
        """Collapse per-GPU NIC constraints (Eq. 10) into equivalence classes.

        Two GPUs with identical task membership produce identical constraints;
        after the paper's stage-level aggregation whole TP groups collapse.
        Returns (src_classes, dst_classes); each class is
        (tuple of task ids, capacity multiplier == 1.0) and represents
        sum_m r_m / F_m <= B for one representative GPU.
        """
        src_of: dict[int, list[int]] = collections.defaultdict(list)
        dst_of: dict[int, list[int]] = collections.defaultdict(list)
        for t in self.real_tasks():
            for g in t.src_gpus:
                src_of[g].append(t.tid)
            for g in t.dst_gpus:
                dst_of[g].append(t.tid)

        def classes(of: dict[int, list[int]]):
            seen: dict[tuple[int, ...], int] = {}
            out: list[tuple[tuple[int, ...], float]] = []
            for tids in of.values():
                key = tuple(sorted(tids))
                if key not in seen:
                    seen[key] = len(out)
                    out.append((key, 1.0))
            return out

        return classes(src_of), classes(dst_of)

    # ---------------------------------------------------------------- helpers
    def dep_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        pre = np.array([d.pre for d in self.deps], dtype=np.int32)
        succ = np.array([d.succ for d in self.deps], dtype=np.int32)
        delta = np.array([d.delta for d in self.deps], dtype=np.float64)
        return pre, succ, delta

    def volumes(self) -> np.ndarray:
        return np.array([t.volume for t in self.tasks], dtype=np.float64)

    def flows(self) -> np.ndarray:
        return np.array([max(t.flows, 1) for t in self.tasks],
                        dtype=np.float64)

    def volume_by_kind(self) -> dict[str, float]:
        """Aggregate bytes per task kind (MoE-vs-dense traffic split)."""
        out: dict[str, float] = collections.defaultdict(float)
        for t in self.real_tasks():
            out[t.kind] += t.volume
        return dict(out)

    def ep_volume_fraction(self, by_kind: dict[str, float] | None = None
                           ) -> float:
        """Share of total inter-pod bytes carried by EP all-to-all tasks."""
        if by_kind is None:
            by_kind = self.volume_by_kind()
        total = sum(by_kind.values())
        ep = sum(v for k, v in by_kind.items() if k.startswith("ep_a2a"))
        return ep / total if total > 0 else 0.0

    def summary(self) -> dict:
        kinds = collections.Counter(t.kind for t in self.real_tasks())
        by_kind = self.volume_by_kind()
        return {
            "num_tasks": self.num_real_tasks,
            "num_deps": len(self.deps),
            "num_pods": self.cluster.num_pods,
            "pairs": len(self.pod_pairs()),
            "kinds": dict(kinds),
            "total_volume_gb": self.traffic_matrix().sum() / 1e9,
            "volume_by_kind_gb": {k: v / 1e9 for k, v in by_kind.items()},
            "ep_volume_fraction": self.ep_volume_fraction(by_kind),
        }


# default-argument sentinel for DagEnsemble.weights: lets the field carry a
# real ndarray type while __post_init__ substitutes uniform weights
_UNIFORM_WEIGHTS: np.ndarray = np.empty(0, dtype=np.float64)


@dataclass
class DagEnsemble:
    """A *set* of reduced CommDAGs sharing one physical cluster.

    The robust formulation (DELTA-Robust): OCS reconfiguration overhead
    forces one static logical topology to serve several workloads --
    co-tenant mixes, training phases, Model/Model^T placements, traffic
    growth scenarios.  An ensemble holds the named member DAGs, their
    mixture weights (normalized to sum 1) and the shared `ClusterSpec`
    every member must agree on (same pods, port budgets and NIC bandwidth;
    otherwise one port allocation cannot serve them all).

    `weights` drive the `weighted` objective; the `max-regret` objective
    ignores them and minimizes max_m makespan_m / ref_m where ref_m is
    member m's best single-DAG plan (see `repro_torch.core.ga.delta_robust`).
    """

    members: list[CommDAG]
    names: list[str] = field(default_factory=list)
    weights: np.ndarray = field(default_factory=lambda: _UNIFORM_WEIGHTS)
    meta: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.members:
            raise ValueError("DagEnsemble needs at least one member DAG")
        if not self.names:
            # auto-derived names: phases of the same job share meta["job"],
            # so disambiguate collisions with a positional suffix
            raw = [m.meta.get("job", f"member{i}")
                   for i, m in enumerate(self.members)]
            self.names = [n if raw.count(n) == 1 else f"{n}[{i}]"
                          for i, n in enumerate(raw)]
        if len(self.names) != len(self.members):
            raise ValueError(
                f"{len(self.names)} names for {len(self.members)} members")
        if len(set(self.names)) != len(self.names):
            raise ValueError(f"duplicate member names: {self.names}")
        if self.weights is None or self.weights is _UNIFORM_WEIGHTS:
            self.weights = np.ones(len(self.members))
        self.weights = np.asarray(self.weights, dtype=np.float64)
        if self.weights.shape != (len(self.members),):
            raise ValueError("weights must have one entry per member")
        if (self.weights <= 0).any():
            raise ValueError("weights must be positive")
        self.weights = self.weights / self.weights.sum()
        ref = self.members[0].cluster
        for name, m in zip(self.names, self.members):
            cl = m.cluster
            if (cl.num_pods != ref.num_pods
                    or tuple(cl.port_limits) != tuple(ref.port_limits)
                    or cl.nic_bandwidth != ref.nic_bandwidth):
                raise ValueError(
                    f"member {name!r} disagrees with the shared cluster: "
                    f"{cl.num_pods} pods / {cl.port_limits} ports / "
                    f"B={cl.nic_bandwidth:g} vs {ref.num_pods} / "
                    f"{ref.port_limits} / B={ref.nic_bandwidth:g}")

    # ------------------------------------------------------------------ basic
    @classmethod
    def singleton(cls, dag: CommDAG, name: str | None = None,
                  ) -> "DagEnsemble":
        return cls(members=[dag],
                   names=[name] if name is not None else [])

    @property
    def num_members(self) -> int:
        return len(self.members)

    @property
    def cluster(self) -> ClusterSpec:
        return self.members[0].cluster

    def __iter__(self) -> Iterator[tuple[str, float, CommDAG]]:
        return iter(zip(self.names, self.weights, self.members))

    def member(self, name: str) -> CommDAG:
        return self.members[self.names.index(name)]

    def plane_port_limits(self, num_planes: int
                          ) -> tuple[tuple[int, ...], ...]:
        """Per-plane port budgets of the shared cluster for a k-plane
        fabric: k tuples of per-pod budgets summing elementwise to the
        cluster's `port_limits` (see `ClusterSpec.plane_port_limits`)."""
        return self.cluster.plane_port_limits(num_planes)

    # ------------------------------------------------------------ union views
    def undirected_pairs(self) -> list[tuple[int, int]]:
        """Union of the members' active undirected pod pairs -- the genome /
        x-variable support of one shared topology."""
        pairs: set[tuple[int, int]] = set()
        for m in self.members:
            pairs.update(m.undirected_pairs())
        return sorted(pairs)

    def pod_pairs(self) -> list[tuple[int, int]]:
        pairs: set[tuple[int, int]] = set()
        for m in self.members:
            pairs.update(m.pod_pairs())
        return sorted(pairs)

    def traffic_matrix(self) -> np.ndarray:
        """Weight-averaged union traffic matrix (what a TM-based robust
        baseline would see)."""
        tm = np.zeros((self.cluster.num_pods,) * 2)
        for w, m in zip(self.weights, self.members):
            tm += w * m.traffic_matrix()
        return tm

    # -------------------------------------------------------------- profiles
    def ideal_makespans(self) -> np.ndarray:
        """Per-member makespan on an ideal non-blocking network (the NCT
        denominators; a lower bound on any ref used for regret)."""
        from repro_torch.core.des import DESProblem, simulate  # no import cycle

        out = np.empty(self.num_members)
        P = self.cluster.num_pods
        for i, m in enumerate(self.members):
            res = simulate(DESProblem(m), np.zeros((P, P)), ideal=True)
            out[i] = res.makespan
        return out

    def summary(self) -> dict:
        return {
            "members": {
                name: {"weight": float(w), **dag.summary()}
                for name, w, dag in self
            },
            "num_pods": self.cluster.num_pods,
            "union_pairs": len(self.undirected_pairs()),
            "total_volume_gb": float(self.traffic_matrix().sum() / 1e9),
        }


def merge_parallel_deps(deps: Iterable[Dep]) -> list[Dep]:
    """Keep only the max-delta edge for duplicated (pre, succ) pairs."""
    best: dict[tuple[int, int], float] = {}
    for d in deps:
        key = (d.pre, d.succ)
        if key not in best or d.delta > best[key]:
            best[key] = d.delta
    return [Dep(p, s, dl) for (p, s), dl in sorted(best.items())]
