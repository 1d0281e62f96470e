"""MILP search-space pruning (paper Sec. IV-A, Algs. 1 & 4).

* `cal_task_time_windows` (Alg. 4): earliest start / latest completion per
  task from forward/backward longest-path propagation with minimum physical
  durations tau_m = V_m / (F_m * B).  `dep_weights` is the same forward
  pass as a max-plus matrix: `repro_torch.kernels.ops.longest_paths` of it
  has the EST in its row VIRTUAL.
* `task_time_index_pruning` (Alg. 1): feasible interval-index windows
  [k_min, k_max] per task, combining whole-graph topological bounds with
  DES-profiled anchors for intermediate tasks.

The virtual source task (tid 0) participates with k = 0 / EST = LCT = 0 and
is excluded from the returned windows' consumers (the MILP models it as
constant offsets).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.dag import VIRTUAL, CommDAG
from repro_torch.core.des import DESProblem, DESResult, simulate
from repro_torch.kernels.ref import NEG_INF


def min_durations(dag: CommDAG) -> np.ndarray:
    """tau_m = V_m / (F_m * B): minimum physical duration of each task."""
    tau = np.zeros(dag.num_tasks)
    B = dag.cluster.nic_bandwidth
    for t in dag.real_tasks():
        tau[t.tid] = t.volume / (t.flows * B)
    return tau


# ------------------------------------------------------------------- Alg. 4
def dep_weights(dag: CommDAG) -> np.ndarray:
    """W[pre, succ] = max over deps of tau[pre] + delta (float64), NEG_INF
    where no dep: the forward pass of Alg. 4 as one max-plus step."""
    n = dag.num_tasks
    tau = min_durations(dag)
    pre = np.array([d.pre for d in dag.deps], dtype=np.int64)
    succ = np.array([d.succ for d in dag.deps], dtype=np.int64)
    delta = np.array([d.delta for d in dag.deps], dtype=np.float64)
    w = np.full((n, n), NEG_INF)
    np.maximum.at(w, (pre, succ), tau[pre] + delta)
    return w


def cal_task_time_windows(dag: CommDAG, t_up: float
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Earliest start time and latest completion time per task (Alg. 4)."""
    n = dag.num_tasks
    tau = min_durations(dag)
    est = np.zeros(n)
    lct = np.full(n, float(t_up))
    lct[VIRTUAL] = 0.0

    order = dag.topo_order()
    preds = dag.preds()
    succs = dag.succs()
    # Step 2: forward propagation
    for v in order:
        for d in preds.get(v, ()):
            est[v] = max(est[v], est[d.pre] + tau[d.pre] + d.delta)
    # Step 3: backward propagation
    for u in reversed(order):
        for d in succs.get(u, ()):
            lct[u] = min(lct[u], lct[d.succ] - tau[d.succ] - d.delta)
    return est, lct


def estimate_t_up(problem: DESProblem, slack: float = 1.05) -> float:
    """Coarse iteration-time upper bound: DES on the minimal connected
    topology (one circuit per active pair -- worst feasible contention)."""
    P = problem.dag.cluster.num_pods
    x = np.zeros((P, P), dtype=np.int64)
    for i, j in problem.dag.undirected_pairs():
        x[i, j] = x[j, i] = 1
    res = simulate(problem, x)
    if not res.feasible:  # pragma: no cover - defensive
        raise RuntimeError("minimal topology infeasible; DAG disconnected?")
    return float(res.makespan) * slack


# ------------------------------------------------------------------- Alg. 1
@dataclass(frozen=True)
class IndexWindows:
    k_min: np.ndarray   # (n,) 1-based first allowed interval (0 for virtual)
    k_max: np.ndarray   # (n,) 1-based last allowed interval
    K: int

    def allowed(self, m: int) -> range:
        return range(int(self.k_min[m]), int(self.k_max[m]) + 1)

    def num_task_intervals(self) -> int:
        real = slice(1, None)
        return int(np.sum(self.k_max[real] - self.k_min[real] + 1))


def task_time_index_pruning(dag: CommDAG, K: int,
                            anchors: np.ndarray | None = None,
                            anchor_margin: int = 1) -> IndexWindows:
    """Alg. 1: prune feasible interval indices per task.

    anchors: (n, 2) array of [k_start, k_end] from a baseline DES profile
    (DESResult.task_interval); only tasks *with successors* are anchored
    (intermediate tasks -- their position in the event sequence is rigid).
    anchor_margin widens the profiled window on both sides.
    """
    n = dag.num_tasks
    k_min = np.ones(n, dtype=np.int64)
    k_max = np.full(n, K, dtype=np.int64)
    k_min[VIRTUAL] = 0
    k_max[VIRTUAL] = 0

    has_succ = np.zeros(n, dtype=bool)
    for d in dag.deps:
        has_succ[d.pre] = True

    # Step 1: anchoring of intermediate tasks from the DES profile
    if anchors is not None:
        for m in range(1, n):
            if has_succ[m] and anchors[m, 0] >= 1:
                k_min[m] = max(1, int(anchors[m, 0]) - anchor_margin)
                k_max[m] = min(K, int(anchors[m, 1]) + anchor_margin)

    preds = dag.preds()
    succs = dag.succs()
    order = dag.topo_order()
    # Step 2: forward pass (earliest index)
    for v in order:
        for d in preds.get(v, ()):
            bump = 2 if d.delta > 0 else 1
            k_min[v] = max(k_min[v], k_min[d.pre] + bump)
    # Step 3: backward pass (latest index)
    for u in reversed(order):
        for d in succs.get(u, ()):
            bump = 2 if d.delta > 0 else 1
            k_max[u] = min(k_max[u], k_max[d.succ] - bump)

    # emptiness must be checked on the *unclipped* propagated values:
    # clipping into [1, K] first would silently repair a genuinely
    # infeasible window (e.g. k_max < 1 after the backward pass) into
    # [1, 1].  No clip is needed after the check: k_min >= 1 and only
    # increases, k_max <= K and only decreases, so any window passing the
    # check is already inside [1, K].
    if (k_max[1:] < k_min[1:]).any():
        bad = int(np.sum(k_max[1:] < k_min[1:]))
        raise ValueError(
            f"{bad} tasks have empty index windows; increase K or "
            f"anchor_margin")
    return IndexWindows(k_min=k_min, k_max=k_max, K=K)


def profile_anchors(problem: DESProblem, x: np.ndarray | None = None
                    ) -> tuple[DESResult, np.ndarray, int]:
    """Baseline DES profile used for anchoring and for K selection.

    Returns (result, anchors, K).  Default profiling topology: one circuit
    per active pair (the same baseline as estimate_t_up).
    """
    if x is None:
        P = problem.dag.cluster.num_pods
        x = np.zeros((P, P), dtype=np.int64)
        for i, j in problem.dag.undirected_pairs():
            x[i, j] = x[j, i] = 1
    res = simulate(problem, x)
    if not res.feasible:
        raise RuntimeError("anchor profile simulation infeasible")
    return res, res.task_interval, res.num_intervals


def pruning_stats(dag: CommDAG, windows: IndexWindows) -> dict:
    n_real = dag.num_real_tasks
    dense = n_real * windows.K
    kept = windows.num_task_intervals()
    return {"tasks": n_real, "K": windows.K, "dense_mk": dense,
            "kept_mk": kept, "reduction": 1.0 - kept / max(dense, 1)}
