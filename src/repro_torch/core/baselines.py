"""Traffic-matrix-based logical-topology baselines (paper Sec. V-A2).

All three baselines see only the aggregated traffic matrix -- exactly the
information loss the paper criticizes -- and allocate symmetric circuits
subject to per-pod port budgets U_p:

  * Prop-Alloc (derived from SiP-ML [44]): circuits proportional to traffic
    volume.  Integer apportionment via the D'Hondt / Jefferson highest-
    quotient method (argmax w_ij / (x_ij + 1)), which is the integral
    counterpart of proportional allocation.
  * Sqrt-Alloc (paper's modification): proportional to sqrt(volume),
    modelling strictly sequential demands from a common source.
  * Iter-Halve (derived from TopoOpt [17]): repeatedly grant one circuit to
    the heaviest pair, then halve that pair's weight.

Every baseline first guarantees one circuit per active pair (connectivity),
then spends the remaining port budget per its rule.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.dag import CommDAG


def _undirected_weights(dag: CommDAG, transform=lambda v: v) -> np.ndarray:
    tm = dag.traffic_matrix()
    w = tm + tm.T
    w = np.triu(transform(np.where(w > 0, w, 0.0)), k=1)
    return w


def _greedy_fill(dag: CommDAG, weights: np.ndarray,
                 quotient: str, max_total: int | None = None) -> np.ndarray:
    """Symmetric integral allocation under port budgets.

    quotient='dhondt'  : pick argmax w/(x+1), keep w fixed  (Prop/Sqrt-Alloc)
    quotient='halving' : pick argmax w, then halve w        (Iter-Halve)
    """
    P = dag.cluster.num_pods
    U = np.array(dag.cluster.port_limits, dtype=np.int64)
    x = np.zeros((P, P), dtype=np.int64)
    used = np.zeros(P, dtype=np.int64)
    pairs = dag.undirected_pairs()
    w = weights.copy()

    def addable(i, j):
        return used[i] < U[i] and used[j] < U[j]

    # connectivity first
    for i, j in pairs:
        if addable(i, j):
            x[i, j] += 1
            x[j, i] += 1
            used[i] += 1
            used[j] += 1

    total = int(x.sum() // 2)
    while max_total is None or total < max_total:
        best, best_q = None, 0.0
        for i, j in pairs:
            if not addable(i, j) or w[i, j] <= 0:
                continue
            q = w[i, j] / (x[i, j] + 1) if quotient == "dhondt" else w[i, j]
            if q > best_q:
                best_q, best = q, (i, j)
        if best is None:
            break
        i, j = best
        x[i, j] += 1
        x[j, i] += 1
        used[i] += 1
        used[j] += 1
        total += 1
        if quotient == "halving":
            w[i, j] /= 2.0
    return x


def prop_alloc(dag: CommDAG) -> np.ndarray:
    """SiP-ML-style proportional-to-volume allocation."""
    return _greedy_fill(dag, _undirected_weights(dag), "dhondt")


def sqrt_alloc(dag: CommDAG) -> np.ndarray:
    """Proportional to sqrt(volume) (sequential-demand assumption)."""
    return _greedy_fill(dag, _undirected_weights(dag, np.sqrt), "dhondt")


def iter_halve(dag: CommDAG) -> np.ndarray:
    """TopoOpt-style iterative weight-halving allocation."""
    return _greedy_fill(dag, _undirected_weights(dag), "halving")


BASELINES = {
    "prop-alloc": prop_alloc,
    "sqrt-alloc": sqrt_alloc,
    "iter-halve": iter_halve,
}
