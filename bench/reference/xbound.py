"""A frozen copy of Alg. 2 (XUpperBoundEstimation) on the bitset closure.

Circuits between a pod pair beyond the largest flow weight that can be in
flight on it at once are useless (paper O2), and tasks linked by a chain
of dependencies never transmit together.  Per ordered pod pair, over the
sequence of EST/LCT boundaries of its tasks (Alg. 4's windows, from the
minimum durations V_m / (F_m * B) and an iteration-time bound T_up), the
bound is the maximum-weight independent set of the co-windowed tasks on
their conflict graph (edges: reachability in the transitive closure of
the dependencies, weights F_m).  The closure is a topological pass over
uint64 bitsets.  The bound is symmetrised (bidirectional circuits, Eq. 6),
and held within [1, min(U_i, U_j)] on every active pair.
"""
from __future__ import annotations

import numpy as np

from reference.dag import RawDag
from reference.des import Problem, simulate


def reachability(dag: RawDag) -> np.ndarray:
    """reach[u, v]: v depends on u through a chain of dependencies."""
    n = dag.n
    words = (n + 63) // 64
    anc = np.zeros((n, words), dtype=np.uint64)
    preds = dag.preds()
    for v in dag.topo_order():
        row = anc[v]
        for j in preds.get(v, ()):
            p = int(dag.dep_pre[j])
            row |= anc[p]
            row[p >> 6] |= np.uint64(1) << np.uint64(p & 63)
    bits = np.unpackbits(anc.view(np.uint8), axis=1, bitorder="little")
    return bits[:, :n].astype(bool).T


def mwis(weights: np.ndarray, adj: np.ndarray, exact_limit: int = 40
         ) -> float:
    """Maximum-weight independent set: exact branch and bound up to
    `exact_limit` vertices, the greedy weight-over-degree set (at least the
    heaviest vertex) beyond."""
    k = len(weights)
    if k == 0:
        return 0.0
    if not adj.any():
        return float(weights.sum())
    if k > exact_limit:
        return _mwis_greedy(weights, adj)
    order = np.argsort(-weights)
    w = weights[order].astype(float)
    a = adj[np.ix_(order, order)]
    best = 0.0

    def rec(idx: int, avail: np.ndarray, acc: float) -> None:
        nonlocal best
        while idx < k and not avail[idx]:
            idx += 1
        if idx >= k:
            best = max(best, acc)
            return
        if acc + float(w[idx:][avail[idx:]].sum()) <= best:
            return
        take = avail.copy()
        take[idx] = False
        take &= ~a[idx]
        rec(idx + 1, take, acc + w[idx])
        skip = avail.copy()
        skip[idx] = False
        rec(idx + 1, skip, acc)

    rec(0, np.ones(k, dtype=bool), 0.0)
    return best


def _mwis_greedy(weights: np.ndarray, adj: np.ndarray) -> float:
    avail = np.ones(len(weights), dtype=bool)
    total = 0.0
    score = weights / np.maximum(adj.sum(1).astype(float), 1.0)
    for v in np.argsort(-score):
        if avail[v]:
            total += float(weights[v])
            avail[v] = False
            avail &= ~adj[v]
    return max(total, float(weights.max()))


def t_upper(problem: Problem, slack: float = 1.05) -> float:
    """T_up: the makespan with one circuit on every active pair (the
    worst feasible contention), with 5% slack."""
    P = problem.dag.num_pods
    x = np.zeros((P, P), dtype=np.int64)
    for i, j in problem.dag.undirected_pairs():
        x[i, j] = x[j, i] = 1
    res = simulate(problem, x)
    if not res.feasible:
        raise RuntimeError("the one-circuit topology is infeasible")
    return float(res.makespan) * slack


def time_windows(dag: RawDag, t_up: float) -> tuple[np.ndarray, np.ndarray]:
    """Alg. 4: earliest start and latest completion of every task."""
    n = dag.n
    tau = np.zeros(n)
    real = dag.real()
    tau[real] = dag.volume[real] / (dag.flows[real] * dag.nic_bandwidth)
    est = np.zeros(n)
    lct = np.full(n, float(t_up))
    lct[0] = 0.0
    order = dag.topo_order()
    preds, succs = dag.preds(), dag.succs()
    for v in order:
        for j in preds.get(v, ()):
            p = int(dag.dep_pre[j])
            est[v] = max(est[v], est[p] + tau[p] + dag.dep_delta[j])
    for u in reversed(order):
        for j in succs.get(u, ()):
            s = int(dag.dep_succ[j])
            lct[u] = min(lct[u], lct[s] - tau[s] - dag.dep_delta[j])
    return est, lct


def x_upper_bound(dag: RawDag, exact_limit: int = 40) -> np.ndarray:
    """X̄: the (P, P) bound on useful circuits of every pod pair."""
    P = dag.num_pods
    xbar = np.zeros((P, P), dtype=np.int64)
    est, lct = time_windows(dag, t_upper(Problem(dag)))
    reach = reachability(dag)
    excl = reach | reach.T
    flows = dag.flow_weights()
    for (u, v), tids in dag.tasks_on_pair().items():
        tids = np.asarray(tids)
        bounds = np.unique(np.concatenate([est[tids], lct[tids]]))
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            mid = 0.5 * (lo + hi)
            sel = (est[tids] <= mid) & (mid < lct[tids])
            if not sel.any():
                continue
            a_tids = tids[sel]
            cmax = mwis(flows[tids][sel], excl[np.ix_(a_tids, a_tids)],
                        exact_limit=exact_limit)
            xbar[u, v] = max(xbar[u, v], int(np.ceil(cmax)))
    xbar = np.maximum(xbar, xbar.T)
    U = np.asarray(dag.port_limits)
    for i, j in dag.undirected_pairs():
        xbar[i, j] = xbar[j, i] = max(1, min(xbar[i, j], min(U[i], U[j])))
    return xbar
