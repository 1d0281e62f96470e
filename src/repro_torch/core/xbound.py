"""Alg. 2: XUpperBoundEstimation -- capacity upper bounds for x_ij.

Circuits beyond the maximum concurrent inter-pod flow weight are provably
useless (NIC-bound injection, paper O2), and dependency-linked tasks can
never transmit concurrently.  Per ordered pod pair we scan the EST/LCT
interval sequence and solve a Maximum-Weight Independent Set on the conflict
graph (vertices = co-windowed tasks, weights = flow counts F_m, edges =
mutual reachability in the transitive closure of D).

Transitive closure backends:
  * 'bitset'  -- topological DP over numpy uint64 bitsets, O(|D| * n / 64);
                 the fast CPU path used by default.
  * 'kernel'  -- repeated boolean matrix squaring (the paper's "via matrix
                 squaring") through `repro_torch.kernels.ops
                 .transitive_closure`: the tclosure kernel on the CUDA
                 device, its plain-torch version on the CPU.  It runs on
                 the CUDA device unless the caller names another
                 (``device="cpu"``); with none available it raises.
Both are cross-validated in tests.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dag import CommDAG
from repro_torch.core.pruning import cal_task_time_windows, estimate_t_up
from repro_torch.core.des import DESProblem
from repro_torch.kernels import ops
from repro_torch.obs import span


# ---------------------------------------------------------------- closures
def reachability_bitset(dag: CommDAG) -> np.ndarray:
    """Boolean reachability matrix over tasks (strict: no self loops)."""
    n = dag.num_tasks
    words = (n + 63) // 64
    reach = np.zeros((n, words), dtype=np.uint64)
    preds = dag.preds()
    for v in dag.topo_order():
        row = reach[v]
        for d in preds.get(v, ()):
            row |= reach[d.pre]
            row[d.pre >> 6] |= np.uint64(1) << np.uint64(d.pre & 63)
    # rows hold ancestor bitsets -> transpose to get reachability[u, v]
    bits = np.unpackbits(reach.view(np.uint8), axis=1, bitorder="little")
    return bits[:, :n].astype(bool).T


def dep_adjacency(dag: CommDAG, device: str | torch.device) -> torch.Tensor:
    """The 0/1 dependency matrix A[pre, succ] of D, bool (n, n) on
    `device`."""
    n = dag.num_tasks
    adj = torch.zeros((n, n), dtype=torch.bool, device=device)
    pre = torch.tensor([d.pre for d in dag.deps], dtype=torch.long)
    succ = torch.tensor([d.succ for d in dag.deps], dtype=torch.long)
    adj[pre.to(adj.device), succ.to(adj.device)] = True
    return adj


def reachability_kernel(dag: CommDAG, device: str | torch.device | None = None
                        ) -> np.ndarray:
    """Closure via repeated boolean matrix squaring (the tclosure kernel on
    the CUDA device; ``device="cpu"`` runs its plain version)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "reachability_kernel runs on a CUDA device and none is "
                "available; pass device='cpu' to run it on the CPU")
        device = "cuda"
    return ops.transitive_closure(dep_adjacency(dag, device)).cpu().numpy()


def reachability(dag: CommDAG, backend: str = "auto",
                 device: str | torch.device | None = None) -> np.ndarray:
    if backend == "kernel":
        return reachability_kernel(dag, device)
    if backend == "bitset" or dag.num_tasks > 1024 or backend == "auto":
        return reachability_bitset(dag)
    return reachability_kernel(dag, device)


# -------------------------------------------------------------------- MWIS
def mwis(weights: np.ndarray, adj: np.ndarray, exact_limit: int = 40
         ) -> float:
    """Maximum-weight independent set (exact branch & bound with greedy
    fallback above `exact_limit` vertices).

    weights: (k,) positive vertex weights; adj: (k, k) boolean symmetric.
    """
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
        remaining = acc + float(w[idx:][avail[idx:]].sum())
        if remaining <= best:
            return
        # branch 1: take idx
        take = avail.copy()
        take[idx] = False
        take &= ~a[idx]
        rec(idx + 1, take, acc + w[idx])
        # branch 2: skip idx
        skip = avail.copy()
        skip[idx] = False
        rec(idx + 1, skip, acc)

    rec(0, np.ones(k, dtype=bool), 0.0)
    return best


def _mwis_greedy(weights: np.ndarray, adj: np.ndarray) -> float:
    """Greedy w/deg heuristic; used only beyond the exact limit (upper
    bounds stay valid because any feasible IS weight lower-bounds MWIS and
    Alg. 2 needs an upper bound on concurrency -- so fall back to the sum of
    weights of a maximal greedy IS *plus* we keep it conservative by taking
    max with the heaviest single vertex)."""
    k = len(weights)
    avail = np.ones(k, dtype=bool)
    total = 0.0
    deg = adj.sum(1).astype(float)
    score = weights / np.maximum(deg, 1.0)
    for v in np.argsort(-score):
        if avail[v]:
            total += float(weights[v])
            avail[v] = False
            avail &= ~adj[v]
    return max(total, float(weights.max()))


# ------------------------------------------------------------------- Alg. 2
def x_upper_bound(dag: CommDAG, t_up: float | None = None,
                  closure_backend: str = "auto",
                  exact_limit: int = 40,
                  device: str | torch.device | None = None) -> np.ndarray:
    """Upper-bound matrix X̄ for the circuits between every pod pair;
    ``device`` is where the 'kernel' closure runs (see `reachability`)."""
    with span("xbound.upper_bound", tasks=dag.num_tasks,
              closure=closure_backend):
        return _x_upper_bound(dag, t_up, closure_backend, exact_limit,
                              device)


def _x_upper_bound(dag: CommDAG, t_up: float | None, closure_backend: str,
                   exact_limit: int, device: str | torch.device | None
                   ) -> np.ndarray:
    P = dag.cluster.num_pods
    xbar = np.zeros((P, P), dtype=np.int64)
    if t_up is None:
        t_up = estimate_t_up(DESProblem(dag))
    est, lct = cal_task_time_windows(dag, t_up)
    reach = reachability(dag, closure_backend, device)
    excl = reach | reach.T  # mutual exclusivity: dependency-linked pairs

    for (u, v), tids in dag.tasks_on_pair().items():
        tids = np.asarray(tids)
        bounds = np.unique(np.concatenate([est[tids], lct[tids]]))
        flows = dag.flows()[tids]
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            mid = 0.5 * (lo + hi)
            sel = (est[tids] <= mid) & (mid < lct[tids])
            if not sel.any():
                continue
            a_tids = tids[sel]
            sub = excl[np.ix_(a_tids, a_tids)]
            cmax = mwis(flows[sel], sub, exact_limit=exact_limit)
            xbar[u, v] = max(xbar[u, v], int(np.ceil(cmax)))
    # bidirectional circuits (Eq. 6): bound the symmetric pair jointly
    xbar = np.maximum(xbar, xbar.T)
    # never below 1 for active pairs (connectivity), never above ports
    U = np.asarray(dag.cluster.port_limits)
    for i, j in dag.undirected_pairs():
        cap = min(U[i], U[j])
        xbar[i, j] = xbar[j, i] = max(1, min(xbar[i, j], cap))
    return xbar
