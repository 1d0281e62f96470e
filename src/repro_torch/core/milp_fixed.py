"""Fixed-time-step MILP (paper Appendix A) -- complexity baseline.

The port's copy of `repro/core/milp_fixed.py` (host numpy and HiGHS, as
in the reference).

Uniform slices of length dt over [0, T_up].  Kept deliberately close to the
appendix formulation (Eqs. 19-30); used only on small instances to
demonstrate the variable-length-interval formulation's advantage (the paper:
tens of hours at 0.1 ms resolution even with pruning).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core.dag import VIRTUAL, CommDAG
from repro_torch.core.des import DESProblem
from repro_torch.core.milp import _Model, VOL
from repro_torch.core.pruning import estimate_t_up
from repro_torch.core.xbound import x_upper_bound


@dataclass
class FixedStepResult:
    x: np.ndarray
    makespan: float
    status: str
    solve_time: float
    num_slices: int
    stats: dict


def solve_fixed_step(dag: CommDAG, dt: float, t_up: float | None = None,
                     fairness: bool = False, time_limit: float = 600.0,
                     mip_rel_gap: float = 1e-4) -> FixedStepResult:
    md = _Model()
    B = dag.cluster.nic_bandwidth / VOL
    U = dag.cluster.port_limits
    n = dag.num_tasks
    vol = dag.volumes() / VOL
    flows = dag.flows()
    if t_up is None:
        t_up = estimate_t_up(DESProblem(dag))
    # headroom: every Eq.-28 dependency and every task duration rounds *up*
    # to the grid, so the discrete optimum can exceed the continuous bound
    # substantially (measured +12.5% on GPT-7B at dt = makespan/40) -- give
    # the horizon 2x slack; this only inflates the variable count, which is
    # the point of this complexity baseline
    T = int(np.ceil(2.0 * t_up / dt)) + dag.num_tasks
    xbar = x_upper_bound(dag, t_up=t_up)

    edges = dag.undirected_pairs()
    edge_of = {}
    xv = np.empty(len(edges), dtype=np.int64)
    for e, (i, j) in enumerate(edges):
        edge_of[(i, j)] = e
        edge_of[(j, i)] = e
        hi = max(1, int(min(U[i], U[j], xbar[i, j])))
        xv[e] = md.var(1, hi, integer=True)
    for p in range(dag.cluster.num_pods):
        coeffs = {int(xv[e]): 1.0 for e, (i, j) in enumerate(edges)
                  if p in (i, j)}
        if coeffs:
            md.row(coeffs, -np.inf, float(U[p]))

    # per-task slice variables
    rv = {}
    yv = {}
    Sv = {}
    Cvv = {}
    for m in range(1, n):
        cap = float(flows[m]) * B
        for t in range(1, T + 1):
            rv[(m, t)] = md.var(0.0, cap)
            yv[(m, t)] = md.var(0, 1, integer=True)
            Sv[(m, t)] = md.var(0, 1, integer=True)
            Cvv[(m, t)] = md.var(0, 1, integer=True)
    Cvar = md.var(0.0, T * dt)   # the discrete optimum can exceed t_up

    tasks_on = dag.tasks_on_pair()
    for (i, j), tids in tasks_on.items():
        e = edge_of[(i, j)]
        for t in range(1, T + 1):
            coeffs = {rv[(m, t)]: 1.0 for m in tids}
            coeffs[int(xv[e])] = -B
            md.row(coeffs, -np.inf, 0.0)                      # Eq. 22
    src_classes, dst_classes = dag.nic_classes()
    for tids, _ in src_classes + dst_classes:
        for t in range(1, T + 1):
            coeffs = {rv[(m, t)]: 1.0 / flows[m] for m in tids}
            md.row(coeffs, -np.inf, B)                        # Eq. 23

    for m in range(1, n):
        md.row({Sv[(m, t)]: 1.0 for t in range(1, T + 1)}, 1.0, 1.0)
        md.row({Cvv[(m, t)]: 1.0 for t in range(1, T + 1)}, 1.0, 1.0)
        for t in range(1, T + 1):
            coeffs = {yv[(m, t)]: 1.0, Sv[(m, t)]: -1.0, Cvv[(m, t)]: 1.0}
            if t > 1:
                coeffs[yv[(m, t - 1)]] = -1.0
            md.row(coeffs, 0.0, 0.0)                          # Eq. 25
            md.row({rv[(m, t)]: 1.0,
                    yv[(m, t)]: -float(flows[m]) * B}, -np.inf, 0.0)  # 27
        md.row({rv[(m, t)]: dt for t in range(1, T + 1)},
               float(vol[m]), np.inf)                         # Eq. 26
        md.row({Cvar: 1.0, **{Cvv[(m, t)]: -t * dt
                              for t in range(1, T + 1)}}, 0.0, np.inf)  # 30

    for d in dag.deps:                                        # Eq. 28
        if d.pre == VIRTUAL:
            lagged = int(np.ceil(d.delta / dt))
            md.row({Sv[(d.succ, t)]: float(t) for t in range(1, T + 1)},
                   1.0 + lagged, np.inf)
        else:
            coeffs = {Sv[(d.succ, t)]: float(t) for t in range(1, T + 1)}
            for t in range(1, T + 1):
                coeffs[Cvv[(d.pre, t)]] = coeffs.get(Cvv[(d.pre, t)], 0.0) \
                    - float(t)
            md.row(coeffs, float(np.ceil(d.delta / dt)), np.inf)

    if fairness:                                              # Eq. 29
        for tids in tasks_on.values():
            Mu = max(float(flows[m]) * B for m in tids)
            for t in range(1, T + 1):
                u_ = md.var(0.0, Mu)
                for m in tids:
                    md.row({rv[(m, t)]: 1.0 / flows[m], u_: -1.0,
                            yv[(m, t)]: Mu}, -np.inf, Mu)
                    md.row({u_: 1.0, rv[(m, t)]: -1.0 / flows[m],
                            yv[(m, t)]: Mu}, -np.inf, Mu)

    md.obj = {Cvar: 1.0}
    t0 = time.time()
    status, z, info = md.solve(time_limit, mip_rel_gap, False)
    solve_time = time.time() - t0
    P = dag.cluster.num_pods
    x = np.zeros((P, P), dtype=np.int64)
    makespan = np.inf
    if z is not None:
        for e, (i, j) in enumerate(edges):
            x[i, j] = x[j, i] = int(round(z[xv[e]]))
        makespan = float(z[Cvar])
    return FixedStepResult(x=x, makespan=makespan, status=status,
                           solve_time=solve_time, num_slices=T, stats=info)
