"""Variable-length time-interval MILP (paper Sec. III-B, Eqs. 3-18).

The port's copy of `repro/core/milp.py`: the model is assembled and
solved on the host (numpy, scipy's HiGHS) exactly as in the reference,
so the same DAG gives the same constraint matrix, bounds and objective.
Only `solve_resilient`'s GA stage reaches the device, through the port's
`delta_fast`, and it is not guarded: a device or kernel that fails
raises out of it.

Decision variables (per Fig. 4):
  x_e (integer circuits per undirected pod pair; Eq. 6 symmetry is built in),
  beta_{e,b} (binary expansion, Eq. 7), t_k / Delta_k (interval boundaries /
  durations), rho_{e,b,k} (Big-M linearized beta * Delta, Eq. 8),
  w_{m,k} (volume), y_{m,k} (activation), s_flag_{m,k} (rising edge),
  S_m / C_m / C, u_{p,k} (optional fairness reference, Eq. 17).

Solved with HiGHS via scipy.optimize.milp (Gurobi is unavailable offline;
see DESIGN.md).  Hot starting is realized as (a) an objective upper-bound
cut C <= C_incumbent and (b) a polish pre-pass that fixes the activation
pattern y to the DES trace and solves the restricted MILP to produce a
valid incumbent -- both prune branch & bound like a MIP start.

DELTA-Topo  = solve(..., fairness=True)   (rates degrade to fair sharing)
DELTA-Joint = solve(..., fairness=False)  (joint topology + rate control)
Port minimization (Eq. 4) = second lexicographic solve with C <= C*.

Internally volumes are scaled to GB and rates to GB/s to keep the
constraint matrix well conditioned.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp
from scipy.optimize import Bounds, LinearConstraint, milp

from repro_torch.core.dag import VIRTUAL, CommDAG, DagEnsemble
from repro_torch.core.des import DESProblem, DESResult, simulate
from repro_torch.core.ga import delta_fast
from repro_torch.core.pruning import (IndexWindows, estimate_t_up,
                                      profile_anchors,
                                      task_time_index_pruning)
from repro_torch.core.xbound import x_upper_bound
from repro_torch.obs import get_counter, span

VOL = 1e9  # internal volume unit (GB)

_SOLVES = get_counter("milp_solves_total",
                      "MILP solver invocations by terminal status")
_FALLBACKS = get_counter(
    "fleet_fallbacks_total",
    "solve_resilient fallback transitions, by chain stage")


@dataclass
class MILPOptions:
    fairness: bool = False          # True: DELTA-Topo; False: DELTA-Joint
    port_min: bool = False          # lexicographic Eq. (4) second phase
    prune: bool = True              # Alg. 1 index windows
    anchor_margin: int = 1
    K: int | None = None            # default: profiled from baseline DES
    k_slack: int = 0                # extra intervals appended after K
    time_limit: float = 600.0
    mip_rel_gap: float = 1e-4
    hot_start: bool = True
    upper_bound: float | None = None   # externally supplied incumbent C
    seed_x: np.ndarray | None = None   # incumbent topology (e.g. delta-fast)
                                       # whose DES trace seeds the hot start
    xbar: np.ndarray | None = None     # Alg. 2 bounds (computed if None)
    t_up: float | None = None
    verbose: bool = False


@dataclass
class MILPResult:
    x: np.ndarray                 # (P, P) symmetric circuits
    makespan: float
    status: str
    solve_time: float
    start: np.ndarray             # S_m (n,)
    finish: np.ndarray            # C_m (n,)
    t: np.ndarray                 # interval boundaries t_1..t_{K+1}
    w: dict[tuple[int, int], float] = field(default_factory=dict)
    y: dict[tuple[int, int], int] = field(default_factory=dict)
    total_ports: int = 0
    port_min_applied: bool = False
    stats: dict = field(default_factory=dict)
    degraded: bool = False        # produced by a solve_resilient fallback
    fallback_stage: str = ""      # "" | "ga" | "current"

    @property
    def feasible(self) -> bool:
        # a time_limit return with no incumbent carries makespan=inf: the
        # finite check turns it into a clean fallback trigger instead of a
        # silently-invalid plan (see solve_resilient)
        return self.status in ("optimal", "feasible", "time_limit") \
            and bool(np.isfinite(self.makespan))


class _Model:
    """Sparse MILP assembler (lb <= A z <= ub)."""

    def __init__(self):
        self.nvar = 0
        self.lb: list[float] = []
        self.ub: list[float] = []
        self.integrality: list[int] = []
        self.obj: dict[int, float] = {}
        self.rows_i: list[int] = []
        self.rows_j: list[int] = []
        self.rows_v: list[float] = []
        self.row_lb: list[float] = []
        self.row_ub: list[float] = []
        self.nrow = 0

    def var(self, lb: float, ub: float, integer: bool = False) -> int:
        self.lb.append(lb)
        self.ub.append(ub)
        self.integrality.append(1 if integer else 0)
        self.nvar += 1
        return self.nvar - 1

    def vars(self, n: int, lb: float, ub: float, integer: bool = False
             ) -> np.ndarray:
        out = np.arange(self.nvar, self.nvar + n)
        self.lb += [lb] * n
        self.ub += [ub] * n
        self.integrality += [1 if integer else 0] * n
        self.nvar += n
        return out

    def row(self, coeffs: dict[int, float], lb: float, ub: float) -> None:
        for j, v in coeffs.items():
            if v != 0.0:
                self.rows_i.append(self.nrow)
                self.rows_j.append(j)
                self.rows_v.append(v)
        self.row_lb.append(lb)
        self.row_ub.append(ub)
        self.nrow += 1

    def solve(self, time_limit: float, mip_rel_gap: float, verbose: bool,
              phase: str = "main") -> tuple[str, np.ndarray | None, dict]:
        with span("milp.solve", phase=phase, nvars=self.nvar,
                  nrows=self.nrow) as sp_:
            c = np.zeros(self.nvar)
            for j, v in self.obj.items():
                c[j] = v
            A = sp.csc_matrix(
                (self.rows_v, (self.rows_i, self.rows_j)),
                shape=(self.nrow, self.nvar))
            res = milp(
                c=c,
                constraints=LinearConstraint(A, np.asarray(self.row_lb),
                                             np.asarray(self.row_ub)),
                bounds=Bounds(np.asarray(self.lb), np.asarray(self.ub)),
                integrality=np.asarray(self.integrality),
                options={"time_limit": time_limit,
                         "mip_rel_gap": mip_rel_gap, "disp": verbose},
            )
            status = {0: "optimal", 1: "iteration_limit", 2: "infeasible",
                      3: "unbounded", 4: "error"}.get(res.status, "error")
            if status == "iteration_limit":
                # the budget expired; with no incumbent (res.x is None) the
                # caller's z-None path returns makespan=inf, which the
                # finite-makespan `feasible` guard turns into a clean
                # fallback trigger rather than a silently-invalid plan
                status = "time_limit"
            sp_.set(status=status)
            _SOLVES.inc(phase=phase, status=status)
            info = {"mip_gap": getattr(res, "mip_gap", None),
                    "nvars": self.nvar, "nrows": self.nrow,
                    "message": res.message}
            return status, res.x, info


@dataclass
class _Layout:
    """Variable indices one assembled model's *extraction* needs.

    Assembly-only index maps (edge_of, Lbits, beta, rho, u) live as locals
    in the builders: storing them here was write-only plumbing (RPR001).
    """
    edges: list[tuple[int, int]]
    x: np.ndarray
    t: np.ndarray
    delta: np.ndarray
    w: dict[tuple[int, int], int]
    y: dict[tuple[int, int], int]
    s: dict[tuple[int, int], int]
    S: np.ndarray
    Cm: np.ndarray
    C: int
    K: int
    windows: IndexWindows


def _build_topology(md: _Model, cluster, edges: list[tuple[int, int]],
                    xbar: np.ndarray
                    ) -> tuple[np.ndarray, list[np.ndarray], list[int],
                               dict[tuple[int, int], int]]:
    """Shared topology block: x_e + Eq. (7) binary expansion + Eq. (5)
    port budgets.  Factored out of `_build` so the robust formulation can
    attach several per-member schedule blocks to ONE port allocation."""
    U = cluster.port_limits
    edge_of: dict[tuple[int, int], int] = {}
    for e_idx, (i, j) in enumerate(edges):
        edge_of[(i, j)] = e_idx
        edge_of[(j, i)] = e_idx

    # ---- x_e and binary expansion
    xv = np.empty(len(edges), dtype=np.int64)
    beta: list[np.ndarray] = []
    Lbits: list[int] = []
    for e_idx, (i, j) in enumerate(edges):
        hi = int(min(U[i], U[j], xbar[i, j]))
        hi = max(hi, 1)
        xv[e_idx] = md.var(1, hi, integer=True)
        L = int(np.floor(np.log2(hi))) + 1
        Lbits.append(L)
        beta.append(md.vars(L, 0, 1, integer=True))
        # Eq. (7)
        coeffs = {int(xv[e_idx]): 1.0}
        for b in range(L):
            coeffs[int(beta[e_idx][b])] = -(2.0 ** b)
        md.row(coeffs, 0.0, 0.0)

    # ---- Eq. (5): port budgets (symmetric circuits: one row per pod)
    for p in range(cluster.num_pods):
        coeffs = {int(xv[e]): 1.0 for e, (i, j) in enumerate(edges)
                  if i == p or j == p}
        if coeffs:
            md.row(coeffs, -np.inf, float(U[p]))
    return xv, beta, Lbits, edge_of


def _build_member(md: _Model, dag: CommDAG, fairness: bool,
                  windows: IndexWindows, t_up: float,
                  edges: list[tuple[int, int]],
                  edge_of: dict[tuple[int, int], int], xv: np.ndarray,
                  beta: list[np.ndarray], Lbits: list[int]) -> _Layout:
    """One member's schedule block (Eqs. 8-18 + optional Eq. 17) wired to
    the shared topology variables.  Every time/volume/activation variable
    is private to the member; only x/beta are shared."""
    n = dag.num_tasks
    K = windows.K
    B = dag.cluster.nic_bandwidth / VOL
    T = t_up

    vol = dag.volumes() / VOL
    flows = dag.flows()

    # ---- time variables
    tv = md.vars(K + 1, 0.0, T)
    md.ub[tv[0]] = 0.0  # t_1 = 0
    dv = md.vars(K, 0.0, T)
    for k in range(K):
        # Eq. (14): delta_k - t_{k+1} + t_k = 0
        md.row({int(dv[k]): 1.0, int(tv[k + 1]): -1.0, int(tv[k]): 1.0},
               0.0, 0.0)

    # ---- task windows and w/y/s variables
    wv: dict[tuple[int, int], int] = {}
    yv: dict[tuple[int, int], int] = {}
    sv: dict[tuple[int, int], int] = {}
    for m in range(1, n):
        for k in windows.allowed(m):
            wv[(m, k)] = md.var(0.0, float(vol[m]))
            yv[(m, k)] = md.var(0, 1, integer=True)
            sv[(m, k)] = md.var(0, 1, integer=True)

    Sv = np.zeros(n, dtype=np.int64)
    Cv = np.zeros(n, dtype=np.int64)
    for m in range(1, n):
        Sv[m] = md.var(0.0, T)
        Cv[m] = md.var(0.0, T)
    Cvar = md.var(0.0, T)

    # which intervals matter per ordered pair / per edge
    pair_ks: dict[tuple[int, int], set[int]] = {}
    for t_ in dag.real_tasks():
        ks = pair_ks.setdefault(t_.pair, set())
        ks.update(windows.allowed(t_.tid))
    edge_ks: dict[int, set[int]] = {}
    for pair, ks in pair_ks.items():
        edge_ks.setdefault(edge_of[pair], set()).update(ks)

    # ---- rho vars + Eq. (8) Big-M linearization (only needed (e, b, k))
    rho: dict[tuple[int, int], np.ndarray] = {}
    for e_idx in range(len(edges)):
        ks = sorted(edge_ks.get(e_idx, ()))
        for b in range(Lbits[e_idx]):
            arr = np.full(K + 1, -1, dtype=np.int64)
            for k in ks:
                r = md.var(0.0, T)
                arr[k] = r
                bvar = int(beta[e_idx][b])
                md.row({r: 1.0, bvar: -T}, -np.inf, 0.0)
                md.row({r: 1.0, int(dv[k - 1]): -1.0}, -np.inf, 0.0)
                md.row({r: 1.0, int(dv[k - 1]): -1.0, bvar: -T}, -T, np.inf)
            rho[(e_idx, b)] = arr

    # ---- Eq. (9): link capacity per ordered pair & interval
    tasks_on = dag.tasks_on_pair()
    for pair, tids in tasks_on.items():
        e_idx = edge_of[pair]
        for k in sorted(pair_ks[pair]):
            coeffs: dict[int, float] = {}
            for m in tids:
                if (m, k) in wv:
                    coeffs[wv[(m, k)]] = 1.0
            if not coeffs:
                continue
            for b in range(Lbits[e_idx]):
                coeffs[int(rho[(e_idx, b)][k])] = -B * (2.0 ** b)
            md.row(coeffs, -np.inf, 0.0)

    # ---- Eq. (10): NIC injection/reception per class & interval
    src_classes, dst_classes = dag.nic_classes()
    for tids, _ in src_classes + dst_classes:
        ks = set()
        for m in tids:
            ks.update(windows.allowed(m))
        for k in sorted(ks):
            coeffs: dict[int, float] = {}
            for m in tids:
                if (m, k) in wv:
                    coeffs[wv[(m, k)]] = 1.0 / flows[m]
            if not coeffs:
                continue
            coeffs[int(dv[k - 1])] = -B
            md.row(coeffs, -np.inf, 0.0)

    # ---- Eqs. (11)-(13): conservation, activation, single rising edge
    for m in range(1, n):
        ks = list(windows.allowed(m))
        md.row({wv[(m, k)]: 1.0 for k in ks}, float(vol[m]), float(vol[m]))
        for k in ks:
            md.row({wv[(m, k)]: 1.0, yv[(m, k)]: -float(vol[m])},
                   -np.inf, 0.0)
            coeffs = {sv[(m, k)]: 1.0, yv[(m, k)]: -1.0}
            if (m, k - 1) in yv:
                coeffs[yv[(m, k - 1)]] = 1.0
            md.row(coeffs, 0.0, np.inf)
        md.row({sv[(m, k)]: 1.0 for k in ks}, 1.0, 1.0)

    # ---- Eq. (15): temporal boundaries
    for (m, k), y_ in yv.items():
        md.row({int(Sv[m]): 1.0, int(tv[k - 1]): -1.0, y_: T}, -np.inf, T)
        md.row({int(Cv[m]): 1.0, int(tv[k]): -1.0, y_: -T}, -T, np.inf)

    # ---- Eq. (16): DAG precedence (virtual predecessor -> S lower bound)
    for d in dag.deps:
        if d.pre == VIRTUAL:
            md.lb[int(Sv[d.succ])] = max(md.lb[int(Sv[d.succ])],
                                         float(d.delta))
        else:
            md.row({int(Sv[d.succ]): 1.0, int(Cv[d.pre]): -1.0},
                   float(d.delta), np.inf)

    # ---- Eq. (18): makespan
    for m in range(1, n):
        md.row({Cvar: 1.0, int(Cv[m]): -1.0}, 0.0, np.inf)

    # ---- Eq. (17): optional fairness constraints
    uv: dict[tuple[int, int], int] = {}
    if fairness:
        for pair, tids in tasks_on.items():
            # tight Big-M: per-flow volume on this pair never exceeds the
            # largest per-flow task volume crossing it
            Mu = max(float(vol[m]) / float(flows[m]) for m in tids)
            for k in sorted(pair_ks[pair]):
                u_ = md.var(0.0, Mu)
                uv[(edge_of[pair], k)] = u_  # keyed per *ordered* pair use
                for m in tids:
                    if (m, k) not in wv:
                        continue
                    y_ = yv[(m, k)]
                    f = float(flows[m])
                    md.row({wv[(m, k)]: 1.0 / f, u_: -1.0, y_: Mu},
                           -np.inf, Mu)
                    md.row({u_: 1.0, wv[(m, k)]: -1.0 / f, y_: Mu},
                           -np.inf, Mu)

    return _Layout(edges=edges, x=xv, t=tv, delta=dv, w=wv, y=yv, s=sv,
                   S=Sv, Cm=Cv, C=Cvar, K=K, windows=windows)


def _build(dag: CommDAG, opts: MILPOptions, windows: IndexWindows,
           xbar: np.ndarray, t_up: float) -> tuple[_Model, _Layout]:
    """Single-DAG model: one topology block + one member block."""
    md = _Model()
    edges = dag.undirected_pairs()
    xv, beta, Lbits, edge_of = _build_topology(md, dag.cluster, edges, xbar)
    layout = _build_member(md, dag, opts.fairness, windows, t_up, edges,
                           edge_of, xv, beta, Lbits)
    return md, layout


def _extract(dag: CommDAG, md: _Model, lay: _Layout, z: np.ndarray,
             status: str, solve_time: float, stats: dict) -> MILPResult:
    P = dag.cluster.num_pods
    x = np.zeros((P, P), dtype=np.int64)
    for e_idx, (i, j) in enumerate(lay.edges):
        v = int(round(z[lay.x[e_idx]]))
        x[i, j] = x[j, i] = v
    n = dag.num_tasks
    # Tighten S_m / C_m to the actual transmission boundaries: the MILP only
    # brackets them (S <= first active t_k, C >= last active t_{k+1}), so we
    # recompute them from the activation pattern y and the solved interval
    # boundaries t.  This matters for critical-path extraction (NCT).
    start = np.zeros(n)
    finish = np.zeros(n)
    tgrid = z[lay.t]
    for m in range(1, n):
        # prefer intervals that actually carry volume (y may be spuriously 1
        # with w == 0 on non-critical tasks); fall back to the y pattern
        allowed = list(lay.windows.allowed(m))
        wvals = {k: float(z[lay.w[(m, k)]]) for k in allowed}
        wmax = max(wvals.values(), default=0.0)
        ks = [k for k in allowed if wvals[k] > 1e-7 * max(wmax, 1e-12)]
        if not ks:
            ks = [k for k in allowed if z[lay.y[(m, k)]] > 0.5]
        if ks:
            start[m] = tgrid[min(ks) - 1]
            finish[m] = tgrid[max(ks)]
        else:  # pragma: no cover - (13) forbids this
            start[m] = z[lay.S[m]]
            finish[m] = z[lay.Cm[m]]
    w = {k: float(v) * VOL for k, v in
         ((key, z[idx]) for key, idx in lay.w.items()) if v > 1e-9}
    y = {key: int(round(z[idx])) for key, idx in lay.y.items()
         if z[idx] > 0.5}
    return MILPResult(
        x=x, makespan=float(z[lay.C]), status=status, solve_time=solve_time,
        start=start, finish=finish, t=z[lay.t], w=w, y=y,
        total_ports=int(x.sum()), stats=stats)


def _apply_hot_start(md: _Model, lay: _Layout, dag: CommDAG,
                     baseline: DESResult, t_up: float) -> _Model:
    """Polish pre-pass: fix y/s to the DES trace -> restricted MILP."""
    md2 = copy.deepcopy(md)
    ti = baseline.task_interval
    for (m, k), idx in lay.y.items():
        val = 1.0 if ti[m, 0] <= k <= ti[m, 1] else 0.0
        md2.lb[idx] = md2.ub[idx] = val
    for (m, k), idx in lay.s.items():
        val = 1.0 if k == ti[m, 0] else 0.0
        md2.lb[idx] = md2.ub[idx] = val
    return md2


def solve_delta_milp(dag: CommDAG, opts: MILPOptions | None = None
                     ) -> MILPResult:
    """DELTA-Topo / DELTA-Joint MILP with pruning, hot start and the
    optional lexicographic port-minimization phase."""
    opts = opts or MILPOptions()
    t0 = time.time()
    problem = DESProblem(dag)
    baseline, anchors, K_prof = profile_anchors(problem)
    if opts.seed_x is not None:
        # seed the anchors/polish trace from an incumbent topology (the
        # GA's array-resident result): the hot-start pre-pass then fixes
        # the activation pattern to a near-optimal schedule instead of the
        # one-circuit baseline.  K keeps the default profile as a floor so
        # the seeded windows never have fewer intervals than the baseline.
        with contextlib.suppress(RuntimeError):
            # an infeasible seed keeps the default profile
            sb, sa, sk = profile_anchors(problem, np.asarray(opts.seed_x))
            baseline, anchors, K_prof = sb, sa, max(sk, K_prof)
    t_up = opts.t_up or estimate_t_up(problem)
    K = opts.K or (K_prof + opts.k_slack)
    if opts.prune:
        windows = task_time_index_pruning(dag, K, anchors,
                                          anchor_margin=opts.anchor_margin)
    else:
        windows = task_time_index_pruning(dag, K, anchors=None)
    xbar = opts.xbar if opts.xbar is not None else \
        x_upper_bound(dag, t_up=t_up)

    with span("milp.build", K=K, tasks=dag.num_tasks):
        md, lay = _build(dag, opts, windows, xbar, t_up)
    md.obj = {lay.C: 1.0}
    prep_time = time.time() - t0

    incumbent = opts.upper_bound
    hot_time = 0.0
    if opts.hot_start:
        th = time.time()
        md_hot = _apply_hot_start(md, lay, dag, baseline, t_up)
        md_hot.obj = {lay.C: 1.0}
        st_h, z_h, _ = md_hot.solve(min(opts.time_limit / 4, 60.0),
                                    1e-3, False, phase="hot_start")
        if st_h in ("optimal", "time_limit") and z_h is not None:
            cand = float(z_h[lay.C]) * (1 + 1e-6) + 1e-9
            incumbent = min(incumbent, cand) if incumbent else cand
        hot_time = time.time() - th
    if incumbent is not None:
        md.ub[lay.C] = min(md.ub[lay.C], incumbent)

    ts = time.time()
    status, z, info = md.solve(opts.time_limit, opts.mip_rel_gap,
                               opts.verbose)
    solve_time = time.time() - ts
    if z is None:
        P = dag.cluster.num_pods
        return MILPResult(x=np.zeros((P, P), dtype=np.int64), makespan=np.inf,
                          status=status, solve_time=solve_time,
                          start=np.zeros(dag.num_tasks),
                          finish=np.zeros(dag.num_tasks),
                          t=np.zeros(K + 1),
                          stats={**info, "prep_time": prep_time,
                                 "hot_time": hot_time})
    info.update(prep_time=prep_time, hot_time=hot_time, K=K,
                kept_mk=windows.num_task_intervals(),
                incumbent=incumbent)
    result = _extract(dag, md, lay, z, status, solve_time, info)

    if opts.port_min and result.feasible:
        tp = time.time()
        md.ub[lay.C] = result.makespan * (1 + 1e-6) + 1e-9
        md.obj = {int(lay.x[e]): 1.0 for e in range(len(lay.edges))}
        st2, z2, info2 = md.solve(opts.time_limit, opts.mip_rel_gap,
                                  opts.verbose, phase="port_min")
        if st2 in ("optimal", "time_limit") and z2 is not None:
            r2 = _extract(dag, md, lay, z2, st2, time.time() - tp,
                          {**result.stats, "phase2": info2})
            r2.port_min_applied = True
            # keep phase-1 makespan (phase 2 only reduces ports)
            r2.makespan = min(result.makespan, r2.makespan) \
                if np.isfinite(r2.makespan) else result.makespan
            r2.solve_time = result.solve_time + r2.solve_time
            return r2
    return result


# ------------------------------------------------------------- DELTA-Robust
@dataclass
class RobustMILPResult:
    """Shared-x multi-member MILP solution."""

    x: np.ndarray                  # (P, P) the one shared topology
    makespans: np.ndarray          # (M,) per-member schedule makespans
    objective: str                 # weighted | max-regret
    objective_value: float
    status: str
    solve_time: float
    members: list[MILPResult] = field(default_factory=list)
    refs: np.ndarray | None = None
    stats: dict = field(default_factory=dict)

    @property
    def feasible(self) -> bool:
        # same finite guard as MILPResult: a budget expiry without an
        # incumbent must read infeasible, not silently valid
        return self.status in ("optimal", "feasible", "time_limit") \
            and bool(np.isfinite(self.makespans).all())

    @property
    def total_ports(self) -> int:
        return int(self.x.sum())


def solve_robust_milp(ensemble: DagEnsemble,
                      opts: MILPOptions | None = None,
                      objective: str = "weighted",
                      refs: np.ndarray | None = None) -> RobustMILPResult:
    """One shared port allocation, one schedule block per ensemble member.

    The Eq. 5-7 topology variables (x_e over the *union* of the members'
    active pairs, plus the binary expansion) are built once; every member
    then contributes its own Eq. 8-18 task/interval block (with its own
    per-member `task_time_index_pruning` windows and time grid) wired to
    the shared beta bits.  Objectives:

      weighted   : minimize sum_m w_m * C^m
      max-regret : minimize Z subject to Z >= C^m / refs_m (epigraph)

    `refs` (per-member reference makespans, e.g. the members' best
    single-DAG plans) are required for max-regret; when omitted they are
    computed by per-member `solve_delta_milp` runs with the same options.
    `opts.seed_x` (e.g. a delta-robust GA incumbent) adds a valid
    objective-level incumbent cut from its per-member DES makespans.
    `opts.port_min` runs the usual lexicographic second phase at a fixed
    objective value.
    """
    opts = opts or MILPOptions()
    if objective not in ("weighted", "max-regret"):
        raise ValueError(f"unknown objective {objective!r}")
    t0 = time.time()
    weights = np.asarray(ensemble.weights, dtype=np.float64)

    if refs is None and objective == "max-regret":
        single_opts = dataclasses.replace(opts, port_min=False, seed_x=None)
        refs = np.array([solve_delta_milp(m, single_opts).makespan
                         for m in ensemble.members])
    if refs is not None:
        refs = np.asarray(refs, dtype=np.float64)
        if refs.shape != (ensemble.num_members,):
            raise ValueError("refs must have one entry per member")
        if objective == "max-regret" and not (
                np.isfinite(refs) & (refs > 0)).all():
            raise ValueError(f"max-regret needs finite positive refs: {refs}")

    # per-member pruning profiles + the union topology bound
    problems = [DESProblem(m) for m in ensemble.members]
    windows_m: list[IndexWindows] = []
    t_up_m: list[float] = []
    xbar_u = None
    for dag_m, problem in zip(ensemble.members, problems):
        _, anchors, K_prof = profile_anchors(problem)
        if opts.seed_x is not None:
            # same guard as solve_delta_milp: the seed's objective cut
            # below is only attainable if the pruned windows can express
            # a schedule under the seed topology, so re-profile from it
            # (K keeps the baseline profile as a floor)
            with contextlib.suppress(RuntimeError):
                # an infeasible seed on this member keeps the default
                _, sa, sk = profile_anchors(problem,
                                            np.asarray(opts.seed_x))
                anchors, K_prof = sa, max(sk, K_prof)
        t_up = opts.t_up or estimate_t_up(problem)
        K = opts.K or (K_prof + opts.k_slack)
        anchors_used = anchors if opts.prune else None
        windows_m.append(task_time_index_pruning(
            dag_m, K, anchors_used, anchor_margin=opts.anchor_margin))
        t_up_m.append(t_up)
        xbar = opts.xbar if opts.xbar is not None else \
            x_upper_bound(dag_m, t_up=t_up)
        xbar_u = xbar if xbar_u is None else np.maximum(xbar_u, xbar)

    with span("milp.build", members=ensemble.num_members):
        md = _Model()
        edges = ensemble.undirected_pairs()
        xv, beta, Lbits, edge_of = _build_topology(md, ensemble.cluster,
                                                   edges, xbar_u)
        lays = [_build_member(md, dag_m, opts.fairness, win, t_up, edges,
                              edge_of, xv, beta, Lbits)
                for dag_m, win, t_up in zip(ensemble.members, windows_m,
                                            t_up_m)]

    # ---- objective
    if objective == "weighted":
        md.obj = {int(lay.C): float(w) for lay, w in zip(lays, weights)}
        obj_of = lambda z: float(sum(      # noqa: E731 - local reducer
            w * z[lay.C] for lay, w in zip(lays, weights)))
    else:
        z_ub = max(t / r for t, r in zip(t_up_m, refs))
        Z = md.var(0.0, float(z_ub))
        for lay, r in zip(lays, refs):
            md.row({Z: float(r), int(lay.C): -1.0}, 0.0, np.inf)
        # epsilon tie-break on the member makespans: the epigraph objective
        # alone leaves every non-binding C^m floating up to Z * ref_m
        eps = 1e-5
        md.obj = {Z: 1.0, **{int(lay.C): eps * float(w) / float(r)
                             for lay, w, r in zip(lays, weights, refs)}}
        obj_of = lambda z: float(z[Z])     # noqa: E731 - local reducer

    # ---- incumbent cut from a seed topology (GA result): its per-member
    # fair-share DES makespans are simultaneously achievable by one x, so
    # bounding the *objective* (never the individual C^m) is valid
    if opts.seed_x is not None:
        seed_ms = np.array([simulate(p, np.asarray(opts.seed_x)).makespan
                            for p in problems])
        if np.isfinite(seed_ms).all():
            slack = (1 + 1e-6)
            if objective == "weighted":
                cut = float(weights @ seed_ms) * slack + 1e-9
                md.row({int(lay.C): float(w)
                        for lay, w in zip(lays, weights)}, -np.inf, cut)
            else:
                md.ub[Z] = min(md.ub[Z],
                               float((seed_ms / refs).max()) * slack + 1e-9)
    prep_time = time.time() - t0

    ts = time.time()
    status, z, info = md.solve(opts.time_limit, opts.mip_rel_gap,
                               opts.verbose)
    solve_time = time.time() - ts
    P = ensemble.cluster.num_pods
    stats = {**info, "prep_time": prep_time,
             "K": [w.K for w in windows_m]}
    if z is None:
        return RobustMILPResult(
            x=np.zeros((P, P), dtype=np.int64),
            makespans=np.full(ensemble.num_members, np.inf),
            objective=objective, objective_value=np.inf, status=status,
            solve_time=solve_time, refs=refs, stats=stats)

    if opts.port_min:
        # lexicographic phase 2: fix the objective, minimize total circuits
        if objective == "weighted":
            md.row({int(lay.C): float(w)
                    for lay, w in zip(lays, weights)}, -np.inf,
                   obj_of(z) * (1 + 1e-6) + 1e-9)
        else:
            md.ub[Z] = obj_of(z) * (1 + 1e-6) + 1e-9
        md.obj = {int(xv[e]): 1.0 for e in range(len(edges))}
        st2, z2, info2 = md.solve(opts.time_limit, opts.mip_rel_gap,
                                  opts.verbose, phase="port_min")
        if st2 in ("optimal", "time_limit") and z2 is not None:
            status, z = st2, z2
            stats["phase2"] = info2

    members = [_extract(dag_m, md, lay, z, status, solve_time, {})
               for dag_m, lay in zip(ensemble.members, lays)]
    makespans = np.array([m.makespan for m in members])
    return RobustMILPResult(
        x=members[0].x, makespans=makespans, objective=objective,
        objective_value=obj_of(z), status=status, solve_time=solve_time,
        members=members, refs=refs, stats=stats)


# ----------------------------------------------------------- DELTA-Failsafe
def result_from_topology(dag: CommDAG, x: np.ndarray,
                         mask: np.ndarray | None = None,
                         status: str = "feasible") -> MILPResult:
    """Build a `validate_solution`-clean MILPResult from a topology.

    Runs the exact numpy DES with rate recording and converts its trace
    into the MILP's schedule encoding: `t` is the DES event grid, `w[(m,k)]`
    the volume task m moved inside interval k (each trace segment spans
    exactly one event interval), `start`/`finish` the DES task times.  With
    `mask`, capacity is degraded (`x * mask`) while the reported topology
    stays the integer circuit matrix -- real capacities only shrink, so the
    schedule still satisfies the nominal Eq. 9 link caps.  This is how the
    fallback chain always returns a *valid* plan even when no solver does.
    """
    problem = DESProblem(dag)
    x = np.asarray(x)
    x_int = np.rint(x).astype(np.int64)
    x_eff = x.astype(np.float64) * np.asarray(mask) if mask is not None \
        else x
    res = simulate(problem, x_eff, record_rates=True)
    n = dag.num_tasks
    if not res.feasible or not np.isfinite(res.makespan):
        return MILPResult(
            x=x_int, makespan=np.inf, status="infeasible", solve_time=0.0,
            start=np.zeros(n), finish=np.zeros(n), t=np.zeros(1),
            total_ports=int(x_int.sum()),
            stats={"from_topology": True, "masked": mask is not None})
    events = res.events
    w: dict[tuple[int, int], float] = {}
    for t0, t1, rates in res.rate_trace:
        if t1 <= t0:
            continue
        k = int(np.searchsorted(events, t0 + 1e-15, side="right"))
        k = min(max(k, 1), len(events) - 1)
        for m in np.nonzero(rates > 0)[0]:
            key = (int(m), k)
            w[key] = w.get(key, 0.0) + float(rates[m]) * (t1 - t0)
    y = {key: 1 for key in w}
    return MILPResult(
        x=x_int, makespan=float(res.makespan), status=status,
        solve_time=0.0, start=res.start, finish=res.finish, t=events,
        w=w, y=y, total_ports=int(x_int.sum()),
        stats={"from_topology": True, "masked": mask is not None})


def solve_resilient(dag: CommDAG, opts: MILPOptions | None = None, *,
                    budget_s: float | None = None, retries: int = 1,
                    backoff_s: float = 0.05,
                    ga_options=None,
                    current_x: np.ndarray | None = None,
                    mask: np.ndarray | None = None) -> MILPResult:
    """MILP solve with a wall-clock budget, retry/backoff on solver
    exceptions, and a graceful fallback chain that ALWAYS returns a valid
    plan:

      1. `solve_delta_milp` under the remaining budget (retried with
         backoff on exceptions; a budget expiry without an incumbent reads
         infeasible via the finite-makespan guard and falls through),
      2. a GA incumbent (`delta_fast`) converted to a schedule by
         `result_from_topology`,
      3. the current plan `current_x` with failed links masked (one
         circuit everywhere if no current plan exists).

    Fallback results carry `degraded=True` + `fallback_stage`, and every
    stage transition increments `fleet_fallbacks_total{stage=...}`.
    """
    opts = opts or MILPOptions()
    budget = float(budget_s) if budget_s is not None else opts.time_limit
    t0 = time.time()
    last_error: str | None = None

    for attempt in range(max(int(retries), 0) + 1):
        remaining = budget - (time.time() - t0)
        if remaining <= 0:
            _FALLBACKS.inc(stage="milp_budget")
            break
        try:
            run_opts = dataclasses.replace(
                opts, time_limit=min(opts.time_limit, remaining))
            result = solve_delta_milp(dag, run_opts)
        except Exception as exc:
            last_error = f"{type(exc).__name__}: {exc}"
            _FALLBACKS.inc(stage="milp_retry")
            if attempt < retries:
                time.sleep(min(backoff_s * (2 ** attempt), remaining))
            continue
        if result.feasible:
            result.stats.setdefault("resilient", {}).update(
                attempts=attempt + 1, budget_s=budget)
            return result
        last_error = f"status={result.status}"
        break
    _FALLBACKS.inc(stage="milp")

    # ---- stage 2: GA incumbent.  Not guarded: the GA runs on the device,
    # and a missing device or a failed kernel raises out of here rather
    # than hand the caller a stage-3 plan
    ga = delta_fast(dag, ga_options)
    if ga.feasible:
        res = result_from_topology(dag, ga.x, status="feasible")
        if res.feasible:
            res.degraded = True
            res.fallback_stage = "ga"
            res.stats["resilient"] = {"milp_error": last_error,
                                      "budget_s": budget}
            _FALLBACKS.inc(stage="ga")
            return res

    # ---- stage 3: the current plan, failed links masked
    if current_x is None:
        P = dag.cluster.num_pods
        current_x = np.zeros((P, P), dtype=np.int64)
        for (i, j) in dag.undirected_pairs():
            current_x[i, j] = current_x[j, i] = 1
    res = result_from_topology(dag, current_x, mask=mask, status="feasible")
    res.degraded = True
    res.fallback_stage = "current"
    res.stats["resilient"] = {"milp_error": last_error, "budget_s": budget}
    _FALLBACKS.inc(stage="current")
    return res


def validate_solution(dag: CommDAG, res: MILPResult, tol: float = 1e-5
                      ) -> list[str]:
    """Independent feasibility check of a MILP schedule (unit-scaled)."""
    errors: list[str] = []
    B = dag.cluster.nic_bandwidth
    # conservation
    vol_sent = {m: 0.0 for m in range(1, dag.num_tasks)}
    for (m, _k), v in res.w.items():
        vol_sent[m] += v
    for t_ in dag.real_tasks():
        if abs(vol_sent[t_.tid] - t_.volume) > tol * max(t_.volume, 1.0):
            errors.append(f"conservation task {t_.tid}")
    # precedence
    for d in dag.deps:
        pre_c = 0.0 if d.pre == VIRTUAL else res.finish[d.pre]
        if res.start[d.succ] + tol < pre_c + d.delta - 1e-9:
            errors.append(f"precedence {d.pre}->{d.succ}")
    # port budgets
    U = dag.cluster.port_limits
    for p in range(dag.cluster.num_pods):
        if res.x[p].sum() > U[p]:
            errors.append(f"ports pod {p}")
    # link capacity per interval: aggregate volume over all tasks sharing
    # an ordered pod pair must fit the pair's circuits (Eq. 9)
    t = res.t
    agg: dict[tuple[tuple[int, int], int], float] = {}
    for (m, k), v in res.w.items():
        agg_key = (dag.tasks[m].pair, k)
        agg[agg_key] = agg.get(agg_key, 0.0) + v
    for (pair, k), v in agg.items():
        dt = t[k] - t[k - 1]
        cap = res.x[pair] * B * dt
        if v > cap * (1 + 1e-6) + tol * VOL:
            errors.append(f"link cap pair {pair} interval {k}")
    # NIC injection/reception per equivalence class & interval (Eq. 10):
    # sum_m w_{m,k} / F_m <= B * Delta_k for every GPU's task set
    src_classes, dst_classes = dag.nic_classes()
    flows = dag.flows()
    w_of_task: dict[int, list[tuple[int, float]]] = {}
    for (m, k), v in res.w.items():
        w_of_task.setdefault(m, []).append((k, v))
    for side, classes in (("src", src_classes), ("dst", dst_classes)):
        for ci, (tids, mult) in enumerate(classes):
            per_k: dict[int, float] = {}
            for m in tids:
                for k, v in w_of_task.get(m, ()):
                    per_k[k] = per_k.get(k, 0.0) + v / flows[m]
            for k, v in per_k.items():
                dt = t[k] - t[k - 1]
                if v > B * dt * mult * (1 + 1e-6) + tol * VOL:
                    errors.append(f"nic {side} class {ci} interval {k}")
    return errors
