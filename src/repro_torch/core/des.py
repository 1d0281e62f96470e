"""Discrete-event simulator for inter-pod communication DAGs (numpy ref).

This is the lightweight DES engine of paper Sec. IV-B: it chronologically
executes the reduced inter-pod DAG over a *fixed* logical topology, resolving
bandwidth contention with weighted max-min fair sharing (the conventional
fair-share policy of Eq. 17), and yields

  * per-task start/completion times (S_m, C_m) and the iteration makespan C,
  * the event timeline (the variable-length intervals of the MILP -- the DES
    trace is isomorphic to the MILP's event-driven formulation),
  * the critical path and the Normalized Communication Time (NCT) inputs.

Rate semantics (fluid model):
  per-flow rate phi_m, task rate r_m = F_m * phi_m, subject to
    link (i,j):  sum_{m in M_ij} r_m              <= x_ij * B       (Eq. 9)
    NIC class :  sum_{m at GPU g} phi_m           <= B              (Eq. 10)
  `ideal=True` drops the link constraints (ideal non-blocking electrical
  network), which defines the NCT denominator.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.dag import VIRTUAL, CommDAG
from repro_torch.obs.tracing import span

INF = float("inf")


# --------------------------------------------------------------------- setup
class DESProblem:
    """Precomputed arrays for repeated simulation of one CommDAG."""

    def __init__(self, dag: CommDAG):
        with span("des.problem", tasks=dag.num_tasks, deps=len(dag.deps)):
            self._build(dag)

    def _build(self, dag: CommDAG) -> None:
        self.dag = dag
        n = dag.num_tasks
        self.n = n
        self.volume = dag.volumes()
        self.flows = dag.flows()
        self.B = dag.cluster.nic_bandwidth

        # ordered pod pairs with traffic
        self.pairs = dag.pod_pairs()
        parr = np.asarray(self.pairs, dtype=np.int64).reshape(-1, 2)
        self.pair_src = parr[:, 0]
        self.pair_dst = parr[:, 1]
        self.pair_index = {p: i for i, p in enumerate(self.pairs)}
        self.task_pair = np.full(n, -1, dtype=np.int64)
        for t in dag.real_tasks():
            self.task_pair[t.tid] = self.pair_index[t.pair]

        # dependency CSR (by successor)
        pre, succ, delta = dag.dep_arrays()
        order = np.argsort(succ, kind="stable")
        self.dep_pre = pre[order]
        self.dep_succ = succ[order]
        self.dep_delta = delta[order]
        self.pred_ptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(self.pred_ptr, self.dep_succ + 1, 1)
        self.pred_ptr = np.cumsum(self.pred_ptr)
        self.indegree = np.diff(self.pred_ptr)

        # successor CSR (by predecessor) for readiness propagation
        order2 = np.argsort(pre, kind="stable")
        self.succ_ptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(self.succ_ptr, pre[order2] + 1, 1)
        self.succ_ptr = np.cumsum(self.succ_ptr)
        self.succ_tid = succ[order2]
        self.succ_delta = delta[order2]

        # constraints: [links..., nic_src..., nic_dst...] as incidence CSR
        members: list[np.ndarray] = []
        weights: list[np.ndarray] = []
        tasks_on = dag.tasks_on_pair()
        for p in self.pairs:
            tids = np.array(tasks_on[p], dtype=np.int64)
            members.append(tids)
            weights.append(self.flows[tids])          # r = F * phi
        self.num_link_cons = len(self.pairs)
        src_classes, dst_classes = dag.nic_classes()
        for tids, _ in src_classes + dst_classes:
            arr = np.array(tids, dtype=np.int64)
            members.append(arr)
            weights.append(np.ones(len(arr)))
        self.num_cons = len(members)
        self.con_ptr = np.zeros(self.num_cons + 1, dtype=np.int64)
        for i, mm in enumerate(members):
            self.con_ptr[i + 1] = self.con_ptr[i] + len(mm)
        self.con_task = np.concatenate(members) if members else \
            np.zeros(0, dtype=np.int64)
        self.con_w = np.concatenate(weights) if weights else np.zeros(0)

    def link_caps(self, x: np.ndarray, ideal: bool = False) -> np.ndarray:
        """Capacity vector for all constraints given topology matrix x."""
        caps = np.full(self.num_cons, float(self.B))
        if ideal:
            caps[:self.num_link_cons] = INF
        else:
            caps[:self.num_link_cons] = np.asarray(x)[
                self.pair_src, self.pair_dst].astype(np.float64) * self.B
        return caps


def maxmin_fair_rates(problem: DESProblem, active: np.ndarray,
                      caps: np.ndarray) -> np.ndarray:
    """Weighted max-min fair per-flow rates phi for the active tasks.

    Progressive filling: raise phi uniformly for all unfrozen active tasks
    until a constraint saturates; freeze its tasks; repeat.
    Returns task rates r_m = F_m * phi_m (0 for inactive tasks).
    """
    n = problem.n
    phi = np.zeros(n)
    unfrozen = active.copy()
    ct, cw, cp = problem.con_task, problem.con_w, problem.con_ptr
    act_w = np.where(active[ct], cw, 0.0)

    for _ in range(problem.num_cons + 1):
        if not unfrozen.any():
            break
        unf_w = np.where(unfrozen[ct], cw, 0.0)
        used = np.add.reduceat(act_w * phi[ct], cp[:-1]) \
            if len(ct) else np.zeros(0)
        denom = np.add.reduceat(unf_w, cp[:-1]) if len(ct) else np.zeros(0)
        # reduceat on empty segments returns the next element; zero them out
        empty = cp[:-1] == cp[1:]
        used[empty] = 0.0
        denom[empty] = 0.0
        slack = caps - used
        with np.errstate(divide="ignore", invalid="ignore"):
            alpha_c = np.where(denom > 0, slack / denom, INF)
        alpha = alpha_c.min() if len(alpha_c) else INF
        if not np.isfinite(alpha):
            break
        alpha = max(alpha, 0.0)
        phi[unfrozen] += alpha
        # freeze members of (near-)saturated constraints
        sat = np.isfinite(alpha_c) & (alpha_c <= alpha * (1 + 1e-9) + 1e-18)
        if not sat.any():
            break
        for ci in np.nonzero(sat)[0]:
            unfrozen[ct[cp[ci]:cp[ci + 1]]] = False
    return problem.flows * phi * active


# -------------------------------------------------------------------- result
@dataclass
class DESResult:
    start: np.ndarray
    finish: np.ndarray
    makespan: float
    feasible: bool
    events: np.ndarray                 # sorted state-transition times
    task_interval: np.ndarray          # (n, 2) [k_start, k_end] 1-based
    critical_path: list[int] = field(default_factory=list)
    crit_delta: float = 0.0
    rate_trace: list[tuple[float, float, np.ndarray]] = field(
        default_factory=list)

    @property
    def comm_time(self) -> float:
        """Inter-pod communication time on the critical path."""
        return self.makespan - self.crit_delta

    @property
    def num_intervals(self) -> int:
        return max(len(self.events) - 1, 0)


# ----------------------------------------------------------------- simulate
def simulate(problem: DESProblem, x: np.ndarray, ideal: bool = False,
             record_rates: bool = False, max_events: int | None = None
             ) -> DESResult:
    """Run the DES for topology matrix x (symmetric, circuits per pair)."""
    with span("des.host", ideal=ideal):
        return _simulate(problem, x, ideal, record_rates, max_events)


def _simulate(problem: DESProblem, x: np.ndarray, ideal: bool,
              record_rates: bool, max_events: int | None) -> DESResult:
    n = problem.n
    caps = problem.link_caps(np.asarray(x), ideal=ideal)
    rem = problem.volume.copy()
    start = np.full(n, INF)
    finish = np.full(n, INF)
    ready_at = np.full(n, INF)
    missing = problem.indegree.copy()
    started = np.zeros(n, dtype=bool)
    done = np.zeros(n, dtype=bool)

    def complete(m: int, t: float) -> None:
        done[m] = True
        finish[m] = t
        lo, hi = problem.succ_ptr[m], problem.succ_ptr[m + 1]
        for k in range(lo, hi):
            s = problem.succ_tid[k]
            missing[s] -= 1
            if missing[s] == 0 and not started[s]:
                # all predecessors done: exact ready time is the max lag
                lo2, hi2 = problem.pred_ptr[s], problem.pred_ptr[s + 1]
                ready_at[s] = max(
                    finish[problem.dep_pre[j]] + problem.dep_delta[j]
                    for j in range(lo2, hi2))

    # virtual source completes at t = 0
    t = 0.0
    start[VIRTUAL] = 0.0
    started[VIRTUAL] = True
    complete(VIRTUAL, 0.0)
    # tasks with no predecessors at all start at 0 (defensive; normally the
    # virtual task precedes everything)
    for m in range(1, n):
        if problem.indegree[m] == 0:
            ready_at[m] = 0.0

    events = [0.0]
    trace: list[tuple[float, float, np.ndarray]] = []
    limit = max_events or (4 * n + 8)
    feasible = True

    for _ in range(limit):
        # start every task whose ready time has arrived
        newly = (~started) & (missing == 0) & (ready_at <= t + 1e-15)
        if newly.any():
            idx = np.nonzero(newly)[0]
            started[idx] = True
            start[idx] = np.maximum(ready_at[idx], 0.0)
            # zero-volume tasks complete instantly
            for m in idx:
                if rem[m] <= 0.0:
                    complete(m, t)
        if done.all():
            break
        active = started & ~done
        if active.any():
            rates = maxmin_fair_rates(problem, active, caps)
            act_idx = np.nonzero(active)[0]
            if (rates[act_idx] <= 0).any():
                feasible = False  # disconnected pair under this topology
                break
            dt_done = rem[act_idx] / rates[act_idx]
            t_complete = t + dt_done.min()
        else:
            rates = np.zeros(n)
            t_complete = INF
        pending = (~started) & (missing == 0)
        t_ready = ready_at[pending].min() if pending.any() else INF
        t_next = min(t_complete, t_ready)
        if not np.isfinite(t_next):
            feasible = False  # deadlock: nothing active, nothing ready
            break
        if record_rates and active.any():
            trace.append((t, t_next, rates.copy()))
        dt = t_next - t
        if active.any() and dt > 0:
            rem[active] = np.maximum(rem[active] - rates[active] * dt, 0.0)
        t = t_next
        if t > events[-1] + 1e-15:
            events.append(t)
        # completions: active tasks whose remaining volume hit zero
        for m in np.nonzero(active)[0]:
            if rem[m] <= 1e-9 * max(problem.volume[m], 1.0):
                rem[m] = 0.0
                complete(m, t)
    else:
        feasible = False

    makespan = float(np.nanmax(np.where(np.isfinite(finish), finish, np.nan))) \
        if feasible else INF
    ev = np.array(events)
    task_interval = _intervals_of(ev, start, finish, n)
    crit, crit_delta = ([], 0.0)
    if feasible:
        crit, crit_delta = _critical_path(problem, start, finish)
    return DESResult(start=start, finish=finish, makespan=makespan,
                     feasible=feasible, events=ev,
                     task_interval=task_interval, critical_path=crit,
                     crit_delta=crit_delta, rate_trace=trace)


def _intervals_of(events: np.ndarray, start: np.ndarray, finish: np.ndarray,
                  n: int) -> np.ndarray:
    """1-based [k_start, k_end] interval indices of each task's active span.

    Interval k (1-based) spans [events[k-1], events[k]].
    """
    out = np.zeros((n, 2), dtype=np.int64)
    if len(events) < 2:
        return out
    for m in range(n):
        if not np.isfinite(start[m]) or not np.isfinite(finish[m]):
            continue
        ks = int(np.searchsorted(events, start[m] + 1e-15, side="right"))
        ke = int(np.searchsorted(events, finish[m] - 1e-15, side="left"))
        ks = min(max(ks, 1), len(events) - 1)
        ke = min(max(ke, ks), len(events) - 1)
        out[m] = (ks, ke)
    return out


def _critical_path(problem: DESProblem, start: np.ndarray,
                   finish: np.ndarray) -> tuple[list[int], float]:
    """Backtrack binding predecessors from the last-finishing task."""
    cur = int(np.argmax(np.where(np.isfinite(finish), finish, -INF)))
    path = [cur]
    delta_sum = 0.0
    guard = 0
    while cur != VIRTUAL and guard <= problem.n + 1:
        guard += 1
        lo, hi = problem.pred_ptr[cur], problem.pred_ptr[cur + 1]
        if lo == hi:
            break
        best_j, best_v = -1, -INF
        for j in range(lo, hi):
            v = finish[problem.dep_pre[j]] + problem.dep_delta[j]
            if v > best_v:
                best_v, best_j = v, j
        delta_sum += problem.dep_delta[best_j]
        cur = int(problem.dep_pre[best_j])
        path.append(cur)
    path.reverse()
    return path, delta_sum


# --------------------------------------------------------------------- NCT
@dataclass(frozen=True)
class NCTReport:
    makespan: float
    ideal_makespan: float
    comm_time: float
    ideal_comm_time: float

    @property
    def nct(self) -> float:
        if self.ideal_comm_time <= 0:
            return 1.0 if self.comm_time <= 0 else INF
        return self.comm_time / self.ideal_comm_time

    @property
    def stretch(self) -> float:
        """End-to-end slowdown vs the contention-free ideal (>= 1); the
        makespan analogue of `nct`."""
        if self.ideal_makespan <= 0:
            return 1.0 if self.makespan <= 0 else INF
        return self.makespan / self.ideal_makespan


def evaluate_nct(problem: DESProblem, x: np.ndarray,
                 ideal_result: DESResult | None = None) -> NCTReport:
    res = simulate(problem, x)
    ideal = ideal_result or simulate(problem, x, ideal=True)
    return NCTReport(makespan=res.makespan, ideal_makespan=ideal.makespan,
                     comm_time=res.comm_time,
                     ideal_comm_time=ideal.comm_time)


def makespan_of(problem: DESProblem, x: np.ndarray) -> float:
    return simulate(problem, x).makespan
