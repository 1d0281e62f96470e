"""A frozen copy of the plain discrete-event simulator, at three precisions.

The fluid model of the paper's DES (Sec. IV-B): tasks start when every
dependency's lag has passed, run at weighted max-min fair rates (per-flow
rate phi_m, task rate r_m = F_m * phi_m) under the link constraints
sum r_m <= x_ij * B (Eq. 9) and the NIC constraints sum phi_m <= B
(Eq. 10), and the makespan is the last completion.  ``ideal=True`` drops
the link constraints: the non-blocking network that defines the NCT's
denominator.

At `FLOAT64` this is the plain simulator, operation for operation, with
its own bands (a start lands when its ready time is within 1e-15 s, a task
completes when less than 1e-9 of its volume is left).  `FLOAT32` and
`BFLOAT16` are the same computation in a lower precision, for the
benchmark's controls: every array is float32, and at `BFLOAT16` every
arithmetic result is rounded to bfloat16 (ties to even; sums accumulate in
float32 and are rounded once).  Their bands follow the precision, as a
float32 engine's must: a start lands within a relative band of the clock,
and a task completes when its remaining volume, or its remaining time at
the current rate, falls below the precision's resolution, without which
`t + dt == t` would stall the clock.
"""
from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import numpy as np

from reference.dag import RawDag

INF = float("inf")


def to_bfloat16(a):
    """float32 values rounded to the nearest bfloat16 (ties to even), kept
    as float32; infinities and NaNs pass through."""
    a32 = np.asarray(a, dtype=np.float32)
    bits = a32.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    out = np.where(np.isfinite(a32), bits.astype(np.uint32).view(np.float32),
                   a32)
    return out if out.ndim else out[()]


def _same(a):
    return a


@dataclass(frozen=True)
class Precision:
    name: str
    dtype: type
    round: Callable
    ready_rel: float      # a start lands at ready <= t * (1 + rel) + abs
    ready_abs: float
    done_volume: float    # completion: remaining volume below this share
    done_time: float      # ... or remaining time below this share of t
    freeze_rel: float     # filling freezes a constraint at alpha_c <=
    freeze_abs: float     # alpha * (1 + rel) + abs


FLOAT64 = Precision("float64", np.float64, _same, 0.0, 1e-15, 1e-9, 0.0,
                    1e-9, 1e-18)
# the float32 engine's bands (start 1e-6 of the clock, completion 1e-5 of
# the volume or of the clock)
FLOAT32 = Precision("float32", np.float32, _same, 1e-6, 1e-9, 1e-5, 1e-5,
                    1e-6, 0.0)
# bfloat16 keeps 8 significant bits (unit roundoff 2**-8): bands of a few
# units of its last place
BFLOAT16 = Precision("bfloat16", np.float32, to_bfloat16, 2.0 ** -7, 1e-9,
                     2.0 ** -6, 2.0 ** -6, 2.0 ** -7, 0.0)
PRECISIONS = {p.name: p for p in (FLOAT64, FLOAT32, BFLOAT16)}


class Problem:
    """The simulator's arrays for one DAG: dependency CSRs by successor
    and by predecessor, and the constraint-task incidence as CSR (links of
    the active pod pairs first, then the NIC classes)."""

    def __init__(self, dag: RawDag):
        self.dag = dag
        n = dag.n
        self.n = n
        self.volume = np.asarray(dag.volume, dtype=np.float64)
        self.flows = dag.flow_weights()
        self.B = float(dag.nic_bandwidth)
        self.pairs = dag.pod_pairs()
        parr = np.asarray(self.pairs, dtype=np.int64).reshape(-1, 2)
        self.pair_src, self.pair_dst = parr[:, 0], parr[:, 1]

        pre = np.asarray(dag.dep_pre, dtype=np.int64)
        succ = np.asarray(dag.dep_succ, dtype=np.int64)
        delta = np.asarray(dag.dep_delta, dtype=np.float64)
        order = np.argsort(succ, kind="stable")
        self.dep_pre, self.dep_succ = pre[order], succ[order]
        self.dep_delta = delta[order]
        self.pred_ptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(self.pred_ptr, self.dep_succ + 1, 1)
        self.pred_ptr = np.cumsum(self.pred_ptr)
        self.indegree = np.diff(self.pred_ptr)
        order2 = np.argsort(pre, kind="stable")
        self.succ_ptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(self.succ_ptr, pre[order2] + 1, 1)
        self.succ_ptr = np.cumsum(self.succ_ptr)
        self.succ_tid = succ[order2]

        members: list[np.ndarray] = []
        weights: list[np.ndarray] = []
        on_pair = dag.tasks_on_pair()
        for p in self.pairs:
            tids = np.array(on_pair[p], dtype=np.int64)
            members.append(tids)
            weights.append(self.flows[tids])
        self.num_link_cons = len(self.pairs)
        src_classes, dst_classes = dag.nic_classes()
        for tids in src_classes + dst_classes:
            members.append(np.array(tids, dtype=np.int64))
            weights.append(np.ones(len(tids)))
        self.num_cons = len(members)
        self.con_ptr = np.zeros(self.num_cons + 1, dtype=np.int64)
        for i, mm in enumerate(members):
            self.con_ptr[i + 1] = self.con_ptr[i] + len(mm)
        self.con_task = np.concatenate(members) if members else \
            np.zeros(0, dtype=np.int64)
        self.con_w = np.concatenate(weights) if weights else np.zeros(0)
        self._at: dict[str, dict[str, np.ndarray]] = {}

    def at(self, pr: Precision) -> dict[str, np.ndarray]:
        """The float arrays in `pr`'s type, each value rounded once."""
        got = self._at.get(pr.name)
        if got is None:
            got = {k: pr.round(np.asarray(v, dtype=pr.dtype)) for k, v in (
                ("volume", self.volume), ("flows", self.flows),
                ("con_w", self.con_w), ("dep_delta", self.dep_delta),
                ("B", np.array([self.B])))}
            self._at[pr.name] = got
        return got

    def link_caps(self, x: np.ndarray, ideal: bool, pr: Precision
                  ) -> np.ndarray:
        a = self.at(pr)
        B = a["B"][0]
        caps = np.full(self.num_cons, B, dtype=pr.dtype)
        if ideal:
            caps[:self.num_link_cons] = INF
        else:
            caps[:self.num_link_cons] = pr.round(np.asarray(x)[
                self.pair_src, self.pair_dst].astype(pr.dtype) * B)
        return caps


def maxmin_fair_rates(problem: Problem, active: np.ndarray, caps: np.ndarray,
                      pr: Precision = FLOAT64) -> np.ndarray:
    """Weighted max-min fair task rates by progressive filling: raise phi
    of every unfrozen active task alike until a constraint saturates,
    freeze its tasks, repeat.  0 for inactive tasks."""
    r = pr.round
    a = problem.at(pr)
    n = problem.n
    phi = np.zeros(n, dtype=pr.dtype)
    unfrozen = active.copy()
    ct, cw, cp = problem.con_task, a["con_w"], problem.con_ptr
    act_w = np.where(active[ct], cw, 0.0).astype(pr.dtype)

    for _ in range(problem.num_cons + 1):
        if not unfrozen.any():
            break
        unf_w = np.where(unfrozen[ct], cw, 0.0).astype(pr.dtype)
        used = r(np.add.reduceat(r(act_w * phi[ct]), cp[:-1])) \
            if len(ct) else np.zeros(0, dtype=pr.dtype)
        denom = r(np.add.reduceat(unf_w, cp[:-1])) if len(ct) \
            else np.zeros(0, dtype=pr.dtype)
        empty = cp[:-1] == cp[1:]
        used[empty] = 0.0
        denom[empty] = 0.0
        slack = r(caps - used)
        with np.errstate(divide="ignore", invalid="ignore"):
            alpha_c = np.where(denom > 0, r(slack / denom), INF)
        alpha = alpha_c.min() if len(alpha_c) else INF
        if not np.isfinite(alpha):
            break
        alpha = max(alpha, 0.0)
        phi[unfrozen] = r(phi[unfrozen] + alpha)
        sat = np.isfinite(alpha_c) & (
            alpha_c <= alpha * (1 + pr.freeze_rel) + pr.freeze_abs)
        if not sat.any():
            break
        for ci in np.nonzero(sat)[0]:
            unfrozen[ct[cp[ci]:cp[ci + 1]]] = False
    return r(r(a["flows"] * phi) * active)


@dataclass
class Result:
    start: np.ndarray
    finish: np.ndarray
    makespan: float
    feasible: bool
    crit_delta: float = 0.0

    @property
    def comm_time(self) -> float:
        """Inter-pod communication time on the critical path."""
        return self.makespan - self.crit_delta


def simulate(problem: Problem, x: np.ndarray, ideal: bool = False,
             pr: Precision = FLOAT64, max_events: int | None = None
             ) -> Result:
    """Run the DES for the symmetric topology `x` (circuits per pod pair)."""
    r = pr.round
    a = problem.at(pr)
    vol, dep_delta = a["volume"], a["dep_delta"]
    pred_ptr, dep_pre = problem.pred_ptr, problem.dep_pre
    succ_ptr, succ_tid = problem.succ_ptr, problem.succ_tid
    n = problem.n
    caps = problem.link_caps(np.asarray(x), ideal, pr)
    rem = vol.copy()
    start = np.full(n, INF, dtype=pr.dtype)
    finish = np.full(n, INF, dtype=pr.dtype)
    ready_at = np.full(n, INF, dtype=pr.dtype)
    missing = problem.indegree.copy()
    started = np.zeros(n, dtype=bool)
    done = np.zeros(n, dtype=bool)

    def complete(m: int, t) -> None:
        done[m] = True
        finish[m] = t
        for k in range(succ_ptr[m], succ_ptr[m + 1]):
            s = succ_tid[k]
            missing[s] -= 1
            if missing[s] == 0 and not started[s]:
                ready_at[s] = max(r(finish[dep_pre[j]] + dep_delta[j])
                                  for j in range(pred_ptr[s], pred_ptr[s + 1]))

    t = pr.dtype(0.0)
    start[0] = 0.0
    started[0] = True
    complete(0, t)
    for m in range(1, n):
        if problem.indegree[m] == 0:
            ready_at[m] = 0.0

    feasible = True
    for _ in range(max_events or (4 * n + 8)):
        newly = (~started) & (missing == 0) & (
            ready_at <= t * (1 + pr.ready_rel) + pr.ready_abs)
        if newly.any():
            idx = np.nonzero(newly)[0]
            started[idx] = True
            start[idx] = np.maximum(ready_at[idx], 0.0)
            for m in idx:
                if rem[m] <= 0.0:
                    complete(m, t)
        if done.all():
            break
        active = started & ~done
        if active.any():
            rates = maxmin_fair_rates(problem, active, caps, pr)
            act_idx = np.nonzero(active)[0]
            if (rates[act_idx] <= 0).any():
                feasible = False        # a pair with no circuit
                break
            dt_done = r(rem[act_idx] / rates[act_idx])
            t_complete = r(t + dt_done.min())
        else:
            rates = np.zeros(n, dtype=pr.dtype)
            t_complete = INF
        pending = (~started) & (missing == 0)
        t_ready = ready_at[pending].min() if pending.any() else INF
        t_next = min(t_complete, t_ready)
        if not np.isfinite(t_next):
            feasible = False            # deadlock: nothing active or ready
            break
        dt = r(t_next - t)
        if active.any() and dt > 0:
            rem[active] = np.maximum(
                r(rem[active] - r(rates[active] * dt)), 0.0)
        t = t_next
        for m in np.nonzero(active)[0]:
            if rem[m] <= pr.done_volume * max(vol[m], 1.0) or (
                    pr.done_time and r(rem[m] / rates[m]) <= pr.done_time * t):
                rem[m] = 0.0
                complete(m, t)
    else:
        feasible = False

    if not feasible:
        return Result(start=start, finish=finish, makespan=INF,
                      feasible=False)
    makespan = float(np.nanmax(np.where(np.isfinite(finish), finish,
                                        np.nan)))
    return Result(start=start, finish=finish, makespan=makespan,
                  feasible=True,
                  crit_delta=_crit_delta(problem, finish, dep_delta))


def _crit_delta(problem: Problem, finish: np.ndarray,
                dep_delta: np.ndarray) -> float:
    """Sum of the rigid lags along the binding chain, backtracked from the
    last-finishing task: the makespan less this is the communication time
    on the critical path."""
    cur = int(np.argmax(np.where(np.isfinite(finish), finish, -INF)))
    delta_sum = 0.0
    guard = 0
    while cur != 0 and guard <= problem.n + 1:
        guard += 1
        lo, hi = problem.pred_ptr[cur], problem.pred_ptr[cur + 1]
        if lo == hi:
            break
        best_j, best_v = -1, -INF
        for j in range(lo, hi):
            v = finish[problem.dep_pre[j]] + dep_delta[j]
            if v > best_v:
                best_v, best_j = v, j
        delta_sum += float(dep_delta[best_j])
        cur = int(problem.dep_pre[best_j])
    return delta_sum


def ideal_run(problem: Problem, pr: Precision = FLOAT64) -> Result:
    P = problem.dag.num_pods
    return simulate(problem, np.zeros((P, P)), ideal=True, pr=pr)
