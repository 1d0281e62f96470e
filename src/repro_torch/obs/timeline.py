"""DES schedule timeline: Chrome-trace export + critical-path/slack report.

The paper's central observation is that non-critical tasks carry *temporal
slack* a topology optimizer can exploit (trim circuits where slack is
plentiful, add them where the critical path lives).  This module makes that
visible: a simulated plan (per-task start/finish times from the numpy DES,
optionally per-interval rates via ``record_rates=True``) becomes

  * a Chrome trace-event JSON (`schedule_timeline`) viewable in Perfetto --
    one track per directed inter-pod link carrying that link's tasks as
    complete (``X``) events, critical-path tasks color-coded, plus one
    counter (``C``) track per link showing its per-interval utilization
    (aggregate task rate / link capacity);
  * a critical-path + slack report (`slack_report`): per task the classic
    backward-pass slack (latest feasible finish minus realized finish under
    the realized durations), the binding critical path, and its identity
    ``max(finish) == makespan`` -- zero-slack chain == the DES makespan.

`validate_trace` is a minimal trace-event schema check used by the tests
and the CI smoke (the emitted file must stay loadable by Perfetto).
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.core import des
from repro_torch.core.dag import VIRTUAL, CommDAG

__all__ = ["interval_rate_matrices", "plane_rewire_timeline",
           "schedule_timeline", "slack_report", "task_slack",
           "validate_trace", "write_trace"]

INF = float("inf")

# Perfetto color-name palette: critical tasks pop out of the timeline
_COLOR_CRITICAL = "terrible"        # red
_COLOR_BY_KIND = {"pp_fwd": "thread_state_running",
                  "pp_bwd": "thread_state_runnable",
                  "dp": "rail_response",
                  "xattn": "rail_animation"}
_EP_COLOR = "generic_work"


def task_slack(dag: CommDAG, result: des.DESResult) -> np.ndarray:
    """Backward-pass temporal slack per task, on the *realized* schedule.

    With realized durations ``d_m = finish_m - start_m`` fixed, the latest
    feasible finish is ``LF_m = min over successors s of (LF_s - d_s -
    delta_{m->s})`` with ``LF = makespan`` at the sinks; slack is
    ``LF_m - finish_m``.  Critical tasks have (numerically) zero slack;
    the slack of everything else is exactly the paper's exploitable
    scheduling freedom.  Returns +inf for tasks that never ran.
    """
    n = dag.num_tasks
    finish = result.finish
    start = result.start
    if not result.feasible or not np.isfinite(result.makespan):
        return np.full(n, np.nan)
    dur = np.where(np.isfinite(finish) & np.isfinite(start),
                   finish - start, 0.0)
    LF = np.full(n, result.makespan)
    # reverse topological relaxation: iterate deps until a fixed point
    # (the DAG is small -- hundreds of tasks -- and acyclic, so bounded
    # by the longest chain; one vectorized np.minimum.at pass per round)
    pre, succ, delta = dag.dep_arrays()
    for _ in range(n + 1):
        cand = LF[succ] - dur[succ] - delta
        new = LF.copy()
        np.minimum.at(new, pre, cand)
        if np.allclose(new, LF, rtol=0, atol=1e-12):
            break
        LF = new
    slack = LF - finish
    slack[~np.isfinite(finish)] = INF
    return slack


def slack_report(dag: CommDAG, result: des.DESResult,
                 slack_tol: float = 1e-6) -> dict:
    """Critical-path + per-task slack summary of one simulated plan."""
    if not result.feasible:
        return {"feasible": False, "makespan": INF, "critical_path": [],
                "tasks": []}
    slack = task_slack(dag, result)
    crit = set(result.critical_path)
    rel = slack_tol * max(result.makespan, 1e-12)
    tasks = []
    for t in dag.real_tasks():
        m = t.tid
        if not np.isfinite(result.finish[m]):
            continue
        tasks.append({
            "tid": int(m), "kind": t.kind,
            "pair": [int(t.pair[0]), int(t.pair[1])],
            "volume_gb": float(t.volume) / 1e9,
            "start": float(result.start[m]),
            "finish": float(result.finish[m]),
            "slack": float(slack[m]),
            "critical": bool(m in crit or slack[m] <= rel)})
    zero_slack = [t["tid"] for t in tasks if t["slack"] <= rel]
    return {
        "feasible": True,
        "makespan": float(result.makespan),
        "comm_time": float(result.comm_time),
        "crit_delta": float(result.crit_delta),
        "critical_path": [int(m) for m in result.critical_path
                          if m != VIRTUAL],
        "zero_slack_tasks": zero_slack,
        "num_tasks": len(tasks),
        "mean_slack": float(np.mean([t["slack"] for t in tasks]))
        if tasks else 0.0,
        "tasks": tasks,
    }


def _link_name(pair: tuple[int, int]) -> str:
    return f"link {pair[0]}->{pair[1]}"


def interval_rate_matrices(problem: des.DESProblem, result: des.DESResult
                           ) -> list[tuple[float, float, np.ndarray]]:
    """Per DES interval, the aggregate (P, P) task-rate matrix (bytes/s).

    Requires a rate trace (``simulate(..., record_rates=True)``).  Entry
    ``mat[i, j]`` sums the fair-share rates of every task on directed pod
    pair (i, j) during [t0, t1) -- the ground truth a per-pair telemetry
    stream observes, and the source `repro_torch.fleet.telemetry` synthesizes
    samples from.
    """
    P = problem.dag.cluster.num_pods
    pairs = np.asarray(problem.pairs, dtype=np.int64).reshape(-1, 2)
    active = problem.task_pair >= 0
    out: list[tuple[float, float, np.ndarray]] = []
    for t0, t1, rates in result.rate_trace:
        per_link = np.zeros(len(problem.pairs))
        np.add.at(per_link, problem.task_pair[active],
                  np.asarray(rates)[active])
        mat = np.zeros((P, P))
        mat[pairs[:, 0], pairs[:, 1]] = per_link
        out.append((float(t0), float(t1), mat))
    return out


def schedule_timeline(dag: CommDAG, x: np.ndarray,
                      result: des.DESResult | None = None,
                      time_scale: float = 1e6) -> dict:
    """Chrome trace-event JSON of one plan's simulated schedule.

    One track (pid/tid pair) per directed inter-pod link; each task on the
    link is a complete event spanning [start, finish) with its kind,
    volume, flow count and slack in ``args``.  When the result carries a
    rate trace (``simulate(..., record_rates=True)``) each link also gets
    a counter track with its per-interval utilization.  ``time_scale``
    maps seconds to trace µs (default 1:1 -- trace µs == schedule µs).
    """
    problem = des.DESProblem(dag)
    if result is None:
        result = des.simulate(problem, np.asarray(x), record_rates=True)
    if not result.feasible:
        raise ValueError("cannot export a timeline for an infeasible plan")
    rep = slack_report(dag, result)
    by_tid = {t["tid"]: t for t in rep["tasks"]}

    events: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
         "args": {"name": f"{dag.cluster.num_pods}-pod schedule "
                          f"(makespan {result.makespan:.6f}s)"}}]
    track_of: dict[tuple[int, int], int] = {}
    for i, pair in enumerate(problem.pairs):
        track_of[pair] = i
        events.append({"name": "thread_name", "ph": "M", "pid": 0,
                       "tid": i, "args": {"name": _link_name(pair)}})
        events.append({"name": "thread_sort_index", "ph": "M", "pid": 0,
                       "tid": i, "args": {"sort_index": i}})

    for t in dag.real_tasks():
        row = by_tid.get(t.tid)
        if row is None:
            continue
        crit = row["critical"]
        cname = _COLOR_CRITICAL if crit else _COLOR_BY_KIND.get(
            t.kind, _EP_COLOR)
        events.append({
            "name": f"{t.kind}#{t.tid}", "ph": "X", "pid": 0,
            "tid": track_of[t.pair],
            "ts": row["start"] * time_scale,
            "dur": max(row["finish"] - row["start"], 0.0) * time_scale,
            "cname": cname,
            "args": {"tid": t.tid, "kind": t.kind,
                     "volume_gb": row["volume_gb"],
                     "flows": int(t.flows),
                     "slack_s": row["slack"],
                     "critical": crit}})

    # per-interval link utilization counters from the rate trace
    B = dag.cluster.nic_bandwidth
    xm = np.asarray(x)
    caps = {pair: float(xm[pair]) * B for pair in problem.pairs}
    for t0, _t1, mat in interval_rate_matrices(problem, result):
        for pair, li in track_of.items():
            cap = caps[pair]
            util = mat[pair] / cap if cap > 0 else 0.0
            events.append({
                "name": f"util {_link_name(pair)}", "ph": "C", "pid": 0,
                "tid": li, "ts": t0 * time_scale,
                "args": {"utilization": round(float(util), 6)}})
    # close the counter tracks at the makespan
    if result.rate_trace:
        for pair, li in track_of.items():
            events.append({
                "name": f"util {_link_name(pair)}", "ph": "C", "pid": 0,
                "tid": li, "ts": result.makespan * time_scale,
                "args": {"utilization": 0.0}})

    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"makespan_s": float(result.makespan),
                          "comm_time_s": float(result.comm_time),
                          "critical_path": rep["critical_path"],
                          "total_ports": int(np.asarray(x).sum())}}


def plane_rewire_timeline(steps, summary=None,
                          time_scale: float = 1e6) -> dict:
    """Chrome trace-event JSON of one staggered plane transition.

    One track per OCS plane; each `PlaneRewireStep` is a complete (``X``)
    event on its plane's track spanning that plane's dark window
    (``ts`` = cumulative reconfiguration delay of the preceding steps,
    ``dur`` = the step's own delay), rollback steps color-coded red.  A
    counter track charts the certified peak inflation the SLO check saw
    at every step.  Pass the transition's `PlaneTransitionSummary` to
    stamp the outcome into ``otherData``.
    """
    steps = list(steps)
    if not steps:
        raise ValueError("cannot export a timeline without steps")
    tname = steps[0].transition
    events: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
         "args": {"name": f"staggered transition {tname}"}}]
    for plane in sorted({s.plane for s in steps}):
        events.append({"name": "thread_name", "ph": "M", "pid": 0,
                       "tid": plane, "args": {"name": f"plane {plane}"}})
        events.append({"name": "thread_sort_index", "ph": "M", "pid": 0,
                       "tid": plane, "args": {"sort_index": plane}})
    t = 0.0
    for s in steps:
        # a rollback step un-rewires a plane; it pops red in the trace
        cname = _COLOR_CRITICAL if s.direction == "rollback" \
            else "thread_state_running"
        events.append({
            "name": f"{s.direction}#{s.seq}", "ph": "X", "pid": 0,
            "tid": int(s.plane), "ts": t * time_scale,
            "dur": max(float(s.delay_s), 0.0) * time_scale,
            "cname": cname,
            "args": {"seq": int(s.seq), "direction": s.direction,
                     "plane": int(s.plane),
                     "changed_circuits": int(s.changed_circuits),
                     "peak_inflation": float(s.peak_inflation)}})
        events.append({
            "name": "peak_inflation", "ph": "C", "pid": 0, "tid": 0,
            "ts": t * time_scale,
            "args": {"inflation": round(float(s.peak_inflation), 6)}})
        t += float(s.delay_s)
    events.append({"name": "peak_inflation", "ph": "C", "pid": 0,
                   "tid": 0, "ts": t * time_scale,
                   "args": {"inflation": 1.0}})
    other = {"transition": tname, "total_delay_s": float(t),
             "steps": len(steps)}
    if summary is not None:
        other["outcome"] = summary.outcome
        other["peak_inflation"] = float(summary.peak_inflation)
        other["tenants"] = list(summary.tenants)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


def validate_trace(trace: dict) -> list[str]:
    """Minimal Chrome trace-event schema check; returns error strings."""
    errors: list[str] = []
    if not isinstance(trace, dict):
        return ["trace must be a JSON object"]
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents must be a list"]
    if not events:
        errors.append("traceEvents is empty")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            errors.append(f"event {i}: missing name")
        ph = ev.get("ph")
        if ph not in ("X", "B", "E", "C", "M", "i"):
            errors.append(f"event {i}: bad phase {ph!r}")
        if ph in ("X", "B", "E", "C", "i") and \
                not isinstance(ev.get("ts"), (int, float)):
            errors.append(f"event {i}: missing ts")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {i}: bad dur {dur!r}")
        for key in ("pid", "tid"):
            if key in ev and not isinstance(ev[key], int):
                errors.append(f"event {i}: {key} must be an int")
        try:
            json.dumps(ev.get("args", {}))
        except (TypeError, ValueError):
            errors.append(f"event {i}: args not JSON-serializable")
    return errors


def write_trace(trace: dict, path: str) -> str:
    """Validate + write a trace JSON; returns the path (raises on an
    invalid trace so CI never commits an unopenable artifact)."""
    errors = validate_trace(trace)
    if errors:
        raise ValueError("invalid trace: " + "; ".join(errors[:5]))
    with open(path, "w") as f:
        json.dump(trace, f)
    return path
