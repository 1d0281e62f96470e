"""Staggered k-plane transition demo: zero-downtime rewires under fire.

    PYTHONPATH=src python -m repro_torch.examples.planes_transition \
        [--device cpu]

Admits a tenant on a 4-plane fabric, replans it (a `TrafficChange`), and
shows the fleet applying the change as a staggered plane-by-plane
transition -- each step's certified peak inflation, then the journaled
plane events replayed into a second planner that must land on a
bit-identical plane book.

Then the hard case: a standalone `StaggeredTransition` takes a
`PlaneFailure` mid-transition on a plane it has NOT yet rewired.  The
scheduler re-prices the remaining steps against the doubly-degraded
fabric and either finishes or rolls back -- but the fleet must land on
exactly plan A or plan B, never between them.  A sub-1.0 SLO forces the
rollback path, and the transition timeline is schema-validated.

Exits non-zero if any invariant is violated (a step's journaled inflation
disagreeing with the masked numpy-DES oracle, a stranded fleet, a
non-identical replay, or an invalid timeline), so it serves as a gate.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.core.cluster import split_port_budgets
from repro_torch.core.des import DESProblem, simulate
from repro_torch.core.des_torch import DESOptions
from repro_torch.core.ga import GAOptions
from repro_torch.core.schedule import build_comm_dag
from repro_torch.core.traffic import JobSpec
from repro_torch.fleet import (FabricHealth, FleetPlanner, FleetSpec,
                               JobArrival, PlanCache, StaggeredTransition,
                               TenantLane, TrafficChange, effective_topology,
                               split_plan)
from repro_torch.obs import (FleetJournal, plane_rewire_timeline,
                             validate_trace)
from repro_torch.obs.journal import _json_default

FAILURES = 0
NUM_PLANES = 4


def check(ok: bool, what: str) -> None:
    global FAILURES
    print(f"  [{'ok' if ok else 'VIOLATION'}] {what}")
    if not ok:
        FAILURES += 1


def job(name: str, mb: int = 4, tokens: int = 4096) -> JobSpec:
    return JobSpec(name=name, tp=2, pp=4, dp=2, num_microbatches=mb,
                   micro_tokens=tokens, d_model=4096,
                   stage_params=(1.75e9,) * 4, gpus_per_pod_per_replica=4)


def main(argv: list[str] | None = None) -> int:
    global FAILURES
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device of every engine (cuda | cpu)")
    args = ap.parse_args(argv)
    FAILURES = 0
    ga = GAOptions(seed=0, pop_size=12, max_generations=25, patience=8,
                   time_limit=5.0, des_options=DESOptions(device=args.device))

    # --------------------------------------------- fleet-driven transition
    print("== fleet replan applies as a staggered transition ==")
    journal = FleetJournal()
    pl = FleetPlanner(FleetSpec(num_pods=4, ports_per_pod=8, nic_gbps=100.0),
                      ga_options=ga, seed=0, journal=journal,
                      cache=PlanCache())
    pl.handle(JobArrival(name="a", job=job("j")))
    check(np.array_equal(pl.planes.total("a"), pl.tenants["a"].plan.x),
          "arrival decomposed across the plane book")
    rec = pl.handle(TrafficChange(name="a", job=job("j", mb=8, tokens=8192)))
    tr = rec.get("transition")
    check(tr is not None and tr["status"] == "committed",
          "traffic change committed through the staggered scheduler")
    if tr is not None:
        print(f"  transition {tr['transition']}: {tr['steps']} steps, "
              f"peak inflation {tr['peak_inflation']:.4f}, "
              f"plane order {tr['planes']}")
    check(np.array_equal(pl.planes.total("a"), pl.tenants["a"].plan.x),
          "plane book sums to the committed topology")

    plane_records = [e for e in journal.entries
                     if e.get("kind") == "plane_event"]
    check(bool(plane_records) and all(e["event"]["v"] == 3
                                      for e in plane_records),
          f"{len(plane_records)} plane events journaled at schema v3")

    pl2 = FleetPlanner.recover(journal.entries, pl.fleet, ga_options=ga,
                               seed=0, cache=PlanCache())
    check(pl2.planes.snapshot() == pl.planes.snapshot(),
          "journal replay lands on a bit-identical plane book")
    check(json.dumps(pl2.transitions, default=_json_default)
          == json.dumps(pl.transitions, default=_json_default),
          "replayed transitions match the recorded ones exactly")

    # --------------------------------------- mid-transition plane failure
    print("== PlaneFailure mid-transition on a not-yet-rewired plane ==")
    dag = build_comm_dag(job("solo", mb=2), 400.0)
    P = dag.cluster.num_pods
    x_a = np.zeros((P, P), dtype=np.int64)
    for i, j in dag.undirected_pairs():
        x_a[i, j] = x_a[j, i] = 4
    x_b = x_a.copy()
    for i, j in dag.undirected_pairs()[:2]:
        x_b[i, j] = x_b[j, i] = 2
    budgets = np.asarray(split_port_budgets((64,) * P, NUM_PLANES))
    lane = TenantLane(name="solo", dag=dag, pods=tuple(range(P)),
                      planes_a=split_plan(x_a, budgets),
                      planes_b=split_plan(x_b, budgets))
    health = FabricHealth(P, NUM_PLANES)
    tr2 = StaggeredTransition([lane], health, slo=5.0, transition_id="demo")

    first = tr2.step()
    check(first is not None, "first rewire step performed")
    victim = tr2.pending[0]
    health.fail_plane(victim)
    print(f"  !! plane {victim} fails while still carrying plan-A circuits")
    outcome = "committed"
    while tr2.pending:
        if tr2.step() is None:
            tr2.rollback()
            outcome = "rolled_back"
            break
    print(f"  outcome: {outcome} after {len(tr2.steps)} steps "
          f"(fabric still dark on plane {victim})")

    final = tr2.mixed_planes(lane)
    target = lane.planes_b if outcome == "committed" else lane.planes_a
    check(np.array_equal(final, target),
          f"fleet landed on exactly plan "
          f"{'B' if outcome == 'committed' else 'A'}"
          " -- never stranded between plans")

    # re-certify every journaled step against the masked numpy oracle
    prob = DESProblem(dag)
    done: list[int] = []
    exact = 0
    for s in tr2.steps:
        mixed = lane.planes_a.copy()
        for p in done:
            mixed[p] = lane.planes_b[p]
        dark = {victim} if s.seq > first.seq else set()
        ref = simulate(prob, effective_topology(mixed, dark)).makespan
        ms = simulate(prob,
                      effective_topology(mixed, dark | {s.plane})).makespan
        peak = max(ms / ref, 1.0) if np.isfinite(ms) else float("inf")
        if s.peak_inflation == peak:
            exact += 1
        if s.direction == "forward":
            done.append(s.plane)
        else:
            done.remove(s.plane)
    check(exact == len(tr2.steps),
          f"{exact}/{len(tr2.steps)} step inflations match the oracle "
          f"EXACTLY")

    trace = plane_rewire_timeline(tr2.steps, tr2._result(outcome).summary)
    check(validate_trace(trace) == [], "transition timeline is schema-valid")

    # ----------------------------------------------------- forced rollback
    print("== sub-1.0 SLO forces the rollback path ==")
    health2 = FabricHealth(P, NUM_PLANES)
    tr3 = StaggeredTransition([lane], health2, slo=0.5, transition_id="tight")
    res3 = tr3.run()
    check(res3.status == "rolled_back"
          and np.array_equal(tr3.mixed_planes(lane), lane.planes_a),
          "impossible SLO rolls back to plan A exactly")

    print(f"{'PASS' if FAILURES == 0 else 'FAIL'}: {FAILURES} violation(s)")
    return 1 if FAILURES else 0


if __name__ == "__main__":
    raise SystemExit(main())
