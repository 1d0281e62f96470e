"""Fault-injected fleet demo: failures, priced repairs, crash recovery.

    PYTHONPATH=src python -m repro_torch.examples.chaos_fleet [--device cpu]

Admits two tenants, then drives a scripted failure trace through the
planner: a half-capacity link, a dark OCS plane, a port failure that
strands a tenant, and the matching recoveries.  Every event prints the
repair decision the planner priced (keep / rewire / replan) and the
ledger is conservation-checked after each one.  The journal is then
replayed from the last snapshot into a second planner, which must land on
a bit-identical decision history.

Exits non-zero if any invariant is violated (ledger imbalance, committed
pricing disagreeing with the masked DES oracle, or a non-identical
recovery), so it serves as a smoke gate.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from repro_torch.core.des import DESProblem, simulate
from repro_torch.core.des_torch import DESOptions
from repro_torch.core.ga import GAOptions
from repro_torch.core.traffic import JobSpec
from repro_torch.fleet import (FleetPlanner, FleetSpec, JobArrival,
                               LinkFailure, LinkRecovery, PlanCache,
                               PlaneFailure, PlaneRecovery, PortFailure,
                               PortRecovery)
from repro_torch.obs import FleetJournal
from repro_torch.obs.journal import _json_default

FAILURES = 0


def check(ok: bool, what: str) -> None:
    global FAILURES
    print(f"  [{'ok' if ok else 'VIOLATION'}] {what}")
    if not ok:
        FAILURES += 1


def job(name: str, pp: int = 4) -> JobSpec:
    return JobSpec(name=name, tp=2, pp=pp, dp=2, num_microbatches=4,
                   micro_tokens=4096, d_model=4096,
                   stage_params=(1.75e9,) * pp, gpus_per_pod_per_replica=4)


def verify_pricing(pl: FleetPlanner) -> None:
    """Every committed plan's makespan must equal the masked DES oracle."""
    for name, t in pl.tenants.items():
        mask = pl.health.local_mask(t.pods)
        got = t.plan.makespan
        want = simulate(DESProblem(t.dag),
                        t.plan.x.astype(np.float64) * mask).makespan
        same = (got == want) or (not np.isfinite(got)
                                 and not np.isfinite(want)) \
            or abs(got - want) <= 1e-9 * max(abs(want), 1.0)
        check(same, f"{name}: committed makespan {got:.6f} == masked "
                    f"oracle {want:.6f}")


def main(argv: list[str] | None = None) -> int:
    global FAILURES
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device of every engine (cuda | cpu)")
    args = ap.parse_args(argv)
    FAILURES = 0
    ga = GAOptions(seed=0, pop_size=16, max_generations=10,
                   patience=10**9, time_limit=1e9,
                   des_options=DESOptions(device=args.device))
    fleet = FleetSpec(num_pods=6, ports_per_pod=16, nic_gbps=100.0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "journal.jsonl")
        pl = FleetPlanner(fleet, ga_options=ga, seed=0, snapshot_every=3,
                          journal=FleetJournal(path))
        print(f"fleet: {fleet.num_pods} pods x {fleet.ports_per_pod} ports, "
              f"{pl.health.num_planes} OCS planes, snapshot every "
              f"3 events\n")

        events = [
            JobArrival(name="a", job=job("ja")),
            JobArrival(name="b", job=job("jb", pp=2), port_min=True),
            LinkFailure(pair=(0, 1), fraction=0.5),
            PlaneFailure(plane=0),
            PortFailure(pod=0, count=10),
            PortRecovery(pod=0, count=10),
            LinkRecovery(pair=(0, 1)),
            PlaneRecovery(plane=0),
        ]
        for ev in events:
            record = pl.handle(ev)   # raises on ledger imbalance
            kind = type(ev).__name__
            blob = json.dumps(record, default=_json_default)
            print(f"[{kind}] {blob[:120]}...")
            for dec in record.get("repairs", []):
                print(f"  repair {dec['tenant']}: chose {dec['option']!r} "
                      f"cost={dec['cost_s']:.2f}s "
                      f"(makespan {dec['ms_healthy']:.4f} -> "
                      f"{dec['makespan']:.4f}, "
                      f"{dec['changed_circuits']} circuit changes)")
            for rec in record.get("replans", []):
                print(f"  replan {rec['tenant']}: path={rec['path']}")
            try:
                pl.ledger.check()
                check(True, "ledger conservation")
            except Exception as exc:   # noqa: BLE001
                check(False, f"ledger conservation: {exc}")
            verify_pricing(pl)
        pl.journal.close()

        print("\n[recovery] replaying snapshot + journal tail ...")
        pl2 = FleetPlanner.recover(path, fleet, ga_options=ga,
                                   cache=PlanCache(), snapshot_every=3)
        h1 = json.dumps(pl.history, default=_json_default)
        h2 = json.dumps(pl2.history, default=_json_default)
        check(h1 == h2, "recovered decision history is bit-identical")
        check(pl.rng.bit_generator.state == pl2.rng.bit_generator.state,
              "recovered rng stream matches")
        for name, t in pl.tenants.items():
            t2 = pl2.tenants[name]
            check(bool((t.plan.x == t2.plan.x).all())
                  and t.plan.makespan == t2.plan.makespan,
                  f"recovered plan for {name!r} matches")

    print(f"\n{FAILURES} invariant violation(s)")
    return 1 if FAILURES else 0


if __name__ == "__main__":
    raise SystemExit(main())
