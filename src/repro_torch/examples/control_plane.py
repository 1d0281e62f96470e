"""Telemetry-driven control plane demo: monitor -> decide -> apply.

    PYTHONPATH=src python -m repro_torch.examples.control_plane [--device cpu]

Admits one tenant on a PP-heavy training phase, then feeds the controller
the telemetry its workload would emit (synthesized from the exact DES
rate trace): a stretch of on-plan iterations, a short phase flap the
hysteresis must swallow, and a real switch to a DP-heavy phase that the
controller confirms, prices with the *measured* dwell, and steers through
the planner's break-even machinery.  The journaled session is finally
replayed into a fresh planner, which must land on identical decisions.

Exits non-zero if any invariant is violated (flap reaching the planner,
steer not clearing the break-even, pricing disagreeing with the exact DES
oracle, or a non-identical replay), so it serves as a smoke gate.
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
from repro_torch.core.schedule import build_comm_dag
from repro_torch.core.traffic import JobSpec
from repro_torch.fleet import (ControllerConfig, ControlPlane, FleetPlanner,
                               FleetSpec, JobArrival, synthesize_telemetry)
from repro_torch.obs import FleetJournal

FAILURES = 0
NIC = 100.0


def check(ok: bool, what: str) -> None:
    global FAILURES
    print(f"  [{'ok' if ok else 'VIOLATION'}] {what}")
    if not ok:
        FAILURES += 1


def phase_job(mb: int, d_model: int, params: float) -> JobSpec:
    """Same placement footprint, different traffic shape (PP- vs
    DP-heavy) -- the legal domain of a TrafficChange."""
    return JobSpec(name="t", tp=2, pp=4, dp=2, num_microbatches=mb,
                   micro_tokens=4096, d_model=d_model,
                   stage_params=(params,) * 4, gpus_per_pod_per_replica=4)


JOB_A = phase_job(8, 4096, 0.2e9)      # pretrain: PP-heavy
JOB_B = phase_job(2, 1024, 3e9)        # finetune: DP-heavy
CFG = ControllerConfig(cadence_s=2.0, confirm_ticks=2, cooldown_s=0.0,
                       drift_threshold=0.05, drift_tau_s=5.0)


def make_planner(device: str, path: str | None = None) -> FleetPlanner:
    ga = GAOptions(seed=0, pop_size=16, max_generations=10,
                   patience=10**9, time_limit=1e9,
                   des_options=DESOptions(device=device))
    return FleetPlanner(FleetSpec(num_pods=4, ports_per_pod=8,
                                  nic_gbps=NIC),
                        ga_options=ga, seed=0, reconfig_s_per_circuit=0.05,
                        journal=FleetJournal(path))


def drive(cp: ControlPlane, dag, x, **kw) -> None:
    for ev in synthesize_telemetry(dag, x, tenant="t", **kw):
        cp.observe(ev)


def main(argv: list[str] | None = None) -> int:
    global FAILURES
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device of every engine (cuda | cpu)")
    args = ap.parse_args(argv)
    FAILURES = 0
    dag_a = build_comm_dag(JOB_A, NIC)
    dag_b = build_comm_dag(JOB_B, NIC)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "session.jsonl")
        pl = make_planner(args.device, path)
        pl.handle(JobArrival(name="t", job=JOB_A))
        x0 = pl.tenants["t"].plan.x.copy()
        print(f"admitted on phase A: makespan="
              f"{pl.tenants['t'].plan.makespan * 1e3:.1f}ms, "
              f"dwell prior={pl.dwell_for('t'):.0f}s\n")

        cp = ControlPlane(pl, CFG, phase_book={"t": {"A": JOB_A,
                                                     "B": JOB_B}})
        print("phase A: 20 on-plan iterations")
        drive(cp, dag_a, x0, phase="A", t0=0.0, iterations=20)
        check(all("decision" not in d for d in cp.decisions),
              "on-plan traffic issued no steered change")

        print("flap: 2 iterations of B, back to A before confirm")
        drive(cp, dag_b, x0, phase="B", t0=100.0, iterations=2)
        drive(cp, dag_a, x0, phase="A", t0=104.0, iterations=20)
        check(all("decision" not in d for d in cp.decisions),
              "flap shorter than the confirm window never reached the "
              "planner")

        print("switch: phase B for real (measured dwell ~300s)")
        drive(cp, dag_b, x0, phase="B", t0=300.0, iterations=60)
        applied = [d for d in cp.decisions if "decision" in d]
        check(len(applied) == 1, "exactly one steered change was issued")
        if applied:
            d = applied[0]["decision"]
            print(f"  steer: {d['option']} dwell={d['dwell_s']:.0f}s "
                  f"inflation={d['inflation']:.3f} "
                  f"cost_keep={d['cost_keep_s']:.2f}s "
                  f"cost_replan={d['cost_replan_s']:.2f}s")
            check(d["dwell_s"] != 600.0,
                  "pricing used the measured dwell, not the prior")
            cheap, dear = ((d["cost_replan_s"], d["cost_keep_s"])
                           if d["option"] == "replan" else
                           (d["cost_keep_s"], d["cost_replan_s"]))
            check(cheap <= dear, "the chosen option is the cheaper one")
            if d["option"] == "replan":
                check(d["dwell_s"] * d["inflation"] > d["delay_s"],
                      "replan cleared the dwell x inflation > delay "
                      "break-even")
            t = pl.tenants["t"]
            want = simulate(DESProblem(t.dag),
                            t.plan.x.astype(np.float64)).makespan
            check(abs(t.plan.makespan - want)
                  <= 1e-9 * max(abs(want), 1.0),
                  f"committed makespan {t.plan.makespan:.6f} == exact DES "
                  f"oracle {want:.6f}")
        report = cp.report()
        print(f"\ncontroller report: {json.dumps(report['actions'])}, "
              f"dwell estimate "
              f"{report['tenants']['t']['dwell_estimate_s']:.0f}s")

        print("replay: journal -> fresh planner")
        fresh = make_planner(args.device)
        cp2 = ControlPlane.replay(path, fresh, config=CFG,
                                  phase_book={"t": {"A": JOB_A,
                                                    "B": JOB_B}})

        def strip(ds):
            return [{k: v for k, v in d.items() if k != "decision"}
                    for d in ds]
        check(strip(cp2.decisions) == strip(cp.decisions),
              "replayed decision history is identical")
        check(np.array_equal(fresh.tenants["t"].plan.x,
                             pl.tenants["t"].plan.x),
              "replayed topology is bit-identical")

    print(f"\n{'OK' if FAILURES == 0 else f'{FAILURES} VIOLATION(S)'}")
    return 1 if FAILURES else 0


if __name__ == "__main__":
    raise SystemExit(main())
