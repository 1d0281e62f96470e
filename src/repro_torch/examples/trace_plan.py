"""Plan one Table-I workload and emit its schedule timeline + span trace.

    PYTHONPATH=src python -m repro_torch.examples.trace_plan [--out DIR] \
        [--full] [--device cpu]

Produces, under --out (default experiments/trace):

  schedule_gpt-7b.json   Chrome-trace JSON of the DES schedule -- open in
                         https://ui.perfetto.dev (one track per inter-pod
                         link, critical-path tasks in red, per-link
                         utilization counter tracks)
  spans_gpt-7b.json      Chrome-trace JSON of the planner's own spans,
                         each with its id and its parent's: Alg. 2
                         (xbound.upper_bound > des.problem, des.host: the
                         t_up estimate), the GA's DES problem and engine
                         (des.problem, des.build), the search (ga.evolve >
                         ga.generation > ga.fitness_batch > des.simulate),
                         the exact re-rank (ga.rerank > des.host), the
                         winner's numpy DES run (des.host), then the
                         chosen plan's des.problem and des.host here and
                         the timeline's des.problem

and prints the critical-path / per-task-slack report plus the span
summary.  Exits non-zero if the emitted trace fails schema validation or
the slack report disagrees with the DES makespan -- a smoke check of the
whole repro_torch.obs layer.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from repro_torch.configs import PAPER_WORKLOADS, make_job
from repro_torch.core.des import DESProblem, simulate
from repro_torch.core.des_torch import DESOptions
from repro_torch.core.ga import GAOptions, delta_fast
from repro_torch.core.schedule import build_comm_dag
from repro_torch.obs import (TRACER, schedule_timeline, slack_report,
                             validate_trace, write_trace)

WORKLOAD = "gpt-7b"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="experiments/trace")
    ap.add_argument("--full", action="store_true",
                    help="paper-scale microbatches and GA budget")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the GA's DES (cuda | cpu)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    arch = PAPER_WORKLOADS[WORKLOAD]
    mb = arch.plan.num_microbatches if args.full else max(arch.plan.pp, 4)
    job = make_job(arch, microbatches=mb)
    dag = build_comm_dag(job, inter_pod_gbps=100.0)
    print(f"{WORKLOAD}: {dag.num_tasks} comm tasks over "
          f"{dag.cluster.num_pods} pods ({mb} microbatches)")

    # ---- plan with tracing on: the span trace shows where the GA's wall
    # clock went (generations, batched DES fitness calls)
    TRACER.enable()
    ga = GAOptions(seed=0, time_limit=60.0 if args.full else 15.0,
                   patience=60 if args.full else 20,
                   des_options=DESOptions(device=args.device))
    res = delta_fast(dag, ga)
    print(f"DELTA-Fast: makespan {res.makespan:.6f}s, "
          f"{res.total_ports} ports, {res.generations} generations, "
          f"{res.evaluations} evaluations in {res.elapsed:.1f}s")

    # ---- simulate the chosen plan with per-interval rates and export the
    # schedule timeline + the critical-path / slack report
    problem = DESProblem(dag)
    sim = simulate(problem, res.x, record_rates=True)
    rep = slack_report(dag, sim)
    trace = schedule_timeline(dag, res.x, sim)

    # the report must agree with the DES: the zero-slack chain IS the
    # makespan (paper: critical path pins the schedule; everything else
    # carries exploitable temporal slack)
    finish = np.asarray(sim.finish)
    realized = float(finish[np.isfinite(finish)].max())
    if abs(realized - rep["makespan"]) > 1e-9 * max(1.0, rep["makespan"]):
        print(f"FAIL: slack report makespan {rep['makespan']} != realized "
              f"{realized}")
        return 1
    if not rep["zero_slack_tasks"]:
        print("FAIL: no zero-slack task (critical path must have slack 0)")
        return 1

    print(f"\nslack report: makespan {rep['makespan']:.6f}s, "
          f"comm {rep['comm_time']:.6f}s, "
          f"{len(rep['zero_slack_tasks'])}/{rep['num_tasks']} tasks on the "
          f"critical (zero-slack) set, "
          f"mean slack {rep['mean_slack']:.6f}s")

    sched_path = os.path.join(args.out, f"schedule_{WORKLOAD}.json")
    write_trace(trace, sched_path)       # raises if schema-invalid
    print(f"wrote {sched_path} ({len(trace['traceEvents'])} events) -- "
          f"open in https://ui.perfetto.dev")

    span_trace = TRACER.to_chrome_trace(process_name=f"plan {WORKLOAD}")
    errors = validate_trace(span_trace)
    if errors:
        print(f"FAIL: span trace invalid: {errors[:3]}")
        return 1
    span_path = os.path.join(args.out, f"spans_{WORKLOAD}.json")
    with open(span_path, "w") as f:
        json.dump(span_trace, f)
    print(f"wrote {span_path} ({len(span_trace['traceEvents'])} events)")

    print("\nspan summary (where the planning time went):")
    for name, row in sorted(TRACER.summary().items(),
                            key=lambda kv: -kv[1]["total_s"]):
        print(f"  {name:<24} x{row['count']:<6} total {row['total_s']:8.3f}s"
              f"  max {row['max_s']:.3f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
