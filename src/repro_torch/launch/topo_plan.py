"""DELTA topology planning CLI -- the control-plane entry point.

    PYTHONPATH=src python -m repro_torch.launch.topo_plan \
        --arch deepseek-671b --bandwidth 400 \
        --methods prop-alloc,iter-halve,delta-fast \
        --microbatches 32 --port-min --out plan.json

Prints per-method NCT / makespan / port usage and (optionally) writes the
chosen logical topology matrix for the OCS controller.  Every engine runs
on `--device` (default cuda; without a CUDA device, pass --device cpu).
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs import ALL_ARCHS, make_job
from repro_torch.core.api import METHODS, PlanRequest, PlanResult, plan
from repro_torch.core.des_torch import DESOptions
from repro_torch.core.ga import GAOptions
from repro_torch.core.milp import MILPOptions
from repro_torch.core.schedule import build_comm_dag


def main(argv: list[str] | None = None) -> dict[str, PlanResult]:
    """Plan with each method and print one line each; returns the results
    by method."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gpt-7b", choices=sorted(ALL_ARCHS))
    ap.add_argument("--bandwidth", type=float, default=400.0,
                    help="inter-pod Gb/s per GPU")
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--microbatches", type=int, default=0,
                    help="0 = the workload's configured count")
    ap.add_argument("--methods", default="prop-alloc,sqrt-alloc,iter-halve,"
                                         "delta-fast")
    ap.add_argument("--port-min", action="store_true")
    ap.add_argument("--time-limit", type=float, default=300.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every engine (cuda | cpu)")
    args = ap.parse_args(argv)

    arch = ALL_ARCHS[args.arch]
    job = make_job(arch, seq_len=args.seq,
                   microbatches=args.microbatches or None)
    dag = build_comm_dag(job, inter_pod_gbps=args.bandwidth)
    s = dag.summary()
    ep_note = (f", {s['ep_volume_fraction']:.0%} EP all-to-all"
               if s["ep_volume_fraction"] > 0 else "")
    print(f"[plan] {args.arch}: tp={job.tp} pp={job.pp} dp={job.dp} "
          f"ep={job.ep} mb={job.num_microbatches} -> {s['num_tasks']} "
          f"inter-pod tasks, {s['num_pods']} pods, "
          f"{s['total_volume_gb']:.1f} GB/iteration{ep_note}")

    methods = [m.strip() for m in args.methods.split(",") if m.strip()]
    bad = set(methods) - set(METHODS)
    if bad:
        raise SystemExit(f"unknown methods: {bad}")
    results = {}
    for m in methods:
        r = plan(PlanRequest(
            dag=dag, method=m, port_min=args.port_min,
            ga_options=GAOptions(time_limit=args.time_limit / 2),
            milp_options=MILPOptions(time_limit=args.time_limit,
                                     port_min=args.port_min),
            des_options=DESOptions(device=args.device)))
        results[m] = r
        print(f"[plan] {m:22s} NCT={r.nct:8.4f} "
              f"makespan={r.makespan*1e3:9.2f}ms ports={r.total_ports:4d} "
              f"t={r.elapsed:6.1f}s")

    best = min((r for r in results.values() if r.feasible),
               key=lambda r: (r.nct, r.total_ports))
    print(f"[plan] selected: {best.method}")
    if args.out:
        payload = {
            "arch": args.arch, "bandwidth_gbps": args.bandwidth,
            "method": best.method, "nct": best.nct,
            "total_ports": best.total_ports,
            "topology": np.asarray(best.x).tolist(),
            "all": {m: {"nct": r.nct, "ports": r.total_ports,
                        "makespan": r.makespan}
                    for m, r in results.items()},
        }
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"[plan] wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
