"""Quickstart: plan an OCS logical topology for a small LLM training job.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Builds the paper's GPT-7B profiling workload (Fig. 1), derives its reduced
inter-pod communication DAG, and compares DELTA-Fast against the
traffic-matrix baselines.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import PAPER_WORKLOADS, make_job
from repro_torch.core.api import compare
from repro_torch.core.des_torch import DESOptions
from repro_torch.core.ga import GAOptions
from repro_torch.core.schedule import build_comm_dag


def main(argv: list[str] | None = None, fast: bool = False) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the GA's DES (cuda | cpu)")
    args = ap.parse_args(argv)

    arch = PAPER_WORKLOADS["gpt-7b"]
    job = make_job(arch, seq_len=4096,
                   microbatches=4 if fast else arch.plan.num_microbatches)
    dag = build_comm_dag(job, inter_pod_gbps=400.0)
    s = dag.summary()
    print(f"job {job.name}: tp={job.tp} pp={job.pp} dp={job.dp} "
          f"mb={job.num_microbatches}")
    print(f"inter-pod DAG: {s['num_tasks']} tasks, {s['num_deps']} deps, "
          f"{s['num_pods']} pods, {s['total_volume_gb']:.1f} GB/iteration")

    ga = GAOptions(seed=0, time_limit=10 if fast else 60,
                   patience=15 if fast else 60,
                   des_options=DESOptions(device=args.device))
    plans = compare(dag, methods=("prop-alloc", "sqrt-alloc", "iter-halve",
                                  "delta-fast"), ga_options=ga)
    print(f"\n{'method':<14s} {'NCT':>8s} {'makespan':>12s} {'ports':>6s}")
    for name, r in plans.items():
        print(f"{name:<14s} {r.nct:8.4f} {r.makespan*1e3:10.2f}ms "
              f"{r.total_ports:6d}")
    best = min(plans.values(), key=lambda r: r.nct)
    print(f"\nbest: {best.method} (NCT {best.nct:.4f})")
    print("planned circuits x_ij (row i -> col j):")
    print(best.x)


if __name__ == "__main__":
    main()
