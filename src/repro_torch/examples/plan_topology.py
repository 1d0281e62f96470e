"""Plan OCS topologies for the paper's large workloads and reproduce the
port-saving + reallocation story (Figs. 9/10 direction) at reduced scale.

    PYTHONPATH=src python -m repro_torch.examples.plan_topology [--full] \
        [--arch gpt-7b] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import PAPER_WORKLOADS, make_job
from repro_torch.core.api import PlanRequest, plan
from repro_torch.core.des_torch import DESOptions
from repro_torch.core.ga import GAOptions
from repro_torch.core.milp import MILPOptions
from repro_torch.core.schedule import build_comm_dag


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-scale microbatch counts (slow)")
    ap.add_argument("--arch", default="mixtral-8x22b")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every engine (cuda | cpu)")
    args = ap.parse_args(argv)
    des = DESOptions(device=args.device)
    arch = PAPER_WORKLOADS[args.arch]
    mb = arch.plan.num_microbatches if args.full else 2 * arch.plan.pp
    job = make_job(arch, microbatches=mb)
    dag = build_comm_dag(job, inter_pod_gbps=400.0)
    print(f"{args.arch}: {dag.num_real_tasks} tasks, "
          f"{dag.cluster.num_pods} pods")

    fast = plan(PlanRequest(dag=dag, method="delta-fast",
                            ga_options=GAOptions(seed=0, time_limit=60,
                                                 des_options=des)))
    print(f"delta-fast : NCT={fast.nct:.4f} ports={fast.total_ports}")
    saved = plan(PlanRequest(dag=dag, method="delta-joint", port_min=True,
                             ga_options=GAOptions(des_options=des),
                             milp_options=MILPOptions(time_limit=240)))
    if saved.feasible:
        U = np.asarray(dag.cluster.port_limits)
        used = saved.x.sum(axis=1)
        print(f"delta-joint+port-min: NCT={saved.nct:.4f} "
              f"ports={saved.total_ports} "
              f"(ratio {saved.total_ports/U.sum():.2f})")
        # reallocate surplus to the reversed-placement co-tenant
        dag_t = build_comm_dag(job, inter_pod_gbps=400.0,
                               reverse_stages=True)
        boosted = dag_t.cluster.with_port_limits(U + (U - used))
        dag_b = build_comm_dag(job, inter_pod_gbps=400.0,
                               reverse_stages=True, cluster=boosted)
        r0 = plan(PlanRequest(dag=dag_t, method="delta-fast",
                              ga_options=GAOptions(seed=0, time_limit=60,
                                                   des_options=des)))
        r1 = plan(PlanRequest(dag=dag_b, method="delta-fast",
                              ga_options=GAOptions(seed=0, time_limit=60,
                                                   des_options=des)))
        print(f"co-tenant Model^T: NCT {r0.nct:.4f} -> {r1.nct:.4f} "
              f"after port reallocation")


if __name__ == "__main__":
    main()
