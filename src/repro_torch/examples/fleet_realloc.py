"""Fleet demo: donate a port-minimized tenant's savings to a bottlenecked
co-tenant (paper Sec. VI / Fig. 10, as a multi-tenant service).

    PYTHONPATH=src python -m repro_torch.examples.fleet_realloc [--full] \
        [--device cpu]

Admits the GPT-7B workload twice onto the same four pods: once normally
with port minimization (the donor), once with reversed stage placement (the
bandwidth-bottlenecked Model^T co-tenant).  The fleet planner's port ledger
tracks the donor's freed ports, waterfills them into the co-tenant (one
`fill_matvec` per round on the device), and re-optimizes its topology with
one batched torch DES evaluation.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import PAPER_WORKLOADS, make_job
from repro_torch.core.des_torch import DESOptions
from repro_torch.core.ga import GAOptions
from repro_torch.fleet import (FleetPlanner, FleetSpec, JobArrival,
                               JobDeparture)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--full", action="store_true",
                    help="the workload's configured microbatches and a "
                         "longer GA")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every engine (cuda | cpu)")
    args = ap.parse_args(argv)
    fast = not args.full

    arch = PAPER_WORKLOADS["gpt-7b"]
    job = make_job(arch, microbatches=8 if fast else
                   arch.plan.num_microbatches)
    placement = job.placement()
    fleet = FleetSpec(num_pods=placement.num_pods,
                      ports_per_pod=2 * max(placement.port_limits()),
                      nic_gbps=100.0)
    print(f"fleet: {fleet.num_pods} pods x {fleet.ports_per_pod} OCS ports, "
          f"{fleet.nic_gbps:.0f} Gb/s per port")

    ga = GAOptions(seed=0, time_limit=10 if fast else 60,
                   patience=15 if fast else 60,
                   des_options=DESOptions(device=args.device))
    planner = FleetPlanner(fleet, ga_options=ga, seed=0)

    donor = planner.handle(JobArrival("model", job, port_min=True))
    print(f"\n[arrival] model        nct={donor['nct']:.4f} "
          f"ports={donor['ports']} donated={donor['donated_ports']}")

    cot = planner.handle(JobArrival("model_t", job, reverse_stages=True))
    print(f"[arrival] model_t      nct={cot['nct']:.4f} "
          f"ports={cot['ports']} (bottlenecked co-tenant)")
    for o in cot["realloc"]:
        print(f"[realloc] {o['tenant']:<12s} granted={o['granted']} "
              f"kept={o['kept']} nct {o['nct_before']:.4f} -> "
              f"{o['nct_after']:.4f} "
              f"({o['candidates']} candidates, 1 batched DES call)")

    report = planner.report()
    print(f"\nledger pool: {report['ledger']['pool']}")
    for name, t in report["tenants"].items():
        print(f"  {name:<12s} pods={t['pods']} nct={t['nct']:.4f} "
              f"ports={t['ports']}")
    print(f"plan cache: {report['cache']}")

    dep = planner.handle(JobDeparture("model"))
    print("\n[departure] model leaves; surplus pass re-runs:")
    for o in dep["realloc"]:
        print(f"[realloc] {o['tenant']:<12s} granted={o['granted']} "
              f"kept={o['kept']} nct {o['nct_before']:.4f} -> "
              f"{o['nct_after']:.4f}")
    planner.ledger.check()
    print("ledger conservation: OK")


if __name__ == "__main__":
    main()
