"""The DAG of a configuration, built with the port's own job builder.

A configuration file names the job (an architecture of the port's
registry or the paper's Table I, its sequence length, microbatches and
inter-pod rate) and states the model and parallelism numbers it expects
that architecture to hold; set-up checks both those and the DAG's counts,
so the file is what runs.  `raw_dag` hands the DAG to the reference as the
job's plain data, from which the reference derives everything itself.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from reference.dag import RawDag


class ConfigMismatch(ValueError):
    """The port's job or DAG is not what the configuration file states."""


def _expect(what: str, got, want) -> None:
    if got != want:
        raise ConfigMismatch(f"{what}: the port has {got!r}, the "
                             f"configuration file states {want!r}")


def build_dag(config: dict):
    """CommDAG of `config`'s job; raises `ConfigMismatch` where the port's
    architecture or the DAG differs from what the file states."""
    from repro_torch.configs import ALL_ARCHS, make_job
    from repro_torch.core.schedule import build_comm_dag
    job = config["job"]
    arch = ALL_ARCHS[job["arch"]]
    for key, want in config["model"].items():
        _expect(f"model.{key}", getattr(arch.config, key), want)
    for key, want in config["parallelism"].items():
        _expect(f"parallelism.{key}", getattr(arch.plan, key), want)
    spec = make_job(arch, seq_len=job["seq_len"],
                    microbatches=job["microbatches"])
    dag = build_comm_dag(spec, job["inter_pod_gbps"])
    counts = {"gpus": spec.tp * spec.pp * spec.dp, "tasks": dag.num_tasks,
              "deps": len(dag.deps), "pods": dag.cluster.num_pods,
              "genes": len(dag.undirected_pairs())}
    for key, want in config["expect"].items():
        if key in counts:       # the X̄ total is the reference's to check
            _expect(f"expect.{key}", counts[key], want)
    return dag


def raw_dag(dag) -> RawDag:
    """The job's DAG as given: its tasks, dependencies and cluster."""
    t = dag.tasks
    return RawDag(
        num_pods=int(dag.cluster.num_pods),
        nic_bandwidth=float(dag.cluster.nic_bandwidth),
        port_limits=np.asarray(dag.cluster.port_limits, dtype=np.int64),
        src_pod=np.array([k.src_pod for k in t], dtype=np.int64),
        dst_pod=np.array([k.dst_pod for k in t], dtype=np.int64),
        flows=np.array([k.flows for k in t], dtype=np.int64),
        volume=np.array([k.volume for k in t], dtype=np.float64),
        virtual=np.array([k.kind == "virtual" for k in t]),
        src_gpus=[tuple(k.src_gpus) for k in t],
        dst_gpus=[tuple(k.dst_gpus) for k in t],
        dep_pre=np.array([d.pre for d in dag.deps], dtype=np.int64),
        dep_succ=np.array([d.succ for d in dag.deps], dtype=np.int64),
        dep_delta=np.array([d.delta for d in dag.deps], dtype=np.float64))


def ga_options(traffic: dict, config: dict, seed: int, time_limit: float,
               device: str | None):
    """GAOptions of one request: the mix's, then the configuration's
    (what the deployment sets, such as the fitness backend), then the
    request's seed and time budget."""
    from repro_torch.core.des_torch import DESOptions
    from repro_torch.core.ga import GAOptions
    kw = {**traffic.get("ga", {}), **config.get("ga", {}),
          "seed": int(seed), "time_limit": float(time_limit)}
    if device is not None:
        kw["des_options"] = DESOptions(device=device)
    fields = {f.name for f in dataclasses.fields(GAOptions)}
    unknown = set(kw) - fields
    if unknown:
        raise ConfigMismatch(f"GAOptions has no {sorted(unknown)}")
    return GAOptions(**kw)
