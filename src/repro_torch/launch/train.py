"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --reduce --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt

Features (the reference's `repro.launch.train`; all run on the CPU with
--device cpu as well):
  * DELTA topology planning before launch (--plan-topology): builds the
    job's inter-pod DAG from the arch's parallelism plan and prints the
    planned OCS circuits + NCT vs the traffic-matrix baselines, the GA
    on the training device.
  * fault tolerance: periodic checkpoints, --simulate-failure N injects a
    crash at step N and the driver restores + replays deterministically.
  * straggler watchdog, gradient-norm logging.

Parameters and AdamW moments are float32 on `--device` (default cuda;
without a CUDA device, pass --device cpu), drawn from a generator seeded
with `--seed`; batches are made on the host with numpy.  The state is
placed on a ("data", "model") mesh of the process group's ranks
(`launch.mesh.make_host_mesh(--model-parallel)`, a world of one rank
when `torchrun` started the process or a process group exists) by the
sharding rules, as the reference places it, and so is each batch; in a
process of its own the step runs plain, which on one device is what
every placement would give.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import REGISTRY, make_job
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     StepWatchdog,
                                                     run_resilient)
from repro_torch.launch.mesh import launch_mesh
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts
from repro_torch.training.data import SyntheticLM


def topology_dag(arch_name: str, seq_len: int):
    """The job's inter-pod DAG that `plan_topology` plans: the arch's
    parallelism plan at `seq_len` with at most 2 x pp microbatches."""
    from repro_torch.core.schedule import build_comm_dag
    arch = REGISTRY[arch_name]
    return build_comm_dag(make_job(
        arch, seq_len=seq_len,
        microbatches=min(arch.plan.num_microbatches, 2 * arch.plan.pp)))


def plan_topology(arch_name: str, seq_len: int,
                  device: torch.device | str) -> dict:
    """The job's DAG planned with the two baselines and DELTA-Fast, whose
    GA runs on `device`; prints the `[topo]` lines and returns the
    results by method."""
    from repro_torch.core.api import compare
    from repro_torch.core.des_torch import DESOptions
    from repro_torch.core.ga import GAOptions
    dag = topology_dag(arch_name, seq_len)
    print(f"[topo] job {dag.meta['job']}: {dag.num_real_tasks} inter-pod "
          f"tasks, {dag.cluster.num_pods} pods")
    res = compare(dag, methods=("prop-alloc", "iter-halve", "delta-fast"),
                  ga_options=GAOptions(
                      des_options=DESOptions(device=device)))
    for m, r in res.items():
        print(f"[topo] {m:12s} NCT={r.nct:7.4f} ports={r.total_ports:4d} "
              f"({r.elapsed:.1f}s)")
    return res


def main(argv: list[str] | None = None) -> dict:
    """Train; prints the reference's `[topo]` and `[train]` lines and
    returns {"steps", "restarts", "stragglers", "losses" (every step run,
    replays included), "wall_s", "first", "last", "state" (the final
    train state), "plan" (`plan_topology`'s results, None without
    --plan-topology)}."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduce", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--simulate-failure", type=int, default=-1)
    ap.add_argument("--plan-topology", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and the planner's GA "
                         "(cuda | cpu)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training runs on a CUDA device and none is "
                           "available; pass --device cpu to train on the "
                           "CPU")
    plan = plan_topology(args.arch, args.seq, device) \
        if args.plan_topology else None

    cfg = REGISTRY[args.arch].config
    if args.reduce:
        cfg = cfg.reduced()
    mesh = launch_mesh(args.model_parallel, device)
    ocfg = opt.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5))
    state = ts.init_train_state(
        cfg, ocfg, device=device,
        generator=torch.Generator(device=device).manual_seed(args.seed),
        dtype=torch.float32)
    if mesh is not None:
        state = shd.place(state, shd.named(
            shd.tree_specs(state, mesh, "state", cfg=cfg), mesh))
    step_fn = ts.make_train_step(
        cfg, ocfg, accum_steps=args.accum, remat=False, mesh=mesh,
        data_axes=shd.data_axes(mesh) if mesh is not None else ())
    data = SyntheticLM(vocab=cfg.vocab, seed=args.seed)

    start_step = 0
    if args.resume and args.ckpt_dir:
        latest = ckpt.latest(args.ckpt_dir)
        if latest:
            state, start_step, _ = ckpt.restore(latest, state)
            print(f"[train] resumed from {latest} at step {start_step}")

    injector = FailureInjector(
        fail_at=(args.simulate_failure,) if args.simulate_failure >= 0
        else ())
    watchdog = StepWatchdog()
    box = {"state": state, "losses": []}

    def do_step(step: int) -> dict:
        injector.maybe_fail(step)
        batch = data.batch(step, args.batch, args.seq)
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        if mesh is not None:
            batch = shd.place(batch, shd.named(
                shd.tree_specs(batch, mesh, "batch"), mesh))
        box["state"], metrics = step_fn(box["state"], batch)
        loss = float(metrics["loss"])
        box["losses"].append(loss)
        if step % args.log_every == 0:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
        return {"loss": loss}

    def save_ckpt(step: int) -> None:
        if args.ckpt_dir:
            ckpt.save(args.ckpt_dir, step, box["state"])

    def restore_ckpt() -> int:
        latest = ckpt.latest(args.ckpt_dir)
        if not latest:
            return 0
        box["state"], step, _ = ckpt.restore(latest, box["state"])
        print(f"[train] restored {latest} -> step {step}")
        return step

    t0 = time.time()
    summary = run_resilient(args.steps, do_step, save_ckpt, restore_ckpt,
                            ckpt_every=args.ckpt_every,
                            watchdog=watchdog)
    dt = time.time() - t0
    losses = box["losses"]
    first = float(np.mean(losses[:10])) if len(losses) >= 10 else losses[0]
    last = float(np.mean(losses[-10:]))
    print(f"[train] done: {summary['steps']} steps in {dt:.1f}s "
          f"({summary['restarts']} restarts, "
          f"{summary['stragglers']} stragglers) "
          f"loss {first:.4f} -> {last:.4f}")
    if last >= first:
        print("[train] WARNING: loss did not improve")
    return {"steps": summary["steps"], "restarts": summary["restarts"],
            "stragglers": summary["stragglers"], "losses": losses,
            "wall_s": dt, "first": first, "last": last,
            "state": box["state"], "plan": plan}


if __name__ == "__main__":
    main()
