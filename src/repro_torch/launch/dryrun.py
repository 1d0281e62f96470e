"""Multi-pod dry run: one step of every (architecture x shape x mesh) cell
on the production meshes, with no data (the reference's
`repro.launch.dryrun`).

The reference lowers and compiles each cell on 512 fake XLA host devices
and reads the compiled, partitioned HLO.  Here every tensor lives on the
`meta` device, the meshes run over a fake process group of 512 ranks
(`launch.mesh.make_production_mesh`), the state and inputs are placed as
DTensors by the sharding rules, and the step runs once, eagerly, under
`launch.costanalysis.CostMode`, which reads each device's share below
DTensor.  A cell records:

  memory.argument_bytes  the exact bytes of one device's shards of the
                         step's arguments (train: the state and the
                         batch; prefill/decode: the parameters, the cache
                         -- its position an int32 scalar, as in the
                         reference -- and the inputs);
  memory.output_bytes    likewise of the step's outputs (the state and
                         the cache are updated in place, as the
                         reference's jitted steps donate them);
  memory.temp_bytes      the peak of the bytes of the storages the step
                         allocates on one device that are alive at once
                         (its temporaries and outputs);
  flops_per_device, bytes_per_device, collectives (bytes per kind,
  "count", "total"), devices, params_total, params_active, tokens,
  accum_steps (train), seq_shard_attention, seq_parallel, status (ok /
  skipped / error, with the exception).

The reference's `xla_raw` (XLA's own cost analysis), its lower and
compile seconds, `generated_code_bytes`, `alias_bytes` and `hlo_bytes`
have no counterpart in an eager run and are left out; `step_s` is the
seconds of the run.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
        --shape train_4k --mesh single --quick

The fake process group is process-global: run the dry run in a process
of its own (it refuses a process group of another kind).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import NamedTuple

import torch

from repro_torch.configs import (REGISTRY, SHAPES, ArchSpec, ModelConfig,
                                 ShapeSpec, shape_applicable)
from repro_torch.distributed import sharding as shd
from repro_torch.launch import costanalysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.layers import sharding_hints
from repro_torch.training import optimizer as opt
from repro_torch.training import train_step as ts

BIG_PARAMS = 100e9          # >=: bf16 optimizer moments
COLLECTIVES = costanalysis.COLLECTIVES
_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8": 1,
                "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
                "s8": 1, "u8": 1, "pred": 1}
POS_BYTES = 4               # a cache's position: an int32 scalar


class TensorSpec(NamedTuple):
    """A stand-in for an input: its shape and dtype."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def _xkv_len(cfg: ModelConfig) -> int:
    if cfg.encoder_layers:
        return cfg.enc_tokens
    if cfg.cross_attn_every:
        return cfg.num_image_tokens
    return 0


def input_specs(arch: ArchSpec, shape: ShapeSpec,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """Stand-ins for every model input of this cell (the modality input
    in `dtype`, the reference's bfloat16 by default)."""
    cfg = arch.config
    B, S = shape.global_batch, shape.seq_len
    f = TensorSpec
    xl = _xkv_len(cfg)
    if shape.kind == "train":
        specs = {"tokens": f((B, S), torch.int32),
                 "labels": f((B, S), torch.int32)}
        if xl:
            specs["xkv"] = f((B, xl, cfg.d_model), dtype)
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": f((B, S), torch.int32)}
        if xl:
            specs["xkv"] = f((B, xl, cfg.d_model), dtype)
        return specs
    # decode: one new token against a KV cache of length seq_len
    return {"tokens": f((B, 1), torch.int32)}


def _state_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.total_params() >= BIG_PARAMS \
        else torch.float32


def _abstract_state(cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16):
    ocfg = opt.AdamWConfig(state_dtype=_state_dtype(cfg))
    state = ts.init_train_state(cfg, ocfg, device="meta", generator=None,
                                dtype=dtype)
    return state, ocfg


def _abstract_params(cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16):
    return M.LM(cfg, dtype=dtype, device="meta", generator=None)


def _abstract_cache(cfg: ModelConfig, batch: int, max_len: int,
                    dtype: torch.dtype = torch.bfloat16):
    return M.init_cache(cfg, batch, max_len, dtype=dtype,
                        enc_len=_xkv_len(cfg), device="meta")


def collective_bytes(hlo_text: str) -> dict[str, float]:
    """Sum per-device result bytes of every collective op in HLO text
    (the reference's line parser, for reading its dumps beside the
    port's counts)."""
    import re
    out = {k: 0.0 for k in COLLECTIVES}
    out["count"] = 0
    shape_re = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
    for line in hlo_text.splitlines():
        for kind in COLLECTIVES:
            if f" {kind}(" not in line and f" {kind}-start(" not in line:
                continue
            lhs = line.split("=", 1)
            if len(lhs) != 2:
                continue
            # result type(s): everything between '=' and the op name
            rhs = lhs[1]
            cut = rhs.find(kind)
            for m in shape_re.finditer(rhs[:cut]):
                dt, dims = m.group(1), m.group(2)
                size = _DTYPE_BYTES.get(dt)
                if size is None:
                    continue
                n = 1
                for d in dims.split(","):
                    if d:
                        n *= int(d)
                out[kind] += n * size
            out["count"] += 1
            break
    return out


def _meta(specs: dict) -> dict:
    return {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
            for k, s in specs.items()}


def auto_accum_steps(cfg: ModelConfig, shape: ShapeSpec, mesh) -> int:
    """Auto microbatching: 1 sequence per device per microstep for the
    huge archs (activation pressure), 2 otherwise."""
    sizes = shd.axis_sizes(mesh)
    dsz = 1
    for a in shd.data_axes(mesh):
        dsz *= sizes[a]
    target = 1 if cfg.total_params() >= BIG_PARAMS else 2
    return max(1, shape.global_batch // (dsz * target))


def hint_flags(cfg: ModelConfig, shape: ShapeSpec, mesh) -> tuple[bool, bool]:
    """(seq_shard, seq_parallel): sequence-shard attention (Ulysses-style)
    for archs whose head count does not divide the model axis, and
    sequence-parallel layer boundaries for large non-SSM archs and with
    Ulysses attention (the reference's measured choices)."""
    msize = shd.axis_sizes(mesh)["model"]
    seq_shard = bool(cfg.heads % msize) and shape.kind != "decode"
    seq_parallel = shape.kind == "train" and (
        (cfg.family in ("dense", "moe")
         and cfg.total_params() >= BIG_PARAMS)
        or seq_shard)
    return seq_shard, seq_parallel


def _spec_bytes(t: torch.Tensor, spec: shd.P, sizes: dict) -> int:
    """One device's bytes of `t` sharded by `spec`."""
    parts = 1
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                parts *= sizes[a]
    return t.numel() * t.element_size() // parts


def argument_bytes(arch: ArchSpec, shape: ShapeSpec, mesh,
                   dtype: torch.dtype = torch.bfloat16) -> int:
    """One device's bytes of a cell's step arguments, from the specs and
    the `meta` trees' shapes alone (any mesh: an AbstractMesh needs no
    process group); `run_cell`'s `memory.argument_bytes` measures the
    same on the placed DTensors."""
    cfg = arch.config
    sizes = shd.axis_sizes(mesh)
    batch = _meta(input_specs(arch, shape, dtype))
    if shape.kind == "train":
        trees = ((_abstract_state(cfg, dtype)[0], "state"), (batch, "batch"))
        total = 0
    else:
        trees = ((_abstract_params(cfg, dtype), "params"),
                 (_abstract_cache(cfg, shape.global_batch, shape.seq_len,
                                  dtype), "cache"), (batch, "batch"))
        total = POS_BYTES
    for tree, kind in trees:
        specs = _leaves(shd.tree_specs(tree, mesh, kind, cfg=cfg))
        leaves = _leaves(shd.map_tree(lambda _, t: t, tree))
        total += sum(_spec_bytes(t, s, sizes) for t, s in zip(leaves, specs)
                     if isinstance(t, torch.Tensor))
    return total


def _leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples (a spec is one)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, shd.P):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def run_cell(arch_name: str, arch: ArchSpec, shape: ShapeSpec,
             mesh, mesh_name: str, accum_steps: int = 0,
             dtype: torch.dtype = torch.bfloat16) -> dict:
    """One cell's step on `mesh` (parameters and the modality input in
    `dtype`; the reference's bfloat16 by default); see the module's
    docstring for what it records."""
    cfg = arch.config
    t0 = time.time()
    cell = {"arch": arch_name, "shape": shape.name, "mesh": mesh_name,
            "kind": shape.kind}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        cell.update(status="skipped", reason=why)
        return cell

    specs = input_specs(arch, shape, dtype)
    has_xkv = "xkv" in specs
    batch = _meta(specs)
    batch = shd.place(batch, shd.named(shd.tree_specs(batch, mesh, "batch"),
                                       mesh))
    extra_args = 0
    if shape.kind == "train":
        state, ocfg = _abstract_state(cfg, dtype)
        state = shd.place(state, shd.named(
            shd.tree_specs(state, mesh, "state", cfg=cfg), mesh))
        if accum_steps == 0:
            accum_steps = auto_accum_steps(cfg, shape, mesh)
        cell["accum_steps"] = accum_steps
        step_fn = ts.make_train_step(cfg, ocfg, accum_steps=accum_steps,
                                     remat=True, has_xkv=has_xkv,
                                     mesh=mesh,
                                     data_axes=shd.data_axes(mesh))
        args = (state, batch)

        def run():
            return step_fn(state, batch)
    else:
        params = _abstract_params(cfg, dtype)
        shd.place(params, shd.named(
            shd.tree_specs(params, mesh, "params", cfg=cfg), mesh))
        cache = _abstract_cache(cfg, shape.global_batch, shape.seq_len,
                                dtype)
        cache = shd.place(cache, shd.named(
            shd.tree_specs(cache, mesh, "cache"), mesh))
        extra_args = POS_BYTES
        args = (params, cache, batch)
        if shape.kind == "prefill":
            fn = ts.make_prefill_step(cfg, has_xkv=has_xkv)

            def run():
                return fn(params, cache, batch["tokens"], batch.get("xkv"))
        else:
            fn = ts.make_decode_step(cfg)

            def run():
                return fn(params, cache, batch["tokens"])

    seq_shard, seq_parallel = hint_flags(cfg, shape, mesh)
    cell["seq_shard_attention"] = seq_shard
    cell["seq_parallel"] = seq_parallel
    arg_bytes = costanalysis.local_bytes(args) + extra_args
    mode = costanalysis.CostMode()
    mode.track_args(args)
    try:
        with sharding_hints(mesh, shd.data_axes(mesh), seq_shard=seq_shard,
                            seq_parallel=seq_parallel), mode:
            out = run()
    except Exception as exc:   # noqa: BLE001 - a cell records its failure
        cell.update(status="error", error=f"{type(exc).__name__}: {exc}",
                    trace=traceback.format_exc()[-2000:])
        return cell
    cost = mode.cost
    cell.update(
        status="ok",
        step_s=round(time.time() - t0, 2),
        memory={
            "argument_bytes": arg_bytes,
            "output_bytes": costanalysis.local_bytes(out) + extra_args,
            "temp_bytes": mode.peak_bytes,
        },
        flops_per_device=cost.flops,
        bytes_per_device=cost.bytes,
        collectives={**cost.collective_bytes,
                     "count": cost.collective_count,
                     "total": cost.total_collective_bytes},
        params_total=cfg.total_params(),
        params_active=cfg.total_active_params(),
        tokens=specs["tokens"].shape[0] * specs["tokens"].shape[1],
        devices=int(mesh.size()),
    )
    return cell


def quick(arch: ArchSpec, shape: ShapeSpec) -> tuple[ArchSpec, ShapeSpec]:
    """--quick: the reduced config at a small shape (seq <= 256, batch
    <= 32)."""
    return (dataclasses.replace(arch, config=arch.config.reduced()),
            dataclasses.replace(shape, seq_len=min(shape.seq_len, 256),
                                global_batch=min(shape.global_batch, 32)))


def main(argv: list[str] | None = None) -> list[dict]:
    """Runs the cells, writes one JSON per cell under --out, prints a line
    per cell and the totals, and returns the cells; exits 1 if a cell
    failed."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--accum-steps", type=int, default=0,
                    help="0 = auto (~2 sequences/device/microstep)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="smoke: reduced configs, small shapes")
    args = ap.parse_args(argv)

    archs = list(REGISTRY) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    results = []
    for multi in meshes:
        mesh = make_production_mesh(multi_pod=multi)
        mesh_name = "multi_pod_2x16x16" if multi else "single_pod_16x16"
        for a in archs:
            for s in shapes:
                arch, shape = REGISTRY[a], SHAPES[s]
                if args.quick:
                    arch, shape = quick(arch, shape)
                fname = os.path.join(args.out,
                                     f"{mesh_name}__{a}__{s}.json")
                if args.skip_existing and os.path.exists(fname):
                    print(f"[skip existing] {fname}")
                    continue
                t0 = time.time()
                cell = run_cell(a, arch, shape, mesh, mesh_name,
                                accum_steps=args.accum_steps)
                cell["wall_s"] = round(time.time() - t0, 2)
                with open(fname, "w") as f:
                    json.dump(cell, f, indent=1)
                stat = cell["status"]
                extra = ""
                if stat == "ok":
                    mem = cell["memory"]
                    extra = (f" args={mem['argument_bytes']/2**30:.2f}GiB/dev "
                             f"flops/dev={cell['flops_per_device']:.3g} "
                             f"coll={cell['collectives']['count']:.0f}")
                elif stat == "error":
                    extra = " " + cell["error"][:120]
                elif stat == "skipped":
                    extra = " " + cell["reason"]
                print(f"[{stat:7s}] {mesh_name} {a} {s} "
                      f"({cell['wall_s']}s){extra}", flush=True)
                results.append(cell)
    bad = [c for c in results if c["status"] == "error"]
    print(f"\n{len(results)} cells: "
          f"{sum(c['status'] == 'ok' for c in results)} ok, "
          f"{sum(c['status'] == 'skipped' for c in results)} skipped, "
          f"{len(bad)} errors")
    if bad:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
