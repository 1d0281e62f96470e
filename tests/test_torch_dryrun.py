"""The port's dry run (`repro_torch.launch.dryrun`, `launch.costanalysis`)
against the reference's (`repro.launch.dryrun`, `launch.hloanalysis`).

- the cost model's counts on a 2 x 4 fake mesh, derived by hand (the
  reference's 7-trip scan case, eagerly: its counts differ from GSPMD's,
  see the test);
- the reference's HLO line parser, copied;
- every (arch, shape, mesh) cell's flags (accum_steps,
  seq_shard_attention, seq_parallel, skipped or not) and argument bytes
  against the reference's, from its specs and `jax.eval_shape` shapes;
- FLOPs on a 1 x 1 mesh against the reference's analysis of its compiled
  step (one CPU device) within rel 1e-2, for the ten architectures;
- the reference quick test's 6 cells on the 512-rank mesh, each
  architecture in a process of its own (the fake process group is
  process-global).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import REGISTRY as JREG
from repro.configs import SHAPES as JSHAPES
from repro.configs import shape_applicable as jshape_applicable
from repro.distributed import sharding as jshd
from repro.launch.hloanalysis import analyze
from repro.models import model as JM
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch.configs import REGISTRY, SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single_pod_16x16": ((16, 16), ("data", "model")),
          "multi_pod_2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
QUICK_ARCHS = ("qwen3-0.6b", "granite-moe-1b-a400m", "mamba2-130m")
QUICK_SHAPES = ("train_4k", "decode_32k")
BIG_PARAMS = 100e9      # the reference dry run's bf16-moment threshold


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"),
            "JAX_PLATFORMS": "cpu"}


_COST_PROBE = textwrap.dedent("""
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.costanalysis import CostMode

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    mesh = DeviceMesh("cuda", torch.arange(8).reshape(2, 4),
                      mesh_dim_names=("data", "model"))

    def put(shape, placements):
        local = list(shape)
        for p, n in zip(placements, (2, 4)):
            if isinstance(p, Shard):
                local[p.dim] //= n
        return DTensor.from_local(
            torch.empty(local, device="meta"), mesh, placements,
            run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())

    x = put((16, 64), [Shard(0), Replicate()])     # P("data", None)
    w = put((64, 64), [Replicate(), Shard(1)])     # P(None, "model")
    with CostMode() as mode:
        c = x
        for _ in range(7):
            c = torch.tanh(c @ w)
        c.sum().full_tensor()
    cost = mode.cost
    print("COST", cost.flops, cost.collective_bytes["all-gather"],
          cost.collective_bytes["all-reduce"], cost.collective_count)
""")


def test_cost_model_counts_on_a_fake_mesh(tmp_path):
    """The reference's analyzer case (tests/test_dryrun.py: x (16, 64) on
    data, w (64, 64) on model, 7 trips of tanh(c @ w), then the sum) run
    eagerly on DTensors.  Per device, each trip multiplies the local
    (8, 64) rows by the local (64, 16) columns: 2 * 8 * 16 * 64 FLOPs, 7
    times, as the reference counts.  The collectives are not GSPMD's:
    trip 1 needs none (x is replicated on model), and each later trip
    all-gathers c's model-sharded (8, 16) columns into its (8, 64)
    contraction operand: 6 all-gathers of 8 * 64 float32 (the reference
    expects 7); the scalar sum, partial on both mesh dims, takes one
    all-reduce of 4 bytes per dim."""
    script = tmp_path / "probe.py"
    script.write_text(_COST_PROBE)
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, cwd=ROOT, timeout=120, env=_env())
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(l for l in out.stdout.splitlines() if l.startswith("COST"))
    flops, gather, reduce, count = (float(v) for v in line.split()[1:])
    assert flops == 7 * 2 * 8 * 16 * 64
    assert gather == 6 * 8 * 64 * 4
    assert reduce == 2 * 4
    assert count == 6 + 2


HLO = """
  %ag = f32[8,64]{1,0} all-gather(f32[8,16]{1,0} %p), dimensions={1}
  %ars = (f32[4]{0}, bf16[2,3]{1,0}) all-reduce-start(%a, %b), to_apply=%add
  %rs = bf16[16]{0} reduce-scatter(bf16[64]{0} %q), dimensions={0}
  %a2a = s8[4,4]{1,0} all-to-all(s8[4,4]{1,0} %r), dimensions={0}
  %cp = u32[] collective-permute(u32[] %s), source_target_pairs={{0,1}}
  %n = f32[2]{0} add(f32[2]{0} %u, f32[2]{0} %v)
  no equals all-gather( here
"""


def test_collective_bytes_parser_is_the_reference():
    os.environ.setdefault("XLA_FLAGS", "")
    flags = os.environ["XLA_FLAGS"]
    try:
        # the reference module sets XLA_FLAGS on import (512 host
        # devices); jax is initialised already, so it moves nothing here
        from repro.launch import dryrun as jdryrun
    finally:
        os.environ["XLA_FLAGS"] = flags
    got = dryrun.collective_bytes(HLO)
    assert got == jdryrun.collective_bytes(HLO)
    assert got == {"all-gather": 8 * 64 * 4, "all-reduce": 16 + 12,
                   "reduce-scatter": 32, "all-to-all": 16,
                   "collective-permute": 4, "count": 5}


def _ref_bytes(tree, specs, mesh) -> int:
    """One device's bytes of the reference's abstract tree under its
    specs."""
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        parts = 1
        for e in spec:
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    parts *= mesh.shape[a]
        total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize // parts
    return total


def _ref_cell(arch: str, shape_name: str, mesh) -> dict:
    """The reference dry run's per-cell decisions (`run_cell`,
    repro/launch/dryrun.py) and the bytes of its step's arguments, from
    its sharding rules and `jax.eval_shape` shapes: no lowering."""
    cfg, shape = JREG[arch].config, JSHAPES[shape_name]
    ok, _ = jshape_applicable(cfg, shape)
    if not ok:
        return {"status": "skipped"}
    key = jax.random.PRNGKey(0)
    B, S = shape.global_batch, shape.seq_len
    xl = cfg.enc_tokens if cfg.encoder_layers else (
        cfg.num_image_tokens if cfg.cross_attn_every else 0)
    f = jax.ShapeDtypeStruct
    if shape.kind == "decode":
        specs = {"tokens": f((B, 1), jnp.int32)}
    else:
        specs = {"tokens": f((B, S), jnp.int32)}
        if shape.kind == "train":
            specs["labels"] = f((B, S), jnp.int32)
        if xl:
            specs["xkv"] = f((B, xl, cfg.d_model), jnp.bfloat16)
    total = _ref_bytes(specs, jax.tree.map(
        lambda s: jshd.batch_spec(s.shape, mesh), specs), mesh)
    out = {"status": "ok"}
    if shape.kind == "train":
        sdt = jnp.bfloat16 if cfg.total_params() >= BIG_PARAMS \
            else jnp.float32
        state = jax.eval_shape(lambda: jts.init_train_state(
            cfg, jopt.AdamWConfig(state_dtype=sdt), key,
            dtype=jnp.bfloat16))
        total += _ref_bytes(state, jshd.tree_specs(state, mesh, "state",
                                                   cfg=cfg), mesh)
        dsz = int(np.prod([mesh.shape[a] for a in jshd.data_axes(mesh)]))
        target = 1 if cfg.total_params() >= BIG_PARAMS else 2
        out["accum_steps"] = max(1, B // (dsz * target))
    else:
        params = jax.eval_shape(
            lambda: JM.init_params(cfg, key, dtype=jnp.bfloat16))
        cache = jax.eval_shape(lambda: JM.init_cache(
            cfg, B, S, dtype=jnp.bfloat16, enc_len=xl))
        total += _ref_bytes(params, jshd.tree_specs(params, mesh, "params",
                                                    cfg=cfg), mesh)
        total += _ref_bytes(cache, jshd.tree_specs(cache, mesh, "cache"),
                            mesh)
    msize = mesh.shape["model"]
    seq_shard = bool(cfg.heads % msize) and shape.kind != "decode"
    out["seq_shard_attention"] = seq_shard
    out["seq_parallel"] = shape.kind == "train" and (
        (cfg.family in ("dense", "moe")
         and cfg.total_params() >= BIG_PARAMS) or seq_shard)
    out["argument_bytes"] = total
    return out


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_cells_decide_and_place_as_the_reference(arch):
    """All 80 cells (10 architectures x 4 shapes x 2 meshes, full size):
    the same skips, microbatching and hint flags, and the same bytes of
    the step's arguments on one device."""
    from jax.sharding import AbstractMesh as JaxAbstractMesh
    for mesh_name, (sizes, axes) in MESHES.items():
        mesh, jmesh = AbstractMesh(sizes, axes), JaxAbstractMesh(sizes,
                                                                 axes)
        for s in sorted(SHAPES):
            cfg, shape = REGISTRY[arch].config, SHAPES[s]
            want = _ref_cell(arch, s, jmesh)
            tag = (arch, s, mesh_name)
            ok, _ = dryrun.shape_applicable(cfg, shape)
            assert ("ok" if ok else "skipped") == want["status"], tag
            if not ok:
                continue
            if shape.kind == "train":
                assert dryrun.auto_accum_steps(cfg, shape, mesh) == \
                    want["accum_steps"], tag
            assert dryrun.hint_flags(cfg, shape, mesh) == (
                want["seq_shard_attention"], want["seq_parallel"]), tag
            assert dryrun.argument_bytes(REGISTRY[arch], shape, mesh) == \
                want["argument_bytes"], tag


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_flops_on_one_device_match_reference_hlo(arch):
    """A 1 x 1 mesh (a world-size-1 gloo group): the train cell at the
    quick shape (reduced config, batch 32 x seq 256 with the modality
    input where the architecture takes one, 16 microbatches, remat),
    FLOPs per device against the reference's `hloanalysis` of its
    compiled step on one CPU device.  The reference recomputes a period
    of more than one layer twice (its group and each layer are
    checkpointed): llama-3.2-vision's and jamba's steps count that work
    too."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, "cpu")
    rarch, shape = dryrun.quick(REGISTRY[arch], SHAPES["train_4k"])
    cell = dryrun.run_cell(arch, rarch, shape, mesh, "1x1")
    assert cell["status"] == "ok", cell.get("error")
    assert cell["devices"] == 1 and cell["accum_steps"] == 16
    assert cell["collectives"]["count"] == 0
    assert cell["memory"]["argument_bytes"] == dryrun.argument_bytes(
        rarch, shape, AbstractMesh((1, 1), ("data", "model")))
    jcfg = JREG[arch].config.reduced()
    ocfg = jopt.AdamWConfig()
    state = jax.eval_shape(lambda: jts.init_train_state(
        jcfg, ocfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16))
    batch = {k: jax.ShapeDtypeStruct((shape.global_batch, shape.seq_len),
                                     jnp.int32) for k in ("tokens",
                                                          "labels")}
    xl = dryrun._xkv_len(rarch.config)
    if xl:
        batch["xkv"] = jax.ShapeDtypeStruct(
            (shape.global_batch, xl, jcfg.d_model), jnp.bfloat16)
    step = jts.make_train_step(jcfg, ocfg, accum_steps=16, remat=True,
                               has_xkv=bool(xl))
    cost = analyze(jax.jit(step).lower(state, batch).compile().as_text())
    assert cell["flops_per_device"] == pytest.approx(cost.flops, rel=1e-2)


@pytest.mark.parametrize("arch", QUICK_ARCHS)
def test_quick_dryrun_subprocess(arch, tmp_path):
    """tests/test_dryrun.py::test_quick_dryrun_subprocess's cells on the
    2 x 16 x 16 mesh: each ends ok on 512 devices with FLOPs counted, and
    its measured argument bytes are the specs'."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--quick",
           "--arch", arch, "--shape", ",".join(QUICK_SHAPES),
           "--mesh", "multi", "--out", str(tmp_path)]
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                         timeout=240, env=_env())
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "0 errors" in out.stdout
    cells = sorted(tmp_path.glob("*.json"))
    assert len(cells) == len(QUICK_SHAPES)
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    for c in cells:
        data = json.loads(c.read_text())
        assert data["status"] == "ok", data
        assert data["flops_per_device"] > 0
        assert data["devices"] == 512
        rarch, shape = dryrun.quick(REGISTRY[arch], SHAPES[data["shape"]])
        assert data["memory"]["argument_bytes"] == \
            dryrun.argument_bytes(rarch, shape, mesh)
