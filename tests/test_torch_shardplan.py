"""The port's sharded step held per device against the reference's
partitioning, on the 20 quick dry-run cells: the ten architectures
reduced, at train_4k and decode_32k (batch <= 32, seq <= 256), on the
2 x 16 x 16 multi-pod mesh of 512 devices.

Each case runs one architecture's two cells through the reference's dry
run (`python -m repro.launch.dryrun`: its compiled, partitioned HLO on 512
fake XLA host devices) and through the port's (`python -m
repro_torch.launch.dryrun`: the eager step on DTensors over a fake
process group of 512 ranks), each in a process of its own (the fake
group and XLA's host device count are process-global), and holds each
cell of the port to at most `FLOPS_BOUND` times the reference's FLOPs
per device and `BYTES_BOUND` times its collective bytes per device.  It
also holds chip_smoke.py's table of the reference's figures, which the
card (no JAX there) checks the port against in [dist] (d), to the live
run.

The cases are split over this file and test_torch_shardplan2.py
(`ARCHS`, `ARCHS2`), so that neither holds one test worker for long.
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import REGISTRY

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ("train_4k", "decode_32k")
FLOPS_BOUND, BYTES_BOUND = 1.1, 2.0
ARCHS = ("jamba-1.5-large-398b", "yi-6b", "qwen2.5-14b", "qwen3-0.6b")
ARCHS2 = ("phi3-mini-3.8b", "mamba2-130m", "llama-3.2-vision-11b",
          "whisper-large-v3", "grok-1-314b", "granite-moe-1b-a400m")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dry_runs(arch: str, tmp_path: Path) -> dict[str, tuple[dict, dict]]:
    """{shape: (reference cell, port cell)} of `arch`'s quick cells on
    the multi-pod mesh, the two dry runs started together."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    procs = {}
    for pkg in ("repro", "repro_torch"):
        out = tmp_path / pkg
        procs[pkg] = (out, subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.launch.dryrun", "--quick",
             "--arch", arch, "--shape", ",".join(SHAPES), "--mesh",
             "multi", "--out", str(out)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for pkg, (_, proc) in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, (pkg, stdout[-2000:], stderr[-2000:])

    def cell(pkg, shape):
        out = procs[pkg][0] / f"multi_pod_2x16x16__{arch}__{shape}.json"
        data = json.loads(out.read_text())
        assert data["status"] == "ok", (pkg, data)
        assert data["devices"] == 512
        return data

    return {s: (cell("repro", s), cell("repro_torch", s)) for s in SHAPES}


def check_arch(arch: str, tmp_path: Path) -> None:
    """`arch`'s two cells within the bounds, and chip_smoke.py's table of
    the reference's figures equal to the live run."""
    table = _chip_smoke().DIST_REF
    for shape, (ref, port) in _dry_runs(arch, tmp_path).items():
        tag = (arch, shape)
        ref_flops = ref["flops_per_device"]
        ref_bytes = ref["collectives"]["total"]
        assert table[tag] == (ref_flops, ref_bytes), tag
        assert 0 < port["flops_per_device"] <= FLOPS_BOUND * ref_flops, (
            tag, port["flops_per_device"], ref_flops)
        assert 0 < port["collectives"]["total"] <= BYTES_BOUND * \
            ref_bytes, (tag, port["collectives"], ref["collectives"])


def test_cases_cover_every_cell_of_the_table():
    """The two files' architectures are the registry's, and chip_smoke.py
    checks the 20 cells they run, at the same bounds."""
    mod = _chip_smoke()
    assert sorted(ARCHS + ARCHS2) == sorted(REGISTRY)
    assert set(mod.DIST_REF) == {(a, s) for a in REGISTRY for s in SHAPES}
    assert mod.DIST_QUICK_SHAPES == SHAPES
    assert (mod.DIST_FLOPS_BOUND, mod.DIST_BYTES_BOUND) == (FLOPS_BOUND,
                                                            BYTES_BOUND)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_within_bounds_of_reference(arch, tmp_path):
    check_arch(arch, tmp_path)
