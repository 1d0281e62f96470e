"""The port's slice end to end on the CPU: `delta_fast` against the JAX
reference's, `plan()` determinism and device rules, and the rule that the
port imports nothing of JAX or of `repro`.

Tolerance: the GA's final makespan comes from the exact numpy DES on both
sides, so equal topologies give equal makespans; rel 5e-5 is the float32
engine bound of tests/test_des_jax.py, for a re-rank that sees slightly
different float32 scores."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import gpt7b_job
from repro.core import ga as jax_ga
from repro.core.des_jax import DESOptions as JaxDESOptions
from repro.core.schedule import build_comm_dag as jax_build_comm_dag
from repro_torch.core.api import METHODS, PlanRequest, compare, plan
from repro_torch.core.dag import DagEnsemble
from repro_torch.core.des_torch import DESOptions
from repro_torch.core.ga import GAOptions, delta_fast
from repro_torch.core.schedule import build_comm_dag
from test_torch_des import port_job

REPO = Path(__file__).resolve().parents[1]
CPU = DESOptions(device="cpu")


def _small(**kw) -> dict:
    base = dict(seed=0, pop_size=12, max_generations=5, patience=10**9,
                time_limit=1e9)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def dag4():
    return build_comm_dag(port_job(4))


def test_delta_fast_matches_reference(dag4):
    """Same seed, same GA options: the port's delta_fast on the torch DES
    returns the reference's topology (JAX DES, ref backend)."""
    ref = jax_ga.delta_fast(jax_build_comm_dag(gpt7b_job(4)),
                            jax_ga.GAOptions(**_small(), backend="jax",
                                             des_options=JaxDESOptions(
                                                 backend="ref")))
    got = delta_fast(dag4, GAOptions(**_small(), backend="torch",
                                     des_options=CPU))
    np.testing.assert_array_equal(got.x, ref.x)
    assert got.makespan == pytest.approx(ref.makespan, rel=5e-5)
    assert got.generations == ref.generations == 5
    assert got.evaluations == ref.evaluations
    assert got.feasible and ref.feasible


def test_plan_is_deterministic(dag4):
    req = PlanRequest(dag=dag4, method="delta-fast",
                      ga_options=GAOptions(**_small(pop_size=8,
                                                    max_generations=3)),
                      des_options=CPU)
    a, b = plan(req), plan(req)
    np.testing.assert_array_equal(a.x, b.x)
    assert a.makespan == b.makespan and a.nct == b.nct
    assert a.details["generations"] == 3
    assert np.isfinite(a.makespan) and 0.0 < a.nct < np.inf
    # the caller's options object is not mutated by the overlay
    assert req.ga_options.des_options is None


def test_compare_baselines_and_delta_fast(dag4):
    res = compare(dag4, ga_options=GAOptions(**_small(pop_size=8,
                                                      max_generations=2),
                                             des_options=CPU))
    assert list(res) == list(METHODS)
    for r in res.values():
        assert r.feasible and np.isfinite(r.makespan)
        assert 0.0 < r.nct < np.inf and r.total_ports == int(r.x.sum())


def test_plan_without_cuda_raises(dag4, monkeypatch):
    """No CUDA device and none named: plan() refuses instead of running on
    the CPU, for every method."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for method in METHODS:
        with pytest.raises(RuntimeError, match="CUDA device"):
            plan(PlanRequest(dag=dag4, method=method))


def test_later_slices_raise_not_implemented(dag4):
    for method in ("delta-topo", "delta-joint", "delta-joint-hotstart",
                   "delta-robust"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            plan(PlanRequest(dag=dag4, method=method, des_options=CPU))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        plan(PlanRequest(ensemble=DagEnsemble([dag4])))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        plan(PlanRequest(fleet_requests=[("a", port_job(2))]))
    with pytest.raises(ValueError, match="unknown method"):
        plan(PlanRequest(dag=dag4, method="nope", des_options=CPU))


def test_port_imports_no_jax_and_no_reference():
    """Every module of the port imports, in a fresh interpreter, without
    pulling in jax or any module of the JAX package."""
    code = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
assert len(names) >= 20, names
assert not bad, bad
print("ok", len(names))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
