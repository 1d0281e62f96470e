"""The port's slice end to end on the CPU: `delta_fast` against the JAX
reference's, `plan()` determinism and device rules, and the rule that the
port imports nothing of JAX or of `repro`.

Tolerance: the GA's final makespan comes from the exact numpy DES on both
sides, so equal topologies give equal makespans; rel 5e-5 is the float32
engine bound of tests/test_des_jax.py, for a re-rank that sees slightly
different float32 scores."""
import ast
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
from repro_torch.core.api import (METHODS, ROBUST_METHODS, FailureModel,
                                  FleetPlanResult, PlanRequest, compare,
                                  plan)
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
    res = compare(dag4, methods=METHODS[:4],
                  ga_options=GAOptions(**_small(pop_size=8,
                                                max_generations=2),
                                       des_options=CPU))
    assert list(res) == list(METHODS[:4])
    for r in res.values():
        assert r.feasible and np.isfinite(r.makespan)
        assert 0.0 < r.nct < np.inf and r.total_ports == int(r.x.sum())


def test_plan_without_cuda_raises(dag4, monkeypatch):
    """No CUDA device and none named: plan() refuses instead of running on
    the CPU, for every method and kind, those whose first stage is the
    host's MILP too; so does compare()."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    requests = [PlanRequest(dag=dag4, method=m) for m in METHODS]
    requests += [PlanRequest(ensemble=DagEnsemble([dag4]), method=m)
                 for m in ROBUST_METHODS]
    requests += [PlanRequest(dag=dag4, failure=FailureModel()),
                 PlanRequest(dag=dag4, failure=FailureModel(resilient=True)),
                 PlanRequest(fleet_requests=[("a", port_job(2))])]
    for req in requests:
        with pytest.raises(RuntimeError, match="CUDA device"):
            plan(req)
    with pytest.raises(RuntimeError, match="CUDA device"):
        compare(dag4)


def test_later_slices_raise_not_implemented(dag4):
    """No kind waits for a later slice any more: the fleet kind plans on
    the named device and returns a `FleetPlanResult`; an unknown method
    is still refused."""
    res = plan(PlanRequest(fleet_requests=[("a", port_job(2))],
                           ga_options=GAOptions(**_small()),
                           des_options=CPU))
    assert isinstance(res, FleetPlanResult)
    assert set(res.report["tenants"]) == {"a"}
    assert res.planner.device == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown method"):
        plan(PlanRequest(dag=dag4, method="nope", des_options=CPU))
    with pytest.raises(ValueError, match="unknown method"):
        plan(PlanRequest(ensemble=DagEnsemble([dag4]), method="nope",
                         des_options=CPU))


def test_port_imports_no_jax_and_no_reference():
    """Every module of the port imports, in a fresh interpreter, without
    pulling in jax, ml_dtypes (which the card's machine lacks) or any
    module of the JAX package."""
    code = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "ml_dtypes"))
             or m == "repro" or m.startswith("repro."))
assert len(names) >= 20, names
new = {"repro_torch.launch.mesh", "repro_torch.distributed.sharding",
       "repro_torch.distributed.compression",
       "repro_torch.launch.costanalysis", "repro_torch.launch.dryrun",
       "repro_torch.core._ga_legacy", "repro_torch.analysis",
       "repro_torch.analysis.__main__", "repro_torch.analysis.engine",
       "repro_torch.analysis.report", "repro_torch.analysis.baseline",
       "repro_torch.analysis.check_baseline", "repro_torch.analysis.rules"}
new |= {f"repro_torch.analysis.rules.{r}" for r in (
    "fields", "mutation", "solver", "facade", "cachekey", "dtype", "jit",
    "fallback", "precision")}
assert new <= set(names), sorted(new - set(names))
assert not bad, bad
print("ok", len(names))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_sentinel_imports_only_the_standard_library():
    """`repro_torch.analysis` and every module of it, loaded in a fresh
    interpreter without the parent package's own import of torch, and run
    over a fixture, import nothing outside the standard library but
    themselves (no torch, no jax, nothing of the JAX package)."""
    code = f"""
import importlib, pkgutil, sys, types
pkg = types.ModuleType("repro_torch")
pkg.__path__ = [{str(REPO / "src" / "repro_torch")!r}]
sys.modules["repro_torch"] = pkg
before = set(sys.modules)
import repro_torch.analysis as sentinel
names = [m.name for m in pkgutil.walk_packages(sentinel.__path__,
                                               "repro_torch.analysis.")]
for name in names:
    importlib.import_module(name)
found = sentinel.analyze_paths(
    [{str(REPO / "tests" / "sentinel_fixtures" / "torch")!r}],
    root={str(REPO)!r})
assert len({{f.rule for f in found}}) == 11, found
new = sorted(set(sys.modules) - before)
bad = [m for m in new if m.split(".")[0] not in sys.stdlib_module_names
       and not (m == "repro_torch.analysis"
                or m.startswith("repro_torch.analysis."))]
assert not bad, bad
assert len(names) >= 14, names
print("ok", len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_sources_import_no_jax_and_no_reference_at_any_depth():
    """Every import statement of every source file of the port, at any
    depth (a function body's too, which importing a module never runs),
    names neither jax, ml_dtypes nor the JAX package."""
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    assert len(files) >= 30, files
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "repro", "ml_dtypes"):
                    bad.append(f"{path.relative_to(REPO)}:{node.lineno} "
                               f"{name}")
    assert not bad, bad
