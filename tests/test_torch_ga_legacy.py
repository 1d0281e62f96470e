"""The port's legacy GA (`repro_torch.core._ga_legacy`) against the
reference's (`repro.core._ga_legacy`), the mirrors of
tests/test_ga_vectorized.py's legacy cases: the same x and makespan from
the same seed on gpt-7b (the port's fitness on `TorchDES` on the CPU, the
reference's on `JaxDES`), the same `trim_ports` topology, the same
`exhaustive_search` optimum, and the port's vectorized GA no worse than
its legacy one.  A generation cap stands in for the wall-clock limit, so
that both runs take the same number of generations."""
from __future__ import annotations

import numpy as np
import pytest

from conftest import gpt7b_job
from repro.core import _ga_legacy as jax_legacy
from repro.core.schedule import build_comm_dag as jax_build_comm_dag
from repro_torch.core import _ga_legacy as legacy
from repro_torch.core.des import DESProblem, simulate
from repro_torch.core.des_torch import DESOptions
from repro_torch.core.ga import GAOptions, TopologySpace, delta_fast
from repro_torch.core.schedule import build_comm_dag
from test_torch_des import port_job

CPU = DESOptions(device="cpu")
CAP = dict(max_generations=25, patience=20, time_limit=1e9)


@pytest.fixture(scope="module")
def dags():
    return build_comm_dag(port_job(4)), jax_build_comm_dag(gpt7b_job(4))


@pytest.mark.parametrize("backend,seed", [("torch", 3), ("numpy", 3),
                                          ("torch", 0)])
def test_legacy_delta_fast_matches_reference(dags, backend, seed):
    dag, jdag = dags
    got = legacy.delta_fast(dag, legacy.GAOptions(
        seed=seed, backend=backend, des_options=CPU, **CAP))
    want = jax_legacy.delta_fast(jdag, jax_legacy.GAOptions(
        seed=seed, backend="jax" if backend == "torch" else "numpy",
        **CAP))
    assert (got.x == want.x).all()
    assert got.makespan == pytest.approx(want.makespan, rel=1e-12)
    assert got.generations == want.generations
    assert got.evaluations == want.evaluations
    assert got.feasible and want.feasible


def test_legacy_device_backend_builds_the_torch_engine(dags):
    fit = legacy._Fitness(dags[0], legacy.TopologySpace(dags[0]),
                          legacy.GAOptions(backend="torch",
                                           des_options=CPU))
    assert fit._jd is not None
    numpy_only = legacy._Fitness(dags[0], legacy.TopologySpace(dags[0]),
                                 legacy.GAOptions(backend="numpy"))
    assert numpy_only._jd is None
    # a CUDA engine asked for without a card raises: no fallback
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            legacy._Fitness(dags[0], legacy.TopologySpace(dags[0]),
                            legacy.GAOptions(backend="torch"))


def test_legacy_trim_ports_matches_reference(dags):
    dag, jdag = dags
    space = TopologySpace(dag)
    g_fat, ok = space.repair(space.xbar.copy(), np.random.default_rng(0))
    assert ok
    x_fat = space.to_matrix(g_fat)
    got = legacy.trim_ports(dag, x_fat)
    want = jax_legacy.trim_ports(jdag, x_fat)
    assert (got == want).all()
    assert int(got.sum()) < int(x_fat.sum())
    problem = DESProblem(dag)
    assert simulate(problem, got).makespan <= \
        simulate(problem, x_fat).makespan * (1 + 1e-6)


def test_legacy_exhaustive_search_matches_reference():
    dag = build_comm_dag(port_job(2))
    jdag = jax_build_comm_dag(gpt7b_job(2))
    x, ms, count = legacy.exhaustive_search(dag)
    jx, jms, jcount = jax_legacy.exhaustive_search(jdag)
    assert (x == jx).all() and count == jcount
    assert ms == pytest.approx(jms, rel=1e-12)


def test_vectorized_no_worse_than_legacy(dags):
    """The port's vectorized GA against the port's legacy one, both on
    the torch fitness (tests/test_ga_vectorized.py's bound)."""
    dag = dags[0]
    kw = dict(seed=3, backend="torch", des_options=CPU, **CAP)
    new = delta_fast(dag, GAOptions(**kw))
    old = legacy.delta_fast(dag, legacy.GAOptions(**kw))
    assert new.feasible
    assert new.makespan <= old.makespan * (1 + 1e-9)
