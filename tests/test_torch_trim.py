"""The port's port trimming and DES engine cache on the CPU, against the
JAX reference.

Port trimming (`trim_ports`, `trim_ports_ensemble`): the batched sweep
(the torch DES scores every drop-one candidate in one call) must give the
serial sweep's topology, and the reference's, with the same port count
and the same sequence of accepted drops.  The engine cache
(`des_cache_stats`): the same sequence of simulator constructions gives
the reference's hits, misses, evictions and entries.  `DESOptions` reads
no environment: the reference's `REPRO_DES_*` variables move nothing.

Tolerances: topologies, port counts, drop sequences and cache counters
exact; makespans from the exact numpy DES on equal topologies exact."""
import dataclasses
import logging

import numpy as np
import pytest
import torch

from conftest import gpt7b_job
from repro.core import _ga_legacy as legacy
from repro.core import ga as jax_ga
from repro.core.cluster import ClusterSpec as JaxClusterSpec
from repro.core.dag import CommDAG as JaxCommDAG
from repro.core.dag import CommTask as JaxCommTask
from repro.core.dag import DagEnsemble as JaxDagEnsemble
from repro.core.dag import Dep as JaxDep
from repro.core.dag import make_virtual as jax_make_virtual
from repro.core.des import DESProblem as JaxDESProblem
from repro.core.des import simulate as jax_simulate
from repro.core import des_jax
from repro.core.schedule import build_comm_dag as jax_build_comm_dag
from repro_torch.core import ga as port_ga
from repro_torch.core.api import evaluate_on_ensemble
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.dag import CommDAG, CommTask, DagEnsemble, Dep, \
    make_virtual
from repro_torch.core.des import DESProblem, simulate
from repro_torch.core import des_torch
from repro_torch.core.des_torch import (DESOptions, EnsembleTorchDES,
                                        TorchDES, des_cache_clear,
                                        des_cache_stats)
from repro_torch.core.ga import (GAOptions, TopologySpace, delta_fast,
                                 trim_ports, trim_ports_ensemble)
from repro_torch.core.schedule import build_comm_dag
from test_torch_des import port_job
from test_torch_fleet import one_torch_thread  # noqa: F401

CPU = DESOptions(device="cpu")
JAX_REF = des_jax.DESOptions(backend="ref")
PORT_BACKEND = {"auto": "auto", "jax": "torch", "numpy": "numpy"}


@pytest.fixture(scope="module")
def dags():
    """gpt-7b with 4 microbatches (the reference tests' `dag`) in both
    packages."""
    return build_comm_dag(port_job(4)), jax_build_comm_dag(gpt7b_job(4))


def _fat(dag) -> np.ndarray:
    """The reference tests' fat start: X-bar repaired into the budgets."""
    space = TopologySpace(dag)
    g, ok = space.repair(space.xbar.copy(), np.random.default_rng(0))
    assert ok
    return space.to_matrix(g)


def _accepted(module, monkeypatch) -> list[tuple[np.ndarray, float]]:
    """Record every (topology, makespan) that `module.simulate` returns;
    `_drops` picks the accepted drops out of them."""
    calls: list[tuple[np.ndarray, float]] = []
    inner = module.simulate

    def recording(problem, x, *a, **kw):
        res = inner(problem, x, *a, **kw)
        calls.append((np.array(x, copy=True), res.makespan))
        return res
    monkeypatch.setattr(module, "simulate", recording)
    return calls


def _drops(calls, budget: float) -> list[np.ndarray]:
    """The topologies certified within `budget` after the sweep's first
    (base) call: in a single-DAG sweep each one is an accepted drop, in
    order."""
    return [x for x, ms in calls[1:] if ms <= budget]


# ------------------------------------------------- trim_ports (single DAG)
@pytest.mark.parametrize("backend", ["auto", "jax", "numpy"])
def test_trim_ports_identical_to_legacy(dags, backend, monkeypatch):
    """Mirror of tests/test_ga_vectorized.py:112: the batched sweep equals
    the serial greedy sweep and the reference's, with the same accepted
    drops in the same order in both packages."""
    dag, ref = dags
    x_fat = _fat(dag)
    base = simulate(DESProblem(dag), x_fat).makespan
    budget = base * (1 + 1e-6)
    port_calls = _accepted(port_ga, monkeypatch)
    got = trim_ports(dag, x_fat, backend=PORT_BACKEND[backend],
                     options=CPU)
    ref_calls = _accepted(jax_ga, monkeypatch)
    want = jax_ga.trim_ports(ref, x_fat, backend=backend)
    serial = legacy.trim_ports(ref, x_fat)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, serial)
    assert int(got.sum()) == int(want.sum()) < int(x_fat.sum())
    got_drops, want_drops = _drops(port_calls, budget), \
        _drops(ref_calls, budget)
    assert len(got_drops) == len(want_drops) > 0
    for a, b in zip(got_drops, want_drops):
        np.testing.assert_array_equal(a, b)
    assert simulate(DESProblem(dag), got).makespan \
        == jax_simulate(JaxDESProblem(ref), want).makespan


def test_trim_ports_keeps_makespan(dags):
    """Mirror of tests/test_ga_vectorized.py:128: trimming a GA plan keeps
    its makespan, in both packages, to the same topology."""
    dag, ref = dags
    kw = dict(seed=1, pop_size=12, max_generations=6, patience=10**9,
              time_limit=1e9)
    ga = delta_fast(dag, GAOptions(**kw, des_options=CPU))
    ref_ga = jax_ga.delta_fast(ref, jax_ga.GAOptions(
        **kw, backend="jax", des_options=JAX_REF))
    np.testing.assert_array_equal(ga.x, ref_ga.x)
    trimmed = trim_ports(dag, ga.x, options=CPU)
    np.testing.assert_array_equal(trimmed, jax_ga.trim_ports(ref, ref_ga.x))
    problem = DESProblem(dag)
    assert trimmed.sum() <= ga.x.sum()
    assert simulate(problem, trimmed).makespan <= ga.makespan * (1 + 1e-5)


def test_trim_ports_batched_engine_is_the_options_one(dags, monkeypatch):
    """The batched sweep builds its engine from the options passed in and
    runs its rounds on it; with no device named and no CUDA device it
    raises instead of trimming on the CPU, and an unknown backend is
    refused."""
    dag, _ = dags
    x_fat = _fat(dag)
    built = []
    inner = port_ga.TorchDES

    def spy(problem, options=None, **kw):
        built.append(options)
        return inner(problem, options=options, **kw)
    monkeypatch.setattr(port_ga, "TorchDES", spy)
    trim_ports(dag, x_fat, backend="torch", options=CPU)
    assert built == [CPU]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        trim_ports(dag, x_fat, backend="torch")
    with pytest.raises(ValueError, match="unknown trim backend"):
        trim_ports(dag, x_fat, backend="jax", options=CPU)


# --------------------------------------------------- trim_ports_ensemble
def test_trim_ports_ensemble():
    """Mirror of tests/test_robust.py:225 on its sequence-length mix:
    certified against every member, locally minimal, and the reference's
    topology."""
    dag_a = build_comm_dag(port_job(3))
    dag_b = build_comm_dag(port_job(2, micro_tokens=16384))
    ens = DagEnsemble([dag_a, dag_b])
    ref_ens = JaxDagEnsemble([jax_build_comm_dag(gpt7b_job(3)),
                              jax_build_comm_dag(gpt7b_job(
                                  2, micro_tokens=16384))])
    space = TopologySpace.for_ensemble(ens)
    g_fat, ok = space.repair(space.xbar.copy(), np.random.default_rng(0))
    assert ok
    x_fat = space.to_matrix(g_fat)
    before = evaluate_on_ensemble(ens, x_fat)
    trimmed = trim_ports_ensemble(ens, x_fat, options=CPU)
    after = evaluate_on_ensemble(ens, trimmed)
    assert trimmed.sum() <= x_fat.sum()
    assert (trimmed == trimmed.T).all()
    assert (after <= before * (1 + 1e-5)).all()
    assert (trim_ports_ensemble(ens, trimmed, options=CPU)
            == trimmed).all()
    np.testing.assert_array_equal(
        trimmed, jax_ga.trim_ports_ensemble(ref_ens, x_fat))
    # the batched sweep on the torch engine lands on the same topology
    np.testing.assert_array_equal(
        trim_ports_ensemble(ens, x_fat, backend="torch", options=CPU),
        trimmed)


def _wide(make_virtual, CommTask, Dep, CommDAG, cluster, volumes,
          pods=None):
    """One wide member: one task per pod pair of `pods`, all ready at 0."""
    P = cluster.num_pods
    pods = list(range(P)) if pods is None else pods
    tasks, deps = [make_virtual()], []
    tid = gid = 0
    for a, i in enumerate(pods):
        for j in pods[a + 1:]:
            tid += 1
            v = float(volumes[(i * P + j) % len(volumes)])
            tasks.append(CommTask(tid, i, j, 2, v, (gid, gid + 1),
                                  (gid + 500, gid + 501), kind="wide"))
            gid += 2
            deps.append(Dep(0, tid, 0.0))
    return CommDAG(tasks=tasks, deps=deps, cluster=cluster)


def _wide_pair(seed: int, n_vol: int, pods=None):
    """The same two-member wide ensemble in both packages (the reference
    tests' `wide_ensemble` fixtures, P = 7)."""
    P = 7
    rng = np.random.default_rng(seed)
    vols = [rng.uniform(0.5, 2.0, n_vol) * 1e9 for _ in range(2)]
    port_cl = ClusterSpec(num_pods=P, port_limits=(40,) * P,
                          nic_bandwidth=50e9)
    ref_cl = JaxClusterSpec(num_pods=P, port_limits=(40,) * P,
                            nic_bandwidth=50e9)
    port = DagEnsemble([_wide(make_virtual, CommTask, Dep, CommDAG,
                              port_cl, v, pods) for v in vols])
    ref = JaxDagEnsemble([_wide(jax_make_virtual, JaxCommTask, JaxDep,
                                JaxCommDAG, ref_cl, v, pods) for v in vols])
    return port, ref


def test_trim_ports_ensemble_batched_matches_serial():
    """Mirror of tests/test_des_fused.py:249: the batched candidates x
    members sweep reproduces the serial member-by-member sweep on a wide
    fabric, and the reference's."""
    ens, ref = _wide_pair(7, 21)
    P = ens.cluster.num_pods
    x = np.zeros((P, P), dtype=np.int64)
    for i, j in ens.undirected_pairs():
        x[i, j] = x[j, i] = 3
    got = trim_ports_ensemble(ens, x, backend="torch", options=CPU)
    want = trim_ports_ensemble(ens, x, backend="numpy")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jax_ga.trim_ports_ensemble(ref, x, backend="jax"))
    assert got.sum() < x.sum()
    base = [simulate(DESProblem(m), x).makespan for m in ens.members]
    for m, b in zip(ens.members, base):
        assert simulate(DESProblem(m), got).makespan <= b * (1 + 1e-6)


def test_trim_ports_ensemble_off_pair_circuits_stay_serial(monkeypatch):
    """Mirror of tests/test_des_fused.py:268: circuits outside the union
    pairs keep the sweep serial (no engine is built) and are preserved."""
    ens, ref = _wide_pair(3, 15, pods=list(range(1, 7)))
    P = ens.cluster.num_pods
    x = np.zeros((P, P), dtype=np.int64)
    for i, j in ens.undirected_pairs():
        x[i, j] = x[j, i] = 3
    x[0, 1] = x[1, 0] = 2
    monkeypatch.setattr(port_ga, "EnsembleTorchDES", None)
    got = trim_ports_ensemble(ens, x, backend="torch", options=CPU)
    want = trim_ports_ensemble(ens, x, backend="numpy")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jax_ga.trim_ports_ensemble(ref, x, backend="jax"))
    assert got[0, 1] == 2 and got[1, 0] == 2


# ------------------------------------------------------------ engine cache
def _constructions(dag2, dag3, cache_size, monkeypatch):
    """One sequence of simulator constructions in each package (the
    reference tests' of tests/test_des_fused.py:150-207, then a fourth
    bucket past a small LRU): the two packages' stats after each."""
    monkeypatch.setenv("REPRO_DES_CACHE_SIZE", str(cache_size))
    monkeypatch.setattr(des_torch, "CACHE_SIZE", cache_size)
    p2, p3 = DESProblem(dag2[0]), DESProblem(dag3[0])
    r2, r3 = JaxDESProblem(dag2[1]), JaxDESProblem(dag3[1])
    port_opts = DESOptions(device="cpu", backend="ref", bucket=True)
    ref_opts = des_jax.DESOptions(backend="ref", bucket=True)
    steps = [
        (lambda: TorchDES(p2, options=port_opts),
         lambda: des_jax.JaxDES(r2, options=ref_opts)),
        (lambda: TorchDES(p2, options=port_opts),
         lambda: des_jax.JaxDES(r2, options=ref_opts)),
        (lambda: TorchDES(DESProblem(dag2[0]), options=port_opts),
         lambda: des_jax.JaxDES(JaxDESProblem(dag2[1]), options=ref_opts)),
        (lambda: EnsembleTorchDES([p2, p3], options=port_opts),
         lambda: des_jax.EnsembleJaxDES([r2, r3], options=ref_opts)),
        (lambda: EnsembleTorchDES([p3, p2], options=port_opts),
         lambda: des_jax.EnsembleJaxDES([r3, r2], options=ref_opts)),
        (lambda: TorchDES(p2, options=dataclasses.replace(
            port_opts, bucket=False)),
         lambda: des_jax.JaxDES(r2, options=dataclasses.replace(
             ref_opts, bucket=False))),
        (lambda: TorchDES(p3, options=port_opts),
         lambda: des_jax.JaxDES(r3, options=ref_opts)),
        (lambda: TorchDES(p2, options=port_opts),
         lambda: des_jax.JaxDES(r2, options=ref_opts)),
    ]
    des_cache_clear()
    des_jax.des_cache_clear()
    out = []
    for port_step, ref_step in steps:
        port_step()
        ref_step()
        out.append((des_cache_stats(), des_jax.des_cache_stats()))
    return out


@pytest.mark.parametrize("cache_size", [64, 2])
def test_engine_cache_counts_like_the_reference(cache_size, monkeypatch):
    """Mirror of tests/test_des_fused.py:150-207 (shared across instances,
    ensembles of one bucket share an entry) plus LRU evictions: after
    every construction the port's hits, misses, evictions and entries
    equal the reference's."""
    dag2 = build_comm_dag(port_job(2)), jax_build_comm_dag(gpt7b_job(2))
    dag3 = build_comm_dag(port_job(3)), jax_build_comm_dag(gpt7b_job(3))
    steps = _constructions(dag2, dag3, cache_size, monkeypatch)
    for got, want in steps:
        assert got == want
    last = steps[-1][0]
    if cache_size == 64:
        assert steps[2][0] == {"hits": 2, "misses": 1, "evictions": 0,
                               "entries": 1}
        assert last["evictions"] == 0 and last["hits"] >= 4
    else:
        assert last["evictions"] > 0 and last["entries"] == 2
    des_cache_clear()
    assert des_cache_stats() == {"hits": 0, "misses": 0, "evictions": 0,
                                 "entries": 0}


def test_engine_cache_keys_the_bucket():
    """A bucket is keyed by its shapes, backend and device: the same
    problem twice is one entry, another backend or exact shapes another."""
    des_cache_clear()
    prob = DESProblem(build_comm_dag(port_job(2)))
    TorchDES(prob, options=CPU)
    TorchDES(prob, options=CPU)
    assert des_cache_stats() == {"hits": 1, "misses": 1, "evictions": 0,
                                 "entries": 1}
    TorchDES(prob, options=DESOptions(device="cpu", backend="segment"))
    TorchDES(prob, options=DESOptions(device="cpu", bucket=False))
    assert des_cache_stats() == {"hits": 1, "misses": 3, "evictions": 0,
                                 "entries": 3}


def test_engine_cache_miss_warns(caplog):
    """`warn_on_miss` logs a new bucket and stays silent on a hit; the
    counter counts the miss either way."""
    des_cache_clear()
    prob = DESProblem(build_comm_dag(port_job(2)))
    opts = DESOptions(device="cpu", warn_on_miss=True)
    with caplog.at_level(logging.WARNING, logger="repro_torch.des_torch"):
        TorchDES(prob, options=opts)
    assert any("engine-cache miss" in r.message for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="repro_torch.des_torch"):
        TorchDES(prob, options=opts)
    assert not caplog.records
    assert des_cache_stats()["misses"] == 1
    assert des_cache_stats()["hits"] == 1


def test_des_options_ignore_the_environment(monkeypatch):
    """The reference's `REPRO_DES_*` variables move nothing in the port:
    the backend stays the options' (so no variable can move a card engine
    to a plain version), the buckets stay the 64 / 8 quanta, and an unset
    device is still the CUDA device."""
    prob = DESProblem(build_comm_dag(port_job(2)))
    want = TorchDES(prob, options=CPU)
    monkeypatch.setenv("REPRO_DES_BACKEND", "segment")
    monkeypatch.setenv("REPRO_DES_BUCKET", "0")
    monkeypatch.setenv("REPRO_DES_BUCKET_QUANTUM", "32")
    monkeypatch.setenv("REPRO_DES_BUCKET_QUANTUM_CONS", "4")
    monkeypatch.setenv("REPRO_DES_CACHE_SIZE", "1")
    td = TorchDES(prob, options=CPU)
    assert td.backend == want.backend == "ref"
    assert tuple(td.pad) == tuple(want.pad) and td.pad.n % 64 == 0
    assert des_torch.CACHE_SIZE == 64
    with pytest.raises(ValueError, match="unknown DES backend"):
        TorchDES(prob, options=DESOptions(device="cpu", backend="pallas"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        TorchDES(prob)
