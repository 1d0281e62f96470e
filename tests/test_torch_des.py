"""The port's torch DES (`repro_torch.core.des_torch.TorchDES`) against the
numpy oracle and the JAX reference engine, on the CPU.

Mirrors tests/test_des_jax.py (property vs numpy, the gpt7b grid, batched
== single, ideal mode) and the engine cases of tests/test_des_fused.py
(max-min and end-to-end backend parity, bucket padding, PadSpec quanta),
and holds TorchDES against `repro.core.des_jax.JaxDES` on identical arrays
carried across by `repro_torch.convert`.

Tolerances: rel 5e-5 against numpy (float32 engine against a float64
oracle, as in test_des_jax.py); rel 1e-5 against JaxDES (both float32 on
the same arrays, sums in another order); rel 1e-6 batched against single
(one engine, one order)."""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
from conftest import gpt7b_job, one_circuit_topology, random_comm_dags
from repro.core import des as jax_des_np
from repro.core import des_jax
from repro.core.schedule import build_comm_dag as jax_build_comm_dag
from repro_torch.convert import des_arrays_from_numpy, topology_from_numpy
from repro_torch.core import cluster as tcluster
from repro_torch.core import dag as tdag
from repro_torch.core.des import DESProblem, simulate
from repro_torch.core.des_torch import (DESArrays, DESOptions, PadSpec,
                                        TorchDES, _maxmin, _problem_fields)
from repro_torch.core.schedule import build_comm_dag
from repro_torch.core.traffic import JobSpec

RTOL = 5e-5
RTOL_JAX = 1e-5
CPU = DESOptions(device="cpu")


# ------------------------------------------------------------- helpers
def port_job(mb: int = 4, **kw) -> JobSpec:
    """`conftest.gpt7b_job` built from the port's own JobSpec."""
    ref = gpt7b_job(mb, **kw)
    return JobSpec(**{f.name: getattr(ref, f.name)
                      for f in dataclasses.fields(ref) if f.init})


def port_dag(dag) -> tdag.CommDAG:
    """A reference CommDAG rebuilt from the port's own data model."""
    def copy(obj, cls):
        return cls(**{f.name: getattr(obj, f.name)
                      for f in dataclasses.fields(obj) if f.init})
    return tdag.CommDAG(tasks=[copy(t, tdag.CommTask) for t in dag.tasks],
                        deps=[copy(d, tdag.Dep) for d in dag.deps],
                        cluster=copy(dag.cluster, tcluster.ClusterSpec),
                        meta=dict(dag.meta))


def random_topologies(dag, rng, k: int, hi: int = 3) -> np.ndarray:
    P = dag.cluster.num_pods
    xs = np.zeros((k, P, P), dtype=np.int64)
    for s in range(k):
        for i, j in dag.undirected_pairs():
            xs[s, i, j] = xs[s, j, i] = rng.integers(1, hi)
    return xs


@pytest.fixture(scope="module")
def dag2():
    return build_comm_dag(port_job(2))


@pytest.fixture(scope="module")
def dag3():
    return build_comm_dag(port_job(3))


# ------------------------------------------------- mirrors test_des_jax.py
@settings(max_examples=15, deadline=None)
@given(random_comm_dags(max_pods=3, max_tasks=8))
def test_property_matches_numpy(dag):
    prob = DESProblem(port_dag(dag))
    td = TorchDES(prob, options=CPU)
    x = one_circuit_topology(dag)
    r = simulate(prob, x)
    ms, feas, start, finish = td.simulate(x)
    assert feas == r.feasible
    if r.feasible:
        assert ms == pytest.approx(r.makespan, rel=RTOL)


def test_gpt7b_grid_matches_numpy():
    dag = build_comm_dag(port_job(4))
    prob = DESProblem(dag)
    td = TorchDES(prob, options=CPU)
    for x in random_topologies(dag, np.random.default_rng(0), 6):
        r = simulate(prob, x)
        ms, feas, *_ = td.simulate(x)
        assert feas == r.feasible
        assert ms == pytest.approx(r.makespan, rel=RTOL)


def test_batched_equals_single(dag3):
    prob = DESProblem(dag3)
    td = TorchDES(prob, options=CPU)
    xs = random_topologies(dag3, np.random.default_rng(1), 8, hi=4)
    ms_b, feas_b = td.batch_makespan(xs)
    eu = np.array([i for i, _ in dag3.undirected_pairs()])
    ev = np.array([j for _, j in dag3.undirected_pairs()])
    ms_g, feas_g = td.batch_genome_makespan(xs[:, eu, ev], eu, ev)
    for i in range(len(xs)):
        ms, feas, *_ = td.simulate(xs[i])
        assert feas == bool(feas_b[i]) == bool(feas_g[i])
        assert ms == pytest.approx(float(ms_b[i]), rel=1e-6)
        assert ms == pytest.approx(float(ms_g[i]), rel=1e-6)


def test_ideal_mode(dag3):
    prob = DESProblem(dag3)
    td = TorchDES(prob, options=CPU)
    x = one_circuit_topology(dag3)
    ideal_np = simulate(prob, x, ideal=True).makespan
    assert td.makespan(x, ideal=True) == pytest.approx(ideal_np, rel=RTOL)


def test_link_mask_scales_capacity(dag3):
    """A (P, P) availability mask multiplies the link capacities only: a
    mask of 1/2 prices like half the circuits."""
    prob = DESProblem(dag3)
    td = TorchDES(prob, options=CPU)
    x = one_circuit_topology(dag3) * 2
    P = dag3.cluster.num_pods
    half = td.makespan(x, mask=np.full((P, P), 0.5))
    assert half == pytest.approx(td.makespan(x // 2), rel=1e-6)


# ------------------------------------------- mirrors test_des_fused.py
def maxmin_numpy_ref(n, C, con_task, con_id, con_w, flows, active, caps):
    """Pure-numpy weighted max-min fair-share oracle (progressive filling,
    float64), as in tests/test_des_fused.py."""
    phi = np.zeros(n)
    unfrozen = active.copy()
    for _ in range(C + 1):
        if not unfrozen.any():
            break
        used = np.zeros(C)
        denom = np.zeros(C)
        np.add.at(used, con_id,
                  np.where(active[con_task], con_w, 0.0) * phi[con_task])
        np.add.at(denom, con_id, np.where(unfrozen[con_task], con_w, 0.0))
        with np.errstate(divide="ignore", invalid="ignore"):
            alpha_c = np.where(denom > 0, (caps - used)
                               / np.maximum(denom, 1e-300), np.inf)
        alpha = max(float(alpha_c.min()), 0.0)
        if not np.isfinite(alpha):
            break
        phi[unfrozen] += alpha
        sat = np.isfinite(alpha_c) & (alpha_c <= alpha * (1 + 1e-9) + 1e-18)
        task_sat = np.zeros(n, dtype=bool)
        task_sat[con_task[sat[con_id]]] = True
        unfrozen = unfrozen & ~task_sat
    return flows * phi * active


def _synthetic_arrays(n, C, con_task, con_id, con_w, flows) -> DESArrays:
    """DESArrays carrying only the fields `_maxmin` consumes."""
    z = torch.zeros(1, dtype=torch.int64)
    return DESArrays(
        volume=torch.ones(n), flows=torch.tensor(flows, dtype=torch.float32),
        dep_pre=z, dep_succ=z, dep_delta=torch.zeros(1),
        indegree=torch.zeros(n, dtype=torch.int32),
        con_task=torch.as_tensor(con_task, dtype=torch.int64),
        con_id=torch.as_tensor(con_id, dtype=torch.int64),
        con_w=torch.tensor(con_w, dtype=torch.float32), link_pair_a=z,
        link_pair_b=z, task_valid=torch.ones(n, dtype=torch.bool),
        num_cons=C, num_link_cons=0, n=n)


@st.composite
def maxmin_instances(draw):
    """Random active-flow / capacity instances where every task belongs to
    at least one finite-capacity constraint (so filling always saturates)."""
    n = draw(st.integers(1, 12))
    C = draw(st.integers(1, 6))
    rng = np.random.default_rng(draw(st.integers(0, 2**31 - 1)))
    pairs = {(m % C, m) for m in range(n)}
    for _ in range(int(rng.integers(0, 2 * n + 1))):
        pairs.add((int(rng.integers(0, C)), int(rng.integers(0, n))))
    con_id, con_task = map(np.asarray, zip(*sorted(pairs)))
    con_w = rng.uniform(0.1, 3.0, size=len(con_id))
    flows = rng.uniform(1.0, 4.0, size=n)
    caps = rng.uniform(0.1, 5.0, size=C)
    active = rng.random(n) < 0.8
    return n, C, con_task, con_id, con_w, flows, active, caps


@pytest.mark.parametrize("backend", ["segment", "ref"])
@settings(max_examples=25, deadline=None)
@given(maxmin_instances())
def test_property_maxmin_matches_numpy(backend, instance):
    n, C, con_task, con_id, con_w, flows, active, caps = instance
    arr = _synthetic_arrays(n, C, con_task, con_id, con_w, flows)
    got = _maxmin(arr, torch.as_tensor(active)[None],
                  torch.tensor(caps, dtype=torch.float32)[None],
                  backend=backend)[0].numpy()
    want = maxmin_numpy_ref(n, C, con_task, con_id, con_w, flows, active,
                            caps)
    # f32 vs f64 can flip a freeze decision on a near-tie (the tolerance of
    # tests/test_des_fused.py), then the invariants exactly
    assert np.allclose(got, want, rtol=5e-3, atol=1e-4)
    assert (got[~active] == 0).all()
    assert (got >= 0).all()
    used = np.zeros(C)
    np.add.at(used, con_id, con_w * (got / flows)[con_task])
    assert (used <= caps * (1 + 1e-3) + 1e-4).all()


def test_maxmin_single_link_fair_share():
    """Three 1-flow tasks on one cap-2 link: each gets 2/3."""
    arr = _synthetic_arrays(3, 1, np.arange(3), np.zeros(3, dtype=int),
                            np.ones(3), np.ones(3))
    for backend in ("segment", "ref"):
        got = _maxmin(arr, torch.ones((1, 3), dtype=torch.bool),
                      torch.tensor([[2.0]]), backend=backend)
        assert np.allclose(got.numpy(), 2.0 / 3.0, rtol=1e-6)


def test_backends_match_numpy_end_to_end(dag2):
    prob = DESProblem(dag2)
    x = one_circuit_topology(dag2)
    want = simulate(prob, x)
    want2 = simulate(prob, x * 2)
    for backend in ("segment", "ref"):
        td = TorchDES(prob, options=DESOptions(backend=backend,
                                               device="cpu"))
        ms, feas, *_ = td.simulate(x)
        assert feas == want.feasible
        assert ms == pytest.approx(want.makespan, rel=RTOL), backend
        ms_b, feas_b = td.batch_makespan(np.stack([x, x * 2]))
        assert feas_b.all() == (want.feasible and want2.feasible)
        assert ms_b[0] == pytest.approx(want.makespan, rel=RTOL), backend
        assert ms_b[1] == pytest.approx(want2.makespan, rel=RTOL), backend


def test_bucket_padding_is_exact(dag2):
    """Bucket-padded simulation equals the exact-shape one bit-for-bit
    (ghost tasks contribute zero to every reduction) and strips the ghost
    tasks from start/finish."""
    prob = DESProblem(dag2)
    x = one_circuit_topology(dag2)
    td_b = TorchDES(prob, options=DESOptions(device="cpu", backend="segment"))
    td_e = TorchDES(prob, options=DESOptions(device="cpu", backend="segment",
                                             bucket=False))
    assert td_b.pad.n > prob.n >= td_e.pad.n
    ms_b, feas_b, start_b, finish_b = td_b.simulate(x)
    ms_e, feas_e, start_e, finish_e = td_e.simulate(x)
    assert ms_b == ms_e and feas_b == feas_e
    assert start_b.shape == (prob.n,) and finish_b.shape == (prob.n,)
    np.testing.assert_array_equal(start_b, start_e)
    np.testing.assert_array_equal(finish_b, finish_e)


def test_pad_spec_quantization():
    spec = PadSpec(n=17, d=40, e=48, links=6, cons=22)
    b = spec.bucketed(64, 8)
    assert b == PadSpec(n=64, d=64, e=64, links=8, cons=24)
    assert b.bucketed(64, 8) == b          # aligned sizes stay put
    assert spec.bucketed() == b            # the defaults are 64 / 8
    ref = des_jax.PadSpec(*spec).bucketed(des_jax.DESOptions(
        bucket_quantum=64, bucket_quantum_cons=8).resolve())
    assert tuple(ref) == tuple(b)


# --------------------------------------------- against the JAX reference
@pytest.mark.parametrize("mb", [2, 4])
def test_problem_fields_equal_reference(mb):
    """The port's data model builds the reference's DES arrays, array for
    array, from the same job (its own JobSpec, schedule and DESProblem)."""
    ref_prob = jax_des_np.DESProblem(jax_build_comm_dag(gpt7b_job(mb)))
    prob = DESProblem(build_comm_dag(port_job(mb)))
    pad = PadSpec.exact(prob).bucketed()
    ref_pad = des_jax.PadSpec.exact(ref_prob).bucketed(
        des_jax.DESOptions().resolve())
    assert tuple(pad) == tuple(ref_pad)
    got = _problem_fields(prob, pad)
    want = des_jax._problem_fields(ref_prob, ref_pad)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


def test_matches_jax_des_on_reference_arrays(dag3):
    """TorchDES on the JAX reference's own padded arrays, carried across by
    `convert`, against JaxDES (backend ref) on the same problem."""
    ref_prob = jax_des_np.DESProblem(jax_build_comm_dag(gpt7b_job(3)))
    jd = des_jax.JaxDES(ref_prob, options=des_jax.DESOptions(backend="ref"))
    arrays = des_arrays_from_numpy(
        des_jax._problem_fields(ref_prob, jd.pad), jd.pad, "cpu")
    prob = DESProblem(dag3)
    td = TorchDES(prob, options=CPU, arrays=arrays)
    assert td.pad == PadSpec(*jd.pad)
    xs = random_topologies(dag3, np.random.default_rng(3), 4)
    for x in xs:
        ms_j, feas_j, start_j, finish_j = jd.simulate(x)
        ms_t, feas_t, start_t, finish_t = td.simulate(x)
        assert feas_t == feas_j
        assert ms_t == pytest.approx(ms_j, rel=RTOL_JAX)
        np.testing.assert_allclose(finish_t, finish_j, rtol=RTOL_JAX)
        np.testing.assert_allclose(start_t, start_j, rtol=RTOL_JAX)
    ms_j, feas_j = jd.batch_makespan(xs)
    ms_t, feas_t = td.batch_makespan(xs)
    np.testing.assert_array_equal(feas_t, feas_j)
    np.testing.assert_allclose(ms_t, ms_j, rtol=RTOL_JAX)


def test_convert_rejects_malformed_fields(dag2):
    prob = DESProblem(dag2)
    pad = PadSpec.exact(prob)
    fields = _problem_fields(prob, pad)
    with pytest.raises(ValueError, match="differ"):
        des_arrays_from_numpy({k: v for k, v in fields.items()
                               if k != "volume"}, pad, "cpu")
    with pytest.raises(ValueError, match="shape"):
        des_arrays_from_numpy(fields, pad._replace(n=pad.n + 1), "cpu")
    a = des_arrays_from_numpy(fields, pad, "cpu")
    assert a.volume.dtype == torch.float32 and a.con_id.dtype == torch.int64
    assert topology_from_numpy(np.eye(2, dtype=np.int32), "cpu").dtype \
        == torch.int64
    assert jnp.asarray(fields["volume"]).dtype == jnp.float32
    np.testing.assert_array_equal(
        a.volume.numpy(), np.asarray(jnp.asarray(fields["volume"])))


# ----------------------------------------------------------- device rules
def test_device_and_backend_resolution(dag2):
    prob = DESProblem(dag2)
    assert TorchDES(prob, options=CPU).backend == "ref"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        TorchDES(prob, options=DESOptions(device="cpu", backend="cuda"))
    with pytest.raises(ValueError, match="unknown DES backend"):
        TorchDES(prob, options=DESOptions(device="cpu", backend="pallas"))


def test_no_device_given_raises_without_cuda(dag2, monkeypatch):
    """Without a CUDA device the engine refuses to run unless the caller
    asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        TorchDES(DESProblem(dag2))
