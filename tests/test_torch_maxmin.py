"""The port's fused max-min rate step (`repro_torch.kernels.ops.fill_maxmin`,
its plain version `kernels.ref.fill_maxmin_ref`, and the CSR incidence the
torch DES builds for it) against the JAX reference's
`repro.core.des_jax._maxmin`, on the CPU.

The reference runs on its own padded arrays (`des_jax._problem_fields`),
carried across to the port by `repro_torch.convert`, for batches of active
sets drawn with numpy from a seed: lane s of the port's batch against the
reference's rates for lane s, under backends 'ref' (the dense jnp round)
and 'segment'.  The Hopper kernel itself is held against
`fill_maxmin_ref` in tests/test_torch_cuda.py, on a CUDA device.

Tolerance: rel 1e-5 against the reference (both float32 on the same
arrays, the per-constraint sums taken in another order); the port's own
'ref' and 'segment' paths agree on every lane's round count exactly, and
`fill_maxmin_ref` sums each row in the fused kernel's order to the
bit."""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
from conftest import gpt7b_job
from repro.core import des as jax_des_np
from repro.core import des_jax
from repro.core.cluster import ClusterSpec
from repro.core.dag import CommDAG, CommTask, Dep, make_virtual
from repro.core.schedule import build_comm_dag as jax_build_comm_dag
from repro_torch import obs
from repro_torch.convert import des_arrays_from_numpy
from repro_torch.core.des import DESProblem
from repro_torch.core.des_torch import (DESArrays, DESOptions, TorchDES,
                                        _dense_incidence, _incidence_csr,
                                        _maxmin, _segment_sums)
from repro_torch.core.schedule import build_comm_dag
from repro_torch.core.traffic import JobSpec
from repro_torch.kernels import ops, waterfill
from repro_torch.kernels.ref import (csr_con_id, csr_warp_sums,
                                     fill_maxmin_ref, progressive_filling)
from repro_torch.obs import REGISTRY

RTOL = 1e-5
LANES = 6


# ------------------------------------------------------------- the DAGs
def port_job(mb: int) -> JobSpec:
    """`conftest.gpt7b_job` built from the port's own JobSpec."""
    ref = gpt7b_job(mb)
    return JobSpec(**{f.name: getattr(ref, f.name)
                      for f in dataclasses.fields(ref) if f.init})


def _two_pods():
    return ClusterSpec(num_pods=2, port_limits=(8, 8), nic_bandwidth=1.0)


def _hand_dag(tasks, deps, cluster=None):
    return CommDAG([make_virtual()] + tasks, deps, cluster or _two_pods())


def _dag_of(name: str) -> CommDAG:
    """The reference's gpt-7b DAGs and the hand-checkable DAGs of
    tests/test_des.py."""
    if name.startswith("gpt7b-"):
        return jax_build_comm_dag(gpt7b_job(int(name[-1])))
    if name == "share":
        return _hand_dag([CommTask(1, 0, 1, 1, 1.0, (0,), (10,)),
                          CommTask(2, 0, 1, 1, 1.0, (1,), (11,))],
                         [Dep(0, 1, 0.0), Dep(0, 2, 0.0)])
    if name == "staggered":
        return _hand_dag([CommTask(1, 0, 1, 1, 1.0, (0,), (10,)),
                          CommTask(2, 0, 1, 1, 1.0, (1,), (11,)),
                          CommTask(3, 0, 1, 1, 1.0, (2,), (12,))],
                         [Dep(0, 1, 0.0), Dep(0, 2, 0.0), Dep(0, 3, 0.5)])
    if name == "nic":
        return _hand_dag([CommTask(1, 0, 1, 1, 1.0, (0,), (10,)),
                          CommTask(2, 0, 2, 1, 1.0, (0,), (20,))],
                         [Dep(0, 1, 0.0), Dep(0, 2, 0.0)],
                         ClusterSpec(num_pods=3, port_limits=(4, 4, 4),
                                     nic_bandwidth=1.0))
    if name == "weighted":
        return _hand_dag([CommTask(1, 0, 1, 3, 3.0, (0, 1, 2),
                                   (10, 11, 12)),
                          CommTask(2, 0, 1, 1, 1.0, (3,), (13,))],
                         [Dep(0, 1, 0.0), Dep(0, 2, 0.0)])
    raise KeyError(name)


DAGS = ["gpt7b-2", "gpt7b-3", "share", "staggered", "nic", "weighted"]


class Case:
    """One reference problem on both sides: the reference's JAX arrays,
    the same arrays as the port's tensors, its CSR, and a batch of
    (active, caps) lanes drawn from a seed.  Lane 0's active set is
    empty."""

    def __init__(self, name: str, ideal: bool = False, seed: int = 0):
        dag = _dag_of(name)
        prob = jax_des_np.DESProblem(dag)
        pad = des_jax.PadSpec.exact(prob).bucketed(
            des_jax.DESOptions().resolve())
        fields = des_jax._problem_fields(prob, pad)
        self.pad, self.fields, self.real_e = pad, fields, len(prob.con_task)
        self.jarr = des_jax.DESArrays.from_problem(prob, pad)
        self.arrays = des_arrays_from_numpy(
            {k: v[None] for k, v in fields.items()}, pad, "cpu")
        self.csr = _incidence_csr(self.arrays)
        rng = np.random.default_rng(seed)
        real = np.zeros(pad.n, dtype=bool)
        real[1:prob.n] = True                  # no virtual task, no ghosts
        dens = rng.uniform(0.1, 0.9, size=(LANES, 1))
        self.active = (rng.random((LANES, pad.n)) < dens) & real
        self.active[np.arange(LANES), rng.integers(1, prob.n, LANES)] = True
        self.active[0] = False
        P = dag.cluster.num_pods
        xs = np.zeros((LANES, P, P))
        for i, j in dag.undirected_pairs():
            xs[:, i, j] = xs[:, j, i] = rng.integers(1, 4, size=LANES)
        link = xs[:, fields["link_pair_a"], fields["link_pair_b"]]
        if ideal:
            link = np.full_like(link, np.inf)
        self.caps = np.concatenate(
            [link, np.ones((LANES, pad.cons - pad.links))], 1
        ).astype(np.float32)

    def tensors(self):
        return torch.from_numpy(self.active), torch.from_numpy(self.caps)

    def reference(self, backend: str) -> np.ndarray:
        fn = jax.vmap(lambda act, cap: des_jax._maxmin(
            self.jarr, act, cap, backend=backend))
        return np.asarray(fn(jnp.asarray(self.active),
                             jnp.asarray(self.caps)))


@pytest.fixture(scope="module")
def cases():
    return {}


def _case(cases, name, ideal=False) -> Case:
    if (name, ideal) not in cases:
        cases[name, ideal] = Case(name, ideal)
    return cases[name, ideal]


# ----------------------------------------------- against the reference
@pytest.mark.parametrize("name", DAGS)
@pytest.mark.parametrize("backend", ["ref", "segment"])
@pytest.mark.parametrize("ideal", [False, True])
def test_fill_maxmin_ref_matches_reference(cases, name, backend, ideal):
    case = _case(cases, name, ideal)
    active, caps = case.tensors()
    rates, rounds = fill_maxmin_ref(*case.csr, active, caps,
                                    case.arrays.flows)
    want = case.reference(backend)
    assert rates.shape == want.shape == case.active.shape
    for s in range(LANES):
        np.testing.assert_allclose(rates[s].numpy(), want[s], rtol=RTOL,
                                   atol=0, err_msg=f"lane {s}")
    assert int(rounds[0]) == 0 and (rates[0] == 0).all()  # the empty lane
    assert (rounds[1:] > 0).all() and (rounds <= caps.shape[1] + 1).all()


@pytest.mark.parametrize("backend", ["ref", "segment"])
def test_maxmin_backends_match_reference(cases, backend):
    """The DES rate step `_maxmin` on each backend, on gpt-7b's arrays."""
    case = _case(cases, "gpt7b-2")
    active, caps = case.tensors()
    got = _maxmin(case.arrays, active, caps, backend=backend)
    np.testing.assert_allclose(got.numpy(), case.reference("ref"),
                               rtol=RTOL, atol=0)


# ------------------------------------------------------- the CSR builder
@pytest.mark.parametrize("name", ["gpt7b-2", "gpt7b-3", "nic"])
def test_csr_matches_dense_incidence(cases, name):
    """The CSR holds every incidence entry, ghosts included, sorted stably
    by constraint, and gives the same dense matrix as `_dense_incidence`."""
    case = _case(cases, name)
    a = case.arrays
    E, C = a.con_task.shape[1], a.num_cons
    assert case.csr[0].shape == (1, C + 1)
    assert case.csr[1].shape == case.csr[2].shape == (1, E)
    con_ptr, ent_task, ent_w = (t[0] for t in case.csr)
    assert con_ptr.dtype == ent_task.dtype == torch.int32
    assert ent_w.dtype == torch.float32
    assert int(con_ptr[0]) == 0 and int(con_ptr[-1]) == E
    assert (con_ptr[1:] >= con_ptr[:-1]).all()
    cid = csr_con_id(case.csr[0])[0]
    dense = torch.zeros((C, a.n)).index_put_(
        (cid, ent_task.long()), ent_w, accumulate=True)
    torch.testing.assert_close(dense, _dense_incidence(a), rtol=0, atol=0)
    # each constraint keeps its entries in their order
    for c in range(C):
        keep = a.con_id[0] == c
        assert torch.equal(ent_task[cid == c].long(), a.con_task[0][keep])
        assert torch.equal(ent_w[cid == c], a.con_w[0][keep])
    # the ghosts (task 0, constraint 0, weight 0) close constraint 0's row
    n_ghost = case.pad.e - case.real_e
    assert n_ghost > 0
    tail = slice(int(con_ptr[1]) - n_ghost, int(con_ptr[1]))
    assert (ent_task[tail] == 0).all() and (ent_w[tail] == 0).all()


def test_csr_rejects_entries_outside_the_problem(cases):
    a = _case(cases, "share").arrays
    bad = a._replace(con_task=a.con_task.clone().fill_(a.n))
    with pytest.raises(ValueError, match="outside"):
        _incidence_csr(bad)
    with pytest.raises(ValueError, match="outside"):
        _incidence_csr(a._replace(num_cons=0))


def test_csr_warp_sums_follow_the_kernel_order():
    """Each row's sum in the fused kernel's order, written out per lane in
    float32: lane l adds entries l, l + 32, ... of the row, each product
    and sum rounded once, then the shuffle-down tree gathers lane 0."""
    rng = np.random.default_rng(11)
    counts = np.array([0, 1, 5, 32, 33, 100, 64])
    con_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    n, E = 40, int(counts.sum())
    ent_task = rng.integers(0, n, E).astype(np.int32)
    ent_w = rng.uniform(0.1, 3.0, E).astype(np.float32)
    x = rng.uniform(0.0, 2.0, (3, n)).astype(np.float32)
    used, denom = csr_warp_sums(torch.from_numpy(con_ptr)[None],
                                torch.from_numpy(ent_task)[None],
                                torch.from_numpy(ent_w)[None])(
        torch.from_numpy(x), torch.from_numpy(x[::-1].copy()))
    f32 = np.float32
    for s in range(3):
        for c in range(len(counts)):
            for got, xs in ((used, x[s]), (denom, x[2 - s])):
                lane = np.zeros(32, f32)
                for k, e in enumerate(range(con_ptr[c], con_ptr[c + 1])):
                    lane[k % 32] = f32(lane[k % 32]
                                       + f32(ent_w[e] * xs[ent_task[e]]))
                for off in (16, 8, 4, 2, 1):
                    lane[:off] = lane[:off] + lane[off:2 * off]
                assert got[s, c].item() == lane[0], (s, c)


# ------------------------------------------------------------ round counts
def _segment_rounds(a: DESArrays, active, caps):
    return progressive_filling(_segment_sums(a), a.con_id, a.con_task,
                               active, caps, a.flows)


@pytest.mark.parametrize("name", DAGS)
def test_ref_and_segment_round_counts_equal(cases, name):
    case = _case(cases, name)
    active, caps = case.tensors()
    r_rates, r_rounds = fill_maxmin_ref(*case.csr, active, caps,
                                        case.arrays.flows)
    s_rates, s_rounds = _segment_rounds(case.arrays, active, caps)
    assert torch.equal(r_rounds, s_rounds)
    torch.testing.assert_close(r_rates, s_rates, rtol=RTOL, atol=0)
    # the DES rate step adds the batch's rounds (the most any lane ran)
    for backend in ("ref", "segment"):
        total = torch.zeros((), dtype=torch.int64)
        _maxmin(case.arrays, active, caps, backend=backend, rounds=total)
        assert int(total) == int(r_rounds.max())


def test_des_round_counter_equal_on_ref_and_segment():
    """`des_fill_rounds_total` counts the same rounds on the fused path's
    plain version and on the segment path, over whole simulations (it
    counts while tracing is on)."""
    dag = build_comm_dag(port_job(3))
    prob = DESProblem(dag)
    x = np.zeros((dag.cluster.num_pods,) * 2, dtype=np.int64)
    for i, j in dag.undirected_pairs():
        x[i, j] = x[j, i] = 2
    counter = REGISTRY.counter("des_fill_rounds_total")
    got = {}
    for backend in ("ref", "segment"):
        td = TorchDES(prob, options=DESOptions(device="cpu",
                                               backend=backend))
        before = counter.value()
        with obs.enabled():
            ms = td.makespan(x)
        obs.TRACER.clear()
        got[backend] = (counter.value() - before, ms)
    assert got["ref"][0] == got["segment"][0] > 0
    assert got["ref"][1] == pytest.approx(got["segment"][1], rel=RTOL)


# ----------------------------------------------------------- edge cases
def test_edge_cases_empty_stopped_and_unconstrained_lanes():
    """An empty active set runs 0 rounds; a lane masked out (not running)
    likewise; a lane whose unfrozen task touches no constraint runs to
    the cap of C + 1 rounds with an infinite rate, on both paths."""
    con_ptr = torch.tensor([[0, 2, 3]], dtype=torch.int32)
    ent_task = torch.tensor([[0, 1, 1]], dtype=torch.int32)
    ent_w = torch.tensor([[1.0, 2.0, 1.0]])
    flows = torch.tensor([[1.0, 2.0, 3.0]])
    active = torch.tensor([[False, False, False],
                           [True, True, False],
                           [True, False, True]])
    run = torch.tensor([True, False, True])
    caps = torch.tensor([[1.0, 1.0]] * 3)
    rates, rounds = ops.fill_maxmin(con_ptr, ent_task, ent_w,
                                    active & run[:, None], caps, flows)
    assert rounds.tolist() == [0, 0, 3]
    assert rates[:2].eq(0).all()
    assert rates[2, 0] == pytest.approx(1.0) and rates[2, 1] == 0
    assert rates[2, 2] == np.inf
    a = DESArrays(volume=torch.ones((1, 3)), flows=flows,
                  dep_pre=torch.zeros((1, 1), dtype=torch.int64),
                  dep_succ=torch.zeros((1, 1), dtype=torch.int64),
                  dep_delta=torch.zeros((1, 1)), indegree=torch.zeros(
                      (1, 3), dtype=torch.int32),
                  con_task=ent_task.long(), con_id=csr_con_id(con_ptr),
                  con_w=ent_w,
                  link_pair_a=torch.zeros((1, 1), dtype=torch.int64),
                  link_pair_b=torch.zeros((1, 1), dtype=torch.int64),
                  task_valid=torch.ones((1, 3), dtype=torch.bool),
                  num_cons=2, num_link_cons=0, n=3)
    s_rates, s_rounds = _segment_rounds(a, active & run[:, None], caps)
    assert torch.equal(s_rounds, rounds)
    assert torch.equal(s_rates, rates)


# ---------------------------------------------------------- device rules
def test_card_backends_raise_on_a_cpu_device(cases):
    case = _case(cases, "share")
    prob = DESProblem(build_comm_dag(port_job(2)))
    for backend in ("cuda", "cuda-round"):
        with pytest.raises(ValueError, match="needs a CUDA device"):
            TorchDES(prob, options=DESOptions(device="cpu", backend=backend))
    active, caps = case.tensors()
    before = (waterfill.launches, waterfill.maxmin_launches)
    for backend in ("cuda", "cuda-round"):
        with pytest.raises(ValueError, match="not a CUDA device"):
            _maxmin(case.arrays, active, caps, backend=backend)
    with pytest.raises(ValueError, match="not a CUDA device"):
        ops.fill_maxmin(*case.csr, active, caps, case.arrays.flows,
                        backend="cuda")
    assert (waterfill.launches, waterfill.maxmin_launches) == before


def test_smem_size_and_refusal_are_computed_on_the_host():
    # the main path's shape fits with room to spare; a large E does not
    assert waterfill.maxmin_smem_bytes(832, 80, 2432) < 48 * 1024
    assert waterfill.maxmin_smem_bytes(832, 80, 30000) \
        > waterfill.MAX_SMEM_BYTES


# ------------------------------------------------------------- properties
@st.composite
def csr_instances(draw):
    """Random CSR incidences in which every task sits in at least one
    constraint, with a batch of active sets and capacities."""
    n = draw(st.integers(1, 12))
    C = draw(st.integers(1, 6))
    S = draw(st.integers(1, 4))
    rng = np.random.default_rng(draw(st.integers(0, 2**31 - 1)))
    pairs = [(m % C, m) for m in range(n)]
    pairs += [(int(rng.integers(0, C)), int(rng.integers(0, n)))
              for _ in range(int(rng.integers(0, 2 * n + 1)))]
    rng.shuffle(pairs)
    con_id, con_task = (np.asarray(v) for v in zip(*pairs))
    con_w = rng.uniform(0.1, 3.0, size=len(pairs)).astype(np.float32)
    flows = rng.uniform(1.0, 4.0, size=n).astype(np.float32)
    caps = rng.uniform(0.1, 5.0, size=(S, C)).astype(np.float32)
    active = rng.random((S, n)) < 0.8
    return n, C, con_task, con_id, con_w, flows, active, caps


@settings(max_examples=12, deadline=None)
@given(csr_instances())
def test_property_fill_maxmin_ref_matches_reference(instance):
    n, C, con_task, con_id, con_w, flows, active, caps = instance
    E = len(con_id)
    z = torch.zeros((1, 1), dtype=torch.int64)
    a = DESArrays(volume=torch.ones((1, n)),
                  flows=torch.from_numpy(flows)[None], dep_pre=z,
                  dep_succ=z, dep_delta=torch.zeros((1, 1)),
                  indegree=torch.zeros((1, n), dtype=torch.int32),
                  con_task=torch.from_numpy(con_task).long()[None],
                  con_id=torch.from_numpy(con_id).long()[None],
                  con_w=torch.from_numpy(con_w)[None], link_pair_a=z,
                  link_pair_b=z, task_valid=torch.ones((1, n), dtype=bool),
                  num_cons=C, num_link_cons=0, n=n)
    csr = _incidence_csr(a)
    assert int(csr[0][0, -1]) == E
    rates, rounds = fill_maxmin_ref(*csr, torch.from_numpy(active),
                                    torch.from_numpy(caps), a.flows)
    z = jnp.zeros(1, dtype=jnp.int32)
    jarr = des_jax.DESArrays(
        volume=jnp.ones(n), flows=jnp.asarray(flows), dep_pre=z,
        dep_succ=z, dep_delta=jnp.zeros(1),
        indegree=jnp.zeros(n, dtype=jnp.int32),
        con_task=jnp.asarray(con_task, dtype=jnp.int32),
        con_id=jnp.asarray(con_id, dtype=jnp.int32),
        con_w=jnp.asarray(con_w), link_pair_a=z, link_pair_b=z,
        task_valid=jnp.ones(n, dtype=bool), num_cons=C, num_link_cons=0,
        nic_bandwidth=1.0, n=n)
    for s in range(active.shape[0]):
        want = np.asarray(des_jax._maxmin(jarr, jnp.asarray(active[s]),
                                          jnp.asarray(caps[s]),
                                          backend="segment"))
        np.testing.assert_allclose(rates[s].numpy(), want, rtol=RTOL,
                                   atol=1e-6)
        # a lane alone runs as it does in the batch
        one, r1 = fill_maxmin_ref(*csr, torch.from_numpy(active[s:s + 1]),
                                  torch.from_numpy(caps[s:s + 1]), a.flows)
        assert torch.equal(one[0], rates[s]) and int(r1[0]) == int(
            rounds[s])
    assert (rounds <= C + 1).all()
    assert (rates.numpy()[~active] == 0).all()
