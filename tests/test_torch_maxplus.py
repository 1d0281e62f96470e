"""The port's max-plus product and longest paths (`repro_torch.kernels`)
against the JAX reference: the plain-torch path on the CPU against
`repro.kernels.ref` and the Pallas kernel in interpret mode, on the shape
sweep of tests/test_kernels.py, the Bellman loop, and Alg. 4's EST.  The
Hopper kernel itself is held against the plain path in
tests/test_torch_cuda.py, on a CUDA device.

Tolerances: the product is a max of float32 sums, each rounded once, and a
max does not depend on order, so the port equals both references bit for
bit; rtol 1e-6 / atol 1e-4 (tests/test_kernels.py) is the stated ceiling.
Longest paths against the float64 Bellman loop and Alg. 4: rtol 1e-5, as
in tests/test_kernels.py.  The kernel's stream-K schedule (`maxplus.plan`)
is held here too, through its plain replay `maxplus_split_ref`: bit equal
to both references (a max does not depend on how k is split)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
from repro.kernels import ops as jax_ops
from repro.kernels.ref import maxplus_ref as jax_maxplus_ref
from repro_torch.core.dag import VIRTUAL
from repro_torch.core.des import DESProblem
from repro_torch.core.pruning import (cal_task_time_windows, dep_weights,
                                      estimate_t_up)
from repro_torch.core.schedule import build_comm_dag
from repro_torch.kernels import maxplus, ops
from repro_torch.kernels.ref import NEG_INF, maxplus_ref, maxplus_split_ref
from test_torch_des import port_job

RTOL, ATOL = 1e-6, 1e-4
SHAPES = [(3, 4, 5), (64, 64, 64), (130, 17, 70), (1, 1, 1), (128, 128, 128)]


def _sparse(rng, m, k):
    return np.where(rng.random((m, k)) < 0.4, rng.random((m, k)) * 10,
                    NEG_INF).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_maxplus_matches_jax(shape):
    m, k, n = shape
    rng = np.random.default_rng(m * 10000 + k * 100 + n)
    a, b = _sparse(rng, m, k), _sparse(rng, k, n)
    got = ops.maxplus(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want_ref = np.asarray(jax_maxplus_ref(jnp.asarray(a), jnp.asarray(b)))
    want_pallas = np.asarray(jax_ops.maxplus(a, b, backend="pallas",
                                             interpret=True))
    assert got.dtype == np.float32 and got.shape == (m, n)
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(got, want)


def _bellman(adj_mask, adj):
    n = len(adj)
    dist = np.where(np.eye(n, dtype=bool), 0.0, NEG_INF)
    for _ in range(n):
        nd = dist.copy()
        for i in range(n):
            for j in range(n):
                if adj_mask[i, j]:
                    nd[:, j] = np.maximum(nd[:, j], dist[:, i] + adj[i, j])
        dist = nd
    return dist


def test_longest_paths_vs_bellman():
    n = 24
    rng = np.random.default_rng(24)
    adj_mask = np.triu(rng.random((n, n)) < 0.2, k=1)
    adj = np.where(adj_mask, rng.random((n, n)) * 5, NEG_INF) \
        .astype(np.float32)
    got = ops.longest_paths(torch.from_numpy(adj)).numpy()
    dist = _bellman(adj_mask, adj)
    mask = dist > NEG_INF / 2
    np.testing.assert_allclose(got[mask], dist[mask], rtol=1e-5)
    assert (got[~mask] <= NEG_INF / 2 + 1).all()
    np.testing.assert_array_equal(got, np.asarray(jax_ops.longest_paths(
        adj, backend="pallas", interpret=True)))


@pytest.mark.parametrize("mb", [2, 4])
def test_longest_paths_row_virtual_is_alg4_est(mb):
    """Row VIRTUAL of the longest paths over W[pre, succ] = tau[pre] + delta
    is the EST of Alg. 4's forward pass (float32 against float64)."""
    dag = build_comm_dag(port_job(mb))
    est, _ = cal_task_time_windows(dag, estimate_t_up(DESProblem(dag)))
    got = ops.longest_paths(torch.from_numpy(dep_weights(dag))).numpy()
    assert (got[VIRTUAL] > NEG_INF / 2).all()      # all reachable
    np.testing.assert_allclose(got[VIRTUAL], est, rtol=1e-5,
                               atol=1e-5 * est.max())


def test_dep_weights_keeps_the_heaviest_dep():
    dag = build_comm_dag(port_job(2))
    w = dep_weights(dag)
    assert w.shape == (dag.num_tasks,) * 2
    tau = np.array([t.volume / (t.flows * dag.cluster.nic_bandwidth)
                    if t.tid != VIRTUAL else 0.0 for t in dag.tasks])
    for d in dag.deps:
        assert w[d.pre, d.succ] >= tau[d.pre] + d.delta
    linked = {(d.pre, d.succ) for d in dag.deps}
    assert (w > NEG_INF / 2).sum() == len(linked)


def test_ref_clamps_at_neg_inf():
    a = torch.full((3, 2), NEG_INF)
    b = torch.full((2, 4), NEG_INF)
    out = maxplus_ref(a, b)
    assert torch.equal(out, torch.full((3, 4), NEG_INF))


def test_cuda_backend_on_cpu_tensor_raises():
    a = torch.zeros((4, 4))
    before = maxplus.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        ops.maxplus(a, a, backend="cuda")
    with pytest.raises(ValueError, match="not a CUDA device"):
        ops.longest_paths(a, backend="cuda")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ops.maxplus(a, a, backend="pallas")
    assert maxplus.launches == before


# The kernel's schedule (`maxplus.plan`) and its plain replay
# (`ref.maxplus_split_ref`): every (tile, k-chunk) unit once, NEG_INF in
# the padding, the partials combined by a max.  Bit equality throughout.
SPLIT_SHAPES = SHAPES + [(1, 801, 1), (33, 1000, 65), (200, 1, 150),
                         (200, 3, 150), (257, 17, 129), (130, 0, 7)]


def _split_case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return _sparse(rng, m, k), _sparse(rng, k, n)


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
@pytest.mark.parametrize("sms", [1, 3, 132])
def test_split_replay_matches_plain_and_jax(shape, sms):
    m, k, n = shape
    a, b = _split_case(m, k, n, m * 7 + k * 3 + n + sms)
    p = maxplus.plan(m, k, n, sms)
    got = maxplus_split_ref(torch.from_numpy(a), torch.from_numpy(b), p)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    if k == 0:      # no candidate: every entry is "no path"
        assert torch.equal(got, torch.full((m, n), NEG_INF))
        return
    np.testing.assert_array_equal(
        got.numpy(), maxplus_ref(torch.from_numpy(a),
                                 torch.from_numpy(b)).numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_maxplus_ref(jnp.asarray(a), jnp.asarray(b))))


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 150), st.integers(1, 90), st.integers(1, 150),
       st.integers(1, 300), st.integers(0, 2**31 - 1))
def test_property_split_replay_is_plain(m, k, n, sms, seed):
    a, b = _split_case(m, k, n, seed)
    got = maxplus_split_ref(torch.from_numpy(a), torch.from_numpy(b),
                            maxplus.plan(m, k, n, sms))
    assert torch.equal(got, maxplus_ref(torch.from_numpy(a),
                                        torch.from_numpy(b)))


def _owners(p, t):
    """The blocks whose range holds a unit of tile t, by the combine
    kernel's formula (block g owns unit u when g = ((u+1) G - 1) // U)."""
    first = t * p.kc
    g0 = ((first + 1) * p.blocks - 1) // p.units
    g1 = ((first + p.kc) * p.blocks - 1) // p.units
    return set(range(g0, g1 + 1))


@pytest.mark.parametrize("shape", [(801, 801, 801), (1, 1, 1), (3, 4, 5),
                                   (1, 801, 1), (33, 1000, 65),
                                   (801, 17, 801), (5000, 64, 300)])
@pytest.mark.parametrize("sms", [1, 7, 132, 1000])
def test_plan_covers_every_unit_once(shape, sms):
    m, k, n = shape
    p = maxplus.plan(m, k, n, sms)
    assert p.units == p.tiles_m * p.tiles_n * p.kc
    assert 1 <= p.blocks <= min(p.units, sms)
    starts = [maxplus.unit_start(g, p.units, p.blocks)
              for g in range(p.blocks + 1)]
    assert starts[0] == 0 and starts[-1] == p.units
    assert all(s1 > s0 for s0, s1 in zip(starts, starts[1:]))  # none empty
    owners = {t: set() for t in range(p.tiles_m * p.tiles_n)}
    for g in range(p.blocks):
        tiles = range(starts[g] // p.kc, (starts[g + 1] - 1) // p.kc + 1)
        assert len(tiles) <= p.max_seg          # its partials fit `ws`
        for t in tiles:
            owners[t].add(g)
    for t, gs in owners.items():
        assert gs == _owners(p, t)


def test_plan_at_full_width():
    p = maxplus.plan(801, 801, 801, 132)
    assert p == maxplus.Plan(tiles_m=7, tiles_n=7, kc=51, units=2499,
                             blocks=132, max_seg=2)
    with pytest.raises(ValueError, match="work units"):
        maxplus.plan(2 ** 20, 2 ** 20, 2 ** 20, 132)


def test_tiling_matches_the_source():
    src = (Path(maxplus.__file__).parent / "csrc" / "maxplus.cu").read_text()
    const = {name: int(v) for name, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (maxplus.BM, maxplus.BN, maxplus.BK) == (
        const["kBM"], 16 * const["kTN"], const["kBK"])
    assert "__launch_bounds__(kThreads, 1)" in src   # one block per SM
