"""The port's Hopper kernels, the torch DES, Alg. 2's kernel closure and
the longest-path layer on a CUDA device.

Skipped without one (the kernels have no CPU mode).  This file imports no
JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: rtol/atol 1e-5 waterfill kernels against their plain
versions (float32 sums in another order, as in tests/test_kernels.py);
the fused kernel is bit-equal to its plain version as well, with the same
round counts (one summation order, every operation rounded once); none for
tclosure and maxplus, which are bit-equal to their plain versions (a
boolean product; a max of float32 sums, each rounded once); rel 5e-5 DES
against the numpy oracle (as in tests/test_des_jax.py); atol 1e-5 x max
EST for longest paths (float32) against Alg. 4 (float64); rel 1e-5
between the fused and the per-round DES paths (both float32).  The
member-axis filling launch is bit-equal to its plain version and, member
by member, to single-problem launches (each block reads its lane's
member, nothing else changes); the ensemble engine on the card is
bit-equal to its plain path and within rel 5e-5 of the numpy DES.  The
fleet's seams on the card: the plane-state lanes of the spare-plane
fitness within rel 5e-5 of the numpy DES and bit-equal to the plain path;
`waterfill_grants` (one `fill_matvec` launch per round) equal to its CPU
run; `Tenant.des()` a cache miss, then a hit; a gpt-7b fleet the same
topologies on the card as on the CPU.  The control-plane CLI on the card
(its baselines equal to a CPU run's, its GA one `fill_maxmin` launch per
trip), a batch of the widest registry DAG (jamba-1.5-large-398b) within
rel 5e-5 of the numpy DES, and two examples returning 0 on the card.
The LM serving path on the card (one architecture of each family at its
reduced size): prefill and 4 decode steps within rel 1e-4 of max |logit|
of the same weights on the CPU (float32, TF32 off; cuBLAS sums in
another order), decode within rel 2e-2 of the full forward (as
tests/test_models.py), and `serve.main` on the card."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import gpt7b_job
from repro_torch import obs
from repro_torch.configs import PAPER_WORKLOADS, make_job
from repro_torch.configs import REGISTRY as ARCHS
from repro_torch.core.dag import VIRTUAL
from repro_torch.core.des import DESProblem, simulate
from repro_torch.core.des_torch import (GRAPH_TRIPS, DESOptions,
                                        EnsembleTorchDES, TorchDES)
from repro_torch.core.ga import (GAOptions, PlanesFitness, TopologySpace,
                                 delta_fast)
from repro_torch.core.pruning import (cal_task_time_windows, dep_weights,
                                      estimate_t_up)
from repro_torch.core.schedule import build_comm_dag
from repro_torch.core.traffic import JobSpec
from repro_torch.core.xbound import (dep_adjacency, reachability_bitset,
                                     reachability_kernel, x_upper_bound)
from repro_torch.kernels import _build, maxplus, ops, tclosure, waterfill
from repro_torch.kernels.ref import (NEG_INF, fill_matvec_ref,
                                     fill_maxmin_ref, maxplus_ref,
                                     tclosure_step_ref)
from repro_torch.obs import REGISTRY

pytestmark = pytest.mark.cuda

RTOL = ATOL = 1e-5
DES_RTOL = 5e-5
# the sweep of tests/test_kernels.py, plus the main path's (C, N)
SHAPES = [(3, 5), (100, 257), (130, 64), (1, 1), (128, 128), (80, 832)]
# tests/test_kernels.py's closure and max-plus sweeps, plus megatron-462b's n
TC_SIZES = [1, 5, 64, 127, 128, 130, 257, 801]
TC_DTYPES = [torch.bool, torch.int8, torch.int32, torch.float32]
MP_SHAPES = [(3, 4, 5), (64, 64, 64), (130, 17, 70), (1, 1, 1),
             (128, 128, 128), (801, 801, 801)]
# the edges of the max-plus kernel's stream-K schedule: one entry with a
# long k, ragged tiles, and a k shorter than one block's range of units
MP_EDGES = [(1, 801, 1), (33, 1000, 65), (801, 1, 801), (801, 3, 801),
            (801, 17, 801)]
# fill_maxmin sweep: (lanes S, tasks N, constraints C, entries E, density of
# the active sets); the next to last needs 93 KB of shared memory (above
# the 48 KB default), the last is the main path's (megatron-462b bucketed)
MAXMIN_SHAPES = [(1, 1, 1, 1, 1.0), (3, 5, 3, 7, 0.5), (8, 64, 8, 100, 0.3),
                 (5, 257, 40, 600, 0.8), (2, 1000, 200, 3000, 0.05),
                 (4, 4000, 100, 8000, 0.1), (48, 832, 80, 2432, 0.2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def dag3():
    ref = gpt7b_job(3)
    job = JobSpec(**{f.name: getattr(ref, f.name)
                     for f in dataclasses.fields(ref) if f.init})
    return build_comm_dag(job)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("batch", [None, 48])
@pytest.mark.parametrize("rhs_cols", [1, 2, 3, 5])
def test_kernel_matches_plain(cuda, shape, batch, rhs_cols):
    c, n = shape
    rng = np.random.default_rng(c + n + rhs_cols)
    w = torch.from_numpy((rng.random((c, n)) * (rng.random((c, n)) < 0.3))
                         .astype(np.float32)).to(cuda)
    rshape = (n, rhs_cols) if batch is None else (batch, n, rhs_cols)
    rhs = torch.from_numpy(rng.random(rshape).astype(np.float32)).to(cuda)
    before = waterfill.launches
    got = ops.fill_matvec(w, rhs)
    torch.cuda.synchronize()
    assert waterfill.launches == before + 1
    torch.testing.assert_close(got, fill_matvec_ref(w, rhs), rtol=RTOL,
                               atol=ATOL)
    # fixed summation order: bit-identical run to run
    assert torch.equal(got, ops.fill_matvec(w, rhs))


def test_kernel_rejects_what_it_does_not_take(cuda):
    w = torch.ones((4, 3), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        waterfill.fill_matvec(w, torch.ones((3, 2), device=cuda,
                                            dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        waterfill.fill_matvec(w, torch.ones((2, 3), device=cuda).t())
    with pytest.raises(ValueError, match="N=3"):
        waterfill.fill_matvec(w, torch.ones((4, 2), device=cuda))


def test_cuda_engine_matches_numpy(cuda, dag3):
    prob = DESProblem(dag3)
    td = TorchDES(prob)
    assert td.backend == "cuda" and td.device.type == "cuda"
    rng = np.random.default_rng(4)
    P = dag3.cluster.num_pods
    xs = np.zeros((4, P, P), dtype=np.int64)
    for s in range(4):
        for i, j in dag3.undirected_pairs():
            xs[s, i, j] = xs[s, j, i] = rng.integers(1, 4)
    before = _maxmin_launches()
    ms_b, feas_b = td.batch_makespan(xs)
    assert _maxmin_launches() > before
    for i, x in enumerate(xs):
        r = simulate(prob, x)
        ms, feas, *_ = td.simulate(x)
        assert feas == bool(feas_b[i]) == r.feasible
        assert ms_b[i] == pytest.approx(r.makespan, rel=RTOL)
        assert ms == pytest.approx(float(ms_b[i]), rel=1e-6)


def test_delta_fast_same_on_card_and_cpu(cuda, dag3):
    """The GA on the card's kernel and on the CPU's plain path: same seed,
    same topology (the scores differ only in float32 summation order)."""
    kw = dict(seed=0, pop_size=12, max_generations=4, patience=10**9,
              time_limit=1e9)
    on_card = delta_fast(dag3, GAOptions(**kw))
    on_cpu = delta_fast(dag3, GAOptions(**kw, des_options=DESOptions(
        device="cpu")))
    np.testing.assert_array_equal(on_card.x, on_cpu.x)
    assert on_card.makespan == on_cpu.makespan


@pytest.mark.parametrize("n", TC_SIZES)
@pytest.mark.parametrize("density", [0.02, 0.2])
@pytest.mark.parametrize("dtype", TC_DTYPES)
def test_tclosure_matches_plain(cuda, n, density, dtype):
    rng = np.random.default_rng(n + int(density * 100))
    a = torch.from_numpy(rng.random((n, n)) < density).to(cuda, dtype)
    before = tclosure.launches
    got = ops.tclosure_step(a)
    torch.cuda.synchronize()
    assert tclosure.launches == before + 1
    assert got.dtype == torch.bool and got.shape == (n, n)
    assert torch.equal(got, tclosure_step_ref(a))
    assert torch.equal(got, ops.tclosure_step(a))     # bit-identical rerun


def test_tclosure_reads_any_nonzero_as_set(cuda):
    rng = np.random.default_rng(7)
    v = rng.choice(np.array([0.0, -0.0, 0.5, -3.0, 1e-30], np.float32),
                   size=(70, 70), p=[0.6, 0.1, 0.1, 0.1, 0.1])
    a = torch.from_numpy(v).to(cuda)
    assert torch.equal(ops.tclosure_step(a), tclosure_step_ref(a))
    assert torch.equal(ops.tclosure_step(a), ops.tclosure_step(a != 0))


@pytest.mark.parametrize("shape", MP_SHAPES)
def test_maxplus_matches_plain(cuda, shape):
    m, k, n = shape
    rng = np.random.default_rng(m + k + n)

    def sparse(r, c):
        return torch.from_numpy(np.where(
            rng.random((r, c)) < 0.4, rng.random((r, c)) * 10, NEG_INF)
            .astype(np.float32)).to(cuda)
    a, b = sparse(m, k), sparse(k, n)
    before = maxplus.launches
    got = ops.maxplus(a, b)
    torch.cuda.synchronize()
    assert maxplus.launches == before + 1
    assert torch.equal(got, maxplus_ref(a, b))
    assert torch.equal(got, ops.maxplus(a, b))        # bit-identical rerun


@pytest.mark.parametrize("shape", MP_EDGES)
def test_maxplus_schedule_edges_match_plain(cuda, shape):
    m, k, n = shape
    rng = np.random.default_rng(m * 3 + k + n)

    def sparse(r, c):
        return torch.from_numpy(np.where(
            rng.random((r, c)) < 0.4, rng.random((r, c)) * 10, NEG_INF)
            .astype(np.float32)).to(cuda)
    a, b = sparse(m, k), sparse(k, n)
    p = maxplus.plan(m, k, n, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert p.blocks <= p.units
    before = maxplus.launches
    got = ops.maxplus(a, b)
    torch.cuda.synchronize()
    assert maxplus.launches == before + 1       # the product and its combine
    assert torch.equal(got, maxplus_ref(a, b))
    assert torch.equal(got, ops.maxplus(a, b))        # bit-identical rerun


def _resident_limit(device) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(n for n in range(1, 4096) if tclosure.plan(n, sms).resident)


@pytest.mark.parametrize("side", ["resident", "streamed"])
@pytest.mark.parametrize("density", [0.002, 0.05])
def test_tclosure_both_paths_match_plain(cuda, side, density):
    """n just below and just above the resident limit: each takes its path
    (the plan says which) and is bit-equal to the plain version."""
    n = _resident_limit(cuda) + (side == "streamed")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert tclosure.plan(n, sms).resident == (side == "resident")
    rng = np.random.default_rng(n + int(density * 1000))
    a = torch.from_numpy(rng.random((n, n)) < density).to(cuda)
    got = ops.tclosure_step(a)
    torch.cuda.synchronize()
    assert torch.equal(got, tclosure_step_ref(a))
    assert torch.equal(got, ops.tclosure_step(a))     # bit-identical rerun


def test_tclosure_every_step_at_full_width(cuda):
    """megatron-462b's closure (n = 801): all 3 squaring steps, each
    bit-equal to the plain version, one launch each."""
    job = make_job(PAPER_WORKLOADS["megatron-462b"], seq_len=4096)
    a = dep_adjacency(build_comm_dag(job, 400.0), cuda)
    assert a.shape == (801, 801)
    steps = 0
    while True:
        before = tclosure.launches
        got = ops.tclosure_step(a)
        assert tclosure.launches == before + 1
        assert torch.equal(got, tclosure_step_ref(a))
        steps += 1
        if torch.equal(got, a):
            break
        a = got
    assert steps == 3


def test_new_kernels_reject_what_they_do_not_take(cuda):
    with pytest.raises(ValueError, match="needs one of"):
        tclosure.tclosure_step(torch.ones((3, 3), device=cuda,
                                          dtype=torch.float64))
    with pytest.raises(ValueError, match="square"):
        tclosure.tclosure_step(torch.ones((3, 4), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        tclosure.tclosure_step(torch.ones((4, 8), device=cuda)[:, :4])
    a = torch.ones((4, 3), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        maxplus.maxplus(a, torch.ones((3, 2), device=cuda,
                                      dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        maxplus.maxplus(a, torch.ones((2, 3), device=cuda).t())
    with pytest.raises(ValueError, match="K=3"):
        maxplus.maxplus(a, torch.ones((4, 2), device=cuda))


def test_failed_build_raises(cuda, tmp_path, monkeypatch):
    (tmp_path / "broken.cu").write_text("this is not CUDA C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build("broken")


def test_reachability_kernel_on_card(cuda, dag3):
    before = tclosure.launches
    got = reachability_kernel(dag3)
    assert tclosure.launches > before
    np.testing.assert_array_equal(got, reachability_bitset(dag3))
    t_up = estimate_t_up(DESProblem(dag3))
    np.testing.assert_array_equal(
        x_upper_bound(dag3, t_up, closure_backend="kernel"),
        x_upper_bound(dag3, t_up, closure_backend="bitset"))


def test_longest_paths_row_virtual_is_est_on_card(cuda, dag3):
    est, _ = cal_task_time_windows(dag3, estimate_t_up(DESProblem(dag3)))
    before = maxplus.launches
    lp = ops.longest_paths(torch.from_numpy(dep_weights(dag3)).to(cuda))
    assert maxplus.launches > before
    row = lp[VIRTUAL].double().cpu().numpy()
    assert (row > NEG_INF / 2).all()
    np.testing.assert_allclose(row, est, rtol=0, atol=1e-5 * est.max())


def maxmin_instance(rng, s, n, c, e, density, dev):
    """A random CSR incidence in which every task sits in a constraint
    (when E >= N), with a member axis of 1, and S lanes of active sets
    and capacities."""
    con = np.concatenate([np.arange(min(n, e)) % c,
                          rng.integers(0, c, max(e - n, 0))])
    task = np.concatenate([np.arange(min(n, e)),
                           rng.integers(0, n, max(e - n, 0))])
    order = np.argsort(con, kind="stable")
    con_ptr = np.zeros(c + 1, dtype=np.int32)
    con_ptr[1:] = np.cumsum(np.bincount(con, minlength=c))
    tensors = (con_ptr[None], task[order].astype(np.int32)[None],
               rng.uniform(0.1, 3.0, (1, e)).astype(np.float32),
               rng.random((s, n)) < density,
               rng.uniform(0.1, 5.0, (s, c)).astype(np.float32),
               rng.uniform(1.0, 4.0, (1, n)).astype(np.float32))
    return [torch.from_numpy(np.ascontiguousarray(t)).to(dev)
            for t in tensors]


@pytest.mark.parametrize("shape", MAXMIN_SHAPES)
def test_fill_maxmin_matches_plain(cuda, shape):
    rng = np.random.default_rng(sum(int(v * 10) for v in shape))
    args = maxmin_instance(rng, *shape, cuda)
    before = waterfill.maxmin_launches
    rates, rounds = ops.fill_maxmin(*args)
    torch.cuda.synchronize()
    assert waterfill.maxmin_launches == before + 1
    want, want_rounds = fill_maxmin_ref(*args)
    torch.testing.assert_close(rates, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(rates, want)     # one summation order, no FMA
    assert torch.equal(rounds, want_rounds)
    again, again_rounds = ops.fill_maxmin(*args)   # bit-identical rerun
    assert torch.equal(again, rates) and torch.equal(again_rounds, rounds)


def test_fill_maxmin_edge_lanes(cuda):
    """Empty and stopped lanes run 0 rounds; a task in no constraint runs
    its lane to the cap of C + 1 rounds with an infinite rate; ideal
    (infinite) capacities never saturate."""
    con_ptr = torch.tensor([[0, 2, 3]], dtype=torch.int32, device=cuda)
    ent_task = torch.tensor([[0, 1, 1]], dtype=torch.int32, device=cuda)
    ent_w = torch.tensor([[1.0, 2.0, 1.0]], device=cuda)
    flows = torch.tensor([[1.0, 2.0, 3.0]], device=cuda)
    active = torch.tensor([[False, False, False], [True, True, False],
                           [True, False, True], [False, True, False]],
                          device=cuda)
    caps = torch.tensor([[1.0, 1.0]] * 3 + [[float("inf"), 1.0]],
                        device=cuda)
    active[1] = False                              # a lane not running
    args = (con_ptr, ent_task, ent_w, active, caps, flows)
    rates, rounds = ops.fill_maxmin(*args)
    want, want_rounds = fill_maxmin_ref(*args)
    assert rounds.tolist() == want_rounds.tolist() == [0, 0, 3, 1]
    torch.testing.assert_close(rates, want, rtol=RTOL, atol=ATOL)
    assert float(rates[2, 2]) == float("inf") and float(rates[3, 1]) == 2.0


def test_fill_maxmin_rejects_what_it_does_not_take(cuda):
    rng = np.random.default_rng(0)
    args = maxmin_instance(rng, 2, 16, 4, 20, 0.5, cuda)
    with pytest.raises(ValueError, match="float32"):
        ops.fill_maxmin(*args[:4], args[4].double(), args[5])
    with pytest.raises(ValueError, match="torch.bool"):
        ops.fill_maxmin(*args[:3], args[3].to(torch.uint8), *args[4:])
    with pytest.raises(ValueError, match="not a CUDA device"):
        waterfill.fill_maxmin(*args[:4], args[4].cpu(), args[5])
    with pytest.raises(ValueError, match="contiguous"):
        waterfill.fill_maxmin(*args[:4], args[4].t().contiguous().t(),
                              args[5])
    with pytest.raises(ValueError, match="shapes disagree"):
        waterfill.fill_maxmin(*args[:5], args[5][:, :-1].contiguous())
    big = maxmin_instance(rng, 1, 832, 80, 30000, 0.5, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        waterfill.fill_maxmin(*big)


def test_fill_maxmin_asserts_on_a_malformed_csr(cuda):
    """A task index outside [0, N) stops the launch with a device assert
    (in a child process: the assert leaves the CUDA context unusable)."""
    code = (
        "import torch\n"
        "from repro_torch.kernels import waterfill\n"
        "i32 = dict(dtype=torch.int32, device='cuda')\n"
        "rates, _ = waterfill.fill_maxmin(\n"
        "    torch.tensor([[0, 2]], **i32), torch.tensor([[0, 5]], **i32),\n"
        "    torch.ones((1, 2), device='cuda'),\n"
        "    torch.ones((1, 3), dtype=torch.bool, device='cuda'),\n"
        "    torch.ones((1, 1), device='cuda'),\n"
        "    torch.ones((1, 3), device='cuda'))\n"
        "torch.cuda.synchronize()\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(
                             Path(__file__).resolve().parents[1] / "src")})
    assert run.returncode != 0
    assert "assert" in (run.stdout + run.stderr).lower()


def test_fill_maxmin_launches_at_the_shared_memory_limit(cuda):
    """A problem that needs exactly the 227 KB a block may have launches
    (so the source sizes the block no larger than the wrapper's
    `maxmin_smem_bytes`) and agrees with the plain version; one more
    entry is refused before the launch."""
    s, n, c = 2, 16, 1
    e = (waterfill.MAX_SMEM_BYTES - waterfill.maxmin_smem_bytes(n, c, 0)) // 8
    assert waterfill.maxmin_smem_bytes(n, c, e) == waterfill.MAX_SMEM_BYTES
    rng = np.random.default_rng(227)
    args = maxmin_instance(rng, s, n, c, e, 0.5, cuda)
    rates, rounds = waterfill.fill_maxmin(*args)
    want, want_rounds = fill_maxmin_ref(*args)
    assert torch.equal(rates, want) and torch.equal(rounds, want_rounds)
    over = maxmin_instance(rng, s, n, c, e + 1, 0.5, cuda)
    before = waterfill.maxmin_launches
    with pytest.raises(ValueError, match="shared memory"):
        waterfill.fill_maxmin(*over)
    assert waterfill.maxmin_launches == before


def _maxmin_launches() -> float:
    """fill_maxmin's launches: those made from the host and GRAPH_TRIPS
    per replay of a trip graph."""
    return waterfill.maxmin_launches + GRAPH_TRIPS * REGISTRY.counter(
        "des_graph_replays_total").value()


def _counts():
    return (waterfill.launches, _maxmin_launches(),
            REGISTRY.counter("des_event_trips_total").value(),
            REGISTRY.counter("des_fill_rounds_total").value(),
            REGISTRY.counter("des_graph_idle_trips_total").value())


def test_fused_engine_matches_numpy_and_the_round_path(cuda, dag3):
    """The default engine (one fused launch per trip, no per-round
    launch) against the numpy DES, against its plain version on the card
    (the same bits and rounds) and against 'cuda-round' (one launch per
    round, sums in another order)."""
    prob = DESProblem(dag3)
    fused = TorchDES(prob)
    per_round = TorchDES(prob, options=DESOptions(backend="cuda-round"))
    plain = TorchDES(prob, options=DESOptions(backend="ref"))
    assert fused.backend == "cuda" and per_round.backend == "cuda-round"
    rng = np.random.default_rng(5)
    P = dag3.cluster.num_pods
    xs = np.zeros((4, P, P), dtype=np.int64)
    for s in range(4):
        for i, j in dag3.undirected_pairs():
            xs[s, i, j] = xs[s, j, i] = rng.integers(1, 4)
    # the rounds are counted while tracing is on
    with obs.enabled():
        c0 = _counts()
        ms_f, feas_f = fused.batch_makespan(xs)
        c1 = _counts()
        ms_r, feas_r = per_round.batch_makespan(xs)
        c2 = _counts()
        ms_p, feas_p = plain.batch_makespan(xs)
        c3 = _counts()
    obs.TRACER.clear()
    assert c1[0] == c0[0]                          # no fill_round launch
    # one launch per trip, idle graph trips included
    assert c1[1] - c0[1] == c1[2] - c0[2] + c1[4] - c0[4] > 0
    assert c2[0] - c1[0] == c2[3] - c1[3] > 0      # one launch per round
    assert c2[1] == c1[1]
    assert c3[:2] == c2[:2]                        # no launch at all
    assert c1[3] - c0[3] == c3[3] - c2[3]          # the same rounds
    np.testing.assert_array_equal(ms_f, ms_p)
    np.testing.assert_array_equal(feas_f, feas_p)
    np.testing.assert_array_equal(feas_f, feas_r)
    np.testing.assert_allclose(ms_f, ms_r, rtol=1e-5)
    for i, x in enumerate(xs):
        r = simulate(prob, x)
        assert bool(feas_f[i]) == r.feasible
        assert ms_f[i] == pytest.approx(r.makespan, rel=DES_RTOL)


def _member_instances(rng, members, lanes, n, c, e, density, dev):
    """M distinct random CSRs of one (N, C, E), stacked on a member axis,
    with S = members x lanes lanes of active sets and capacities."""
    parts = [maxmin_instance(rng, lanes * members, n, c, e, density, dev)
             for _ in range(members)]
    csr = [torch.cat([p[i] for p in parts]) for i in (0, 1, 2, 5)]
    return [*csr[:3], parts[0][3], parts[0][4], csr[3]]


@pytest.mark.parametrize("members", [1, 2, 3])
@pytest.mark.parametrize("lanes", [1, 5, 48])
def test_fill_maxmin_members_match_plain(cuda, members, lanes):
    """Lane s reads member s % M: the launch is bit-equal to its plain
    version with equal rounds, and each member's lanes to a launch of
    that member alone (the M = 1 call of one CSR)."""
    rng = np.random.default_rng(100 * members + lanes)
    con_ptr, ent_task, ent_w, active, caps, flows = _member_instances(
        rng, members, lanes, 257, 40, 600, 0.6, cuda)
    args = (con_ptr, ent_task, ent_w, active, caps, flows)
    before = waterfill.maxmin_launches
    rates, rounds = ops.fill_maxmin(*args)
    torch.cuda.synchronize()
    assert waterfill.maxmin_launches == before + 1
    want, want_rounds = fill_maxmin_ref(*args)
    assert torch.equal(rates, want) and torch.equal(rounds, want_rounds)
    for m in range(members):
        one, one_rounds = ops.fill_maxmin(
            con_ptr[m:m + 1], ent_task[m:m + 1], ent_w[m:m + 1],
            active[m::members].contiguous(), caps[m::members].contiguous(),
            flows[m:m + 1])
        assert torch.equal(one, rates[m::members])
        assert torch.equal(one_rounds, rounds[m::members])


def test_fill_maxmin_one_member_axis_is_the_single_call(cuda):
    """One problem is the M = 1 launch: bit-equal to its plain version and
    to the same problem read as both members of an M = 2 launch."""
    rng = np.random.default_rng(11)
    args = maxmin_instance(rng, 48, 832, 80, 2432, 0.2, cuda)
    rates, rounds = ops.fill_maxmin(*args)
    want, want_rounds = fill_maxmin_ref(*args)
    assert torch.equal(rates, want) and torch.equal(rounds, want_rounds)
    twice = [t.expand(2, -1).contiguous() for t in args[:3]] \
        + [args[3], args[4], args[5].expand(2, -1).contiguous()]
    again, again_rounds = ops.fill_maxmin(*twice)
    assert torch.equal(again, rates) and torch.equal(again_rounds, rounds)


def test_fill_maxmin_rejects_lanes_not_a_multiple_of_members(cuda):
    rng = np.random.default_rng(12)
    args = _member_instances(rng, 2, 3, 16, 4, 20, 0.5, cuda)
    odd = [*args[:3], args[3][:5].contiguous(), args[4][:5].contiguous(),
           args[5]]
    before = waterfill.maxmin_launches
    with pytest.raises(ValueError, match="multiple of the members"):
        waterfill.fill_maxmin(*odd)
    with pytest.raises(ValueError, match="shapes disagree"):
        waterfill.fill_maxmin(*args[:5], args[5][:1].contiguous())
    with pytest.raises(ValueError, match="con_ptr \\(M, C\\+1\\)"):
        waterfill.fill_maxmin(args[0][0], *args[1:])
    assert waterfill.maxmin_launches == before


def test_ensemble_engine_on_card(cuda, dag3):
    """EnsembleTorchDES on the card: one fill_maxmin launch per trip for
    all genomes x members lanes, bit-equal to its plain path, within rel
    5e-5 of the numpy DES under per-member masks, and its one-member case
    bit-equal to TorchDES."""
    job = gpt7b_job(2, micro_tokens=16384)
    dag_b = build_comm_dag(JobSpec(**{f.name: getattr(job, f.name)
                                      for f in dataclasses.fields(job)
                                      if f.init}))
    probs = [DESProblem(dag3), DESProblem(dag_b)]
    fused = EnsembleTorchDES(probs)
    plain = EnsembleTorchDES(probs, options=DESOptions(backend="ref"))
    assert fused.backend == "cuda" and fused.M == 2
    rng = np.random.default_rng(6)
    P = dag3.cluster.num_pods
    pairs = sorted(set(dag3.undirected_pairs()) | set(dag_b.undirected_pairs()))
    eu = np.array([i for i, _ in pairs])
    ev = np.array([j for _, j in pairs])
    genomes = rng.integers(1, 4, (5, len(pairs)))
    masks = np.stack([np.ones((P, P)), np.full((P, P), 0.75)])
    c0 = _counts()
    ms_f, feas_f = fused.ensemble_genome_makespan(genomes, eu, ev, masks)
    c1 = _counts()
    # one launch per trip, idle graph trips included
    assert c1[1] - c0[1] == c1[2] - c0[2] + c1[4] - c0[4] > 0
    ms_p, feas_p = plain.ensemble_genome_makespan(genomes, eu, ev, masks)
    np.testing.assert_array_equal(ms_f, ms_p)
    np.testing.assert_array_equal(feas_f, feas_p)
    for g in range(len(genomes)):
        x = np.zeros((P, P), dtype=np.int64)
        x[eu, ev] = x[ev, eu] = genomes[g]
        for m, prob in enumerate(probs):
            r = simulate(prob, x * masks[m])
            assert bool(feas_f[g, m]) == r.feasible
            assert ms_f[g, m] == pytest.approx(r.makespan, rel=DES_RTOL)
    single = EnsembleTorchDES(probs[:1]).ensemble_genome_makespan(
        genomes, eu, ev)
    ms_t, feas_t = TorchDES(probs[0]).batch_genome_makespan(genomes, eu, ev)
    np.testing.assert_array_equal(single[0][:, 0], ms_t)
    np.testing.assert_array_equal(single[1][:, 0], feas_t)



def test_plane_state_lanes_on_card(cuda, dag3):
    """The spare-plane fitness on the card: (S x (k+1)) plane-state lanes
    of `EnsembleTorchDES` in one batch, one fill_maxmin launch per trip,
    bit-equal to the plain path and within rel 5e-5 of the numpy DES on
    each state's float topology."""
    from repro_torch.core.dag import DagEnsemble
    ens = DagEnsemble.singleton(dag3)
    space = TopologySpace.for_ensemble(ens, port_limits=np.full(4, 8),
                                       min_circuits=0)
    x1 = np.zeros((4, 4), dtype=np.int64)
    for i, j in dag3.undirected_pairs():
        x1[i, j] = x1[j, i] = 1
    base = np.stack([space.genome_of(x1)] * 3)
    genomes = np.random.default_rng(8).integers(0, 3, size=(6, space.E))
    opts = dict(pop_size=6, seed=0)
    card = PlanesFitness(ens, base, space, GAOptions(**opts), np.ones(1))
    plain = PlanesFitness(ens, base, space, GAOptions(
        **opts, des_options=DESOptions(backend="ref")), np.ones(1))
    assert card._des.backend == "cuda"
    c0 = _counts()
    got = card.state_makespans(genomes)
    c1 = _counts()
    # one launch per trip, idle graph trips included
    assert c1[1] - c0[1] == c1[2] - c0[2] + c1[4] - c0[4] > 0
    assert got.shape == (6, 5, 1) and card.batch_calls == 1
    np.testing.assert_array_equal(got, plain.state_makespans(genomes))
    for g, row in zip(genomes, got):
        np.testing.assert_allclose(row, card.exact_state_makespans(g),
                                   rtol=DES_RTOL)


def test_waterfill_grants_on_card_match_cpu(cuda):
    """`waterfill_grants` on the card: one `fill_matvec` launch per round
    it runs, and the CPU run's grants."""
    from repro_torch.fleet import waterfill_grants
    rng = np.random.default_rng(3)
    rounds = REGISTRY.counter("fleet_waterfill_rounds_total")
    for t, p in ((2, 8), (3, 4), (4, 16)):
        demands = rng.integers(0, 12, size=(t, p))
        supply = rng.integers(1, 16, size=p)
        r0, l0 = rounds.value(), waterfill.launches
        got = waterfill_grants(demands, supply)
        torch.cuda.synchronize()
        ran = rounds.value() - r0
        assert ran > 0 and waterfill.launches - l0 == ran
        np.testing.assert_array_equal(
            got, waterfill_grants(demands, supply, device="cpu"))


def test_tenant_des_on_card_is_a_cache_miss_then_a_hit(cuda, dag3):
    """`Tenant.des()` builds its realloc engine on the card with
    `warn_on_miss`: the first tenant of a DAG shape opens a bucket, the
    next one of the same shape lands in it."""
    from repro_torch.core.des_torch import des_cache_clear, des_cache_stats
    from repro_torch.fleet import Tenant
    des_cache_clear()

    def tenant(name):
        return Tenant(name=name, job=None, pods=(0, 1, 2, 3),
                      reverse_stages=False, port_min=False, dag=dag3)
    first = tenant("a").des()
    assert first.backend == "cuda" and first.options.warn_on_miss
    assert des_cache_stats() == {"hits": 0, "misses": 1, "evictions": 0,
                                 "entries": 1}
    second = tenant("b").des()
    assert second.pad == first.pad and second.backend == "cuda"
    assert des_cache_stats() == {"hits": 1, "misses": 1, "evictions": 0,
                                 "entries": 1}


def test_fleet_planner_without_cuda_raises(cuda, monkeypatch):
    """A fleet planner with no device named refuses to plan where no CUDA
    device is available, and so does plan(kind="fleet")."""
    from repro_torch.core.api import PlanRequest, plan
    from repro_torch.fleet import FleetPlanner, FleetSpec
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        FleetPlanner(FleetSpec(num_pods=4, ports_per_pod=8))
    with pytest.raises(RuntimeError, match="CUDA device"):
        plan(PlanRequest(fleet_requests=[("a", dag3_job())]))


def dag3_job() -> JobSpec:
    ref = gpt7b_job(3)
    return JobSpec(**{f.name: getattr(ref, f.name)
                      for f in dataclasses.fields(ref) if f.init})


def test_fleet_same_on_card_and_cpu(cuda):
    """The Fig. 10 pair at gpt-7b (4 pods, 4 microbatches) through
    `fleet_optimize` on the card and on the CPU: the same topology for
    every tenant, `fill_matvec` launched once per waterfill round."""
    from repro_torch.core.api import fleet_optimize
    ref = gpt7b_job(4)
    job = JobSpec(**{f.name: getattr(ref, f.name)
                     for f in dataclasses.fields(ref) if f.init})
    reqs = [("model", job, {"port_min": True}),
            ("model_t", job, {"reverse_stages": True})]
    kw = dict(pop_size=12, max_generations=6, patience=10**9,
              time_limit=1e9, seed=0)
    rounds = REGISTRY.counter("fleet_waterfill_rounds_total")
    r0, l0 = rounds.value(), waterfill.launches
    card, rep = fleet_optimize(reqs, ports_per_pod=8, nic_gbps=100.0,
                               ga_options=GAOptions(**kw))
    torch.cuda.synchronize()
    assert waterfill.launches - l0 == rounds.value() - r0 > 0
    cpu, _ = fleet_optimize(reqs, ports_per_pod=8, nic_gbps=100.0,
                            ga_options=GAOptions(
                                **kw, des_options=DESOptions(device="cpu")))
    for name in ("model", "model_t"):
        np.testing.assert_array_equal(card.tenants[name].plan.x,
                                      cpu.tenants[name].plan.x)
    assert card.ledger.snapshot() == cpu.ledger.snapshot()
    assert rep["realloc"]["granted_ports"] > 0


def test_cli_on_card_launches_fill_maxmin_and_matches_cpu(cuda, tmp_path):
    """The control-plane CLI on yi-6b at 4 microbatches on the card: its
    delta-fast launches fill_maxmin once per trip, and the baselines'
    results equal a CPU run's."""
    from repro_torch.launch import topo_plan
    base = ["--arch", "yi-6b", "--microbatches", "4"]
    trips = REGISTRY.counter("des_event_trips_total")
    idle = REGISTRY.counter("des_graph_idle_trips_total")
    t0, i0, m0 = trips.value(), idle.value(), _maxmin_launches()
    card = topo_plan.main([*base, "--time-limit", "8", "--out",
                           str(tmp_path / "card.json")])
    torch.cuda.synchronize()
    assert _maxmin_launches() - m0 == \
        trips.value() - t0 + idle.value() - i0 > 0
    cpu = topo_plan.main([*base, "--methods",
                          "prop-alloc,sqrt-alloc,iter-halve",
                          "--device", "cpu"])
    for m, want in cpu.items():
        np.testing.assert_array_equal(card[m].x, want.x)
        assert card[m].makespan == want.makespan
        assert card[m].nct == want.nct
    fast = card["delta-fast"]
    assert fast.feasible
    assert fast.nct <= min(r.nct for r in cpu.values()) * (1 + 1e-9)


def test_jamba_batch_on_card_matches_numpy(cuda):
    """One batch of 48 genomes of jamba-1.5-large-398b's DAG (2,898 tasks,
    the widest registry DAG; the GA's `auto` backend keeps it on the
    host) with the torch engine forced on the card: one fill_maxmin
    launch per trip, and two genomes within rel 5e-5 of the numpy DES."""
    from repro_torch.configs import ALL_ARCHS
    dag = build_comm_dag(make_job(ALL_ARCHS["jamba-1.5-large-398b"],
                                  seq_len=4096), 400.0)
    assert dag.num_tasks == 2899
    space = TopologySpace(dag)
    prob = DESProblem(dag)
    des = TorchDES(prob)
    assert des.backend == "cuda"
    genomes = space.random_init_batch(np.random.default_rng(0), 48)
    trips = REGISTRY.counter("des_event_trips_total")
    idle = REGISTRY.counter("des_graph_idle_trips_total")
    t0, i0, m0 = trips.value(), idle.value(), _maxmin_launches()
    ms, feas = des.batch_genome_makespan(genomes, space.edge_u,
                                         space.edge_v)
    torch.cuda.synchronize()
    assert _maxmin_launches() - m0 == \
        trips.value() - t0 + idle.value() - i0 > 0
    assert feas.all()
    for g in (0, 47):
        want = simulate(prob, space.to_matrix(genomes[g])).makespan
        assert ms[g] == pytest.approx(want, rel=DES_RTOL)


@pytest.mark.parametrize("example", ["quickstart", "chaos_fleet"])
def test_example_on_card_returns_zero(cuda, example, capsys):
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{example}")
    m0 = _maxmin_launches()
    rc = mod.main([], fast=True) if example == "quickstart" \
        else mod.main([])
    assert not rc
    assert _maxmin_launches() > m0
    assert capsys.readouterr().out


# one architecture of each family: dense, moe, ssm, hybrid, vlm, encdec
FAMILIES = ["qwen3-0.6b", "granite-moe-1b-a400m", "mamba2-130m",
            "jamba-1.5-large-398b", "llama-3.2-vision-11b",
            "whisper-large-v3"]


def _lm_inputs(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))
    xl = cfg.enc_tokens if cfg.encoder_layers else cfg.num_image_tokens
    xkv = torch.from_numpy(rng.standard_normal(
        (b, xl, cfg.d_model)).astype(np.float32)) if xl else None
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, 4)))
    return tokens, xkv, nxt


def _rel(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / (want.abs().max() + 1e-6))


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_serving_on_card_matches_cpu(cuda, arch):
    from repro_torch.configs import REGISTRY as ARCHS
    from repro_torch.models import model as M
    from repro_torch.training import train_step as ts
    cfg = ARCHS[arch].config.reduced()
    lm = M.LM(cfg, dtype=torch.float32, device=cuda,
              generator=torch.Generator(device=cuda).manual_seed(0))
    assert lm.embed.is_cuda
    cpu_lm = M.LM(cfg, dtype=torch.float32, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    cpu_lm.load_state_dict({k: v.cpu() for k, v in lm.state_dict().items()})
    tokens, xkv, nxt = _lm_inputs(cfg, 2, 12)
    prefill = ts.make_prefill_step(cfg, has_xkv=xkv is not None)
    decode = ts.make_decode_step(cfg)
    logits = {}
    for dev, model in ((cuda, lm), (torch.device("cpu"), cpu_lm)):
        cache = M.init_cache(cfg, 2, 16, dtype=torch.float32, device=dev,
                             enc_len=0 if xkv is None else xkv.shape[1])
        out, cache = prefill(model, cache, tokens.to(dev),
                             None if xkv is None else xkv.to(dev))
        steps = [out]
        for t in range(4):
            _, out, cache = decode(model, cache, nxt[:, t:t + 1].to(dev))
            steps.append(out)
        logits[dev.type] = steps
    for step, (got, want) in enumerate(zip(logits["cuda"], logits["cpu"])):
        assert got.is_cuda
        assert _rel(got, want) < 1e-4, f"{arch} step {step}"


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_decode_matches_full_forward_on_card(cuda, arch):
    from repro_torch.configs import REGISTRY as ARCHS
    from repro_torch.models import model as M
    cfg = ARCHS[arch].config.reduced()
    lm = M.LM(cfg, dtype=torch.float32, device=cuda,
              generator=torch.Generator(device=cuda).manual_seed(1))
    tokens, xkv, nxt = _lm_inputs(cfg, 2, 24, seed=1)
    tokens, nxt = tokens.to(cuda), nxt[:, :1].to(cuda)
    xkv = None if xkv is None else xkv.to(cuda)
    cache = M.init_cache(cfg, 2, 26, dtype=torch.float32, device=cuda,
                         enc_len=0 if xkv is None else xkv.shape[1])
    with torch.no_grad():
        _, cache = M.forward(cfg, lm, tokens, xkv=xkv, cache=cache)
        dec, _ = M.forward(cfg, lm, nxt, cache=cache)
        full, _ = M.forward(cfg, lm, torch.cat([tokens, nxt], 1), xkv=xkv)
    assert bool(torch.isfinite(full).all())
    assert _rel(dec[:, 0], full[:, -1]) < 2e-2, arch


def test_serve_main_on_card(cuda, capsys):
    from repro_torch.launch import serve
    out = serve.main(["--arch", "qwen3-0.6b", "--reduce", "--batch", "2",
                      "--prompt-len", "16", "--decode-steps", "4"])
    assert out["logits"].is_cuda
    assert bool(torch.isfinite(out["logits"]).all())
    assert out["tokens"].shape == (2, 5)
    assert capsys.readouterr().out.startswith("[serve] qwen3-0.6b-smoke: ")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_step_on_card_matches_cpu(cuda, arch):
    """One reduced train step of each registry architecture (with the
    modality input of a vlm / encdec model) from one float32 state on the
    card and on the CPU: loss rel 1e-5, grad norm rel 1e-4, parameters
    within 2 lr (Adam's first step moves each element by about lr * g /
    |g|), every state tensor on the card."""
    import copy
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as ts
    from repro_torch.training.data import SyntheticLM
    cfg = ARCHS[arch].config.reduced()
    ocfg = O.AdamWConfig(lr=1e-3, warmup_steps=1)
    card = ts.init_train_state(
        cfg, ocfg, device=cuda, dtype=torch.float32,
        generator=torch.Generator(device=cuda).manual_seed(0))
    host = {"params": copy.deepcopy(card["params"]).cpu(),
            "opt": {"m": {n: t.cpu() for n, t in card["opt"]["m"].items()},
                    "v": {n: t.cpu() for n, t in card["opt"]["v"].items()},
                    "step": card["opt"]["step"].cpu()}}
    xl = cfg.enc_tokens if cfg.encoder_layers else cfg.num_image_tokens
    batch = SyntheticLM(vocab=cfg.vocab).batch(
        0, 2, 16, (xl, cfg.d_model) if xl else None)
    step = ts.make_train_step(cfg, ocfg, remat=False, has_xkv=bool(xl))
    out = []
    for dev, state in ((cuda, card), (torch.device("cpu"), host)):
        state, m = step(state, {k: torch.from_numpy(v).to(dev)
                                for k, v in batch.items()})
        out.append((state, {k: float(v) for k, v in m.items()}))
    (cs, cm), (hs, hm) = out
    assert cm["loss"] == pytest.approx(hm["loss"], rel=1e-5)
    assert cm["grad_norm"] == pytest.approx(hm["grad_norm"], rel=1e-4)
    assert all(p.is_cuda for p in cs["params"].parameters())
    assert all(t.is_cuda for t in (*cs["opt"]["m"].values(),
                                   *cs["opt"]["v"].values(),
                                   cs["opt"]["step"]))
    host_params = dict(hs["params"].named_parameters())
    for name, p in cs["params"].named_parameters():
        assert float((p.detach().cpu() - host_params[name].detach())
                     .abs().max()) <= 2 * ocfg.lr, name


def test_checkpoint_save_and_restore_on_card(cuda, tmp_path):
    """A train state on the card after one step: saved, restored onto the
    card equal tensor for tensor, and restored onto the CPU (`device`)
    equal as well."""
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as ts
    from repro_torch.training.data import SyntheticLM
    cfg = ARCHS["jamba-1.5-large-398b"].config.reduced()
    ocfg = O.AdamWConfig(state_dtype=torch.bfloat16)
    state = ts.init_train_state(
        cfg, ocfg, device=cuda,
        generator=torch.Generator(device=cuda).manual_seed(0))
    batch = SyntheticLM(vocab=cfg.vocab).batch(0, 2, 16)
    state, _ = ts.make_train_step(cfg, ocfg)(
        state, {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()})
    path = ckpt.save(str(tmp_path), 1, state)
    for device in (None, "cpu"):
        back, step, _ = ckpt.restore(path, state, device=device)
        assert step == 1
        want = dict(state["params"].named_parameters())
        for name, p in back["params"].named_parameters():
            assert p.device.type == (device or "cuda")
            assert p.dtype == want[name].dtype
            assert torch.equal(p.detach().cpu(), want[name].detach().cpu())
        for key in ("m", "v"):
            for name, t in back["opt"][key].items():
                assert t.dtype == torch.bfloat16
                assert torch.equal(t.cpu(), state["opt"][key][name].cpu())
        assert int(back["opt"]["step"]) == 1


def test_one_device_cuda_mesh_places_plain_tensors(cuda):
    """`make_host_mesh(1, "cuda")` (a world-size-1 NCCL group unless one
    exists): the sharding rules place a state's tensors as themselves,
    plain and on the card; a CPU tensor moves to the card unchanged, and
    the placed cache and batch equal their CPU originals."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as ts
    mesh = make_host_mesh(1, cuda)
    assert shd.axis_sizes(mesh) == {"data": 1, "model": 1}
    assert dist.get_world_size() == 1
    cfg = ARCHS["granite-moe-1b-a400m"].config.reduced()
    state = ts.init_train_state(
        cfg, O.AdamWConfig(), device=cuda,
        generator=torch.Generator(device=cuda).manual_seed(0))
    before = dict(state["params"].named_parameters())
    placed = shd.place(state, shd.named(
        shd.tree_specs(state, mesh, "state", cfg=cfg), mesh))
    for name, p in placed["params"].named_parameters():
        assert p is before[name] and not isinstance(p, DTensor)
    cache = M.init_cache(cfg, 2, 8, device="cpu")
    for layer in cache["layers"]:
        for t in layer.values():
            t.normal_(generator=torch.Generator().manual_seed(1))
    on_card = shd.place(cache, shd.named(shd.tree_specs(cache, mesh,
                                                        "cache"), mesh))
    for got, want in zip(on_card["layers"], cache["layers"]):
        for k, t in got.items():
            assert t.is_cuda and not isinstance(t, DTensor)
            assert torch.equal(t.cpu(), want[k])
    batch = {"tokens": torch.arange(32, dtype=torch.int32).reshape(2, 16)}
    got = shd.place(batch, shd.named(shd.tree_specs(batch, mesh, "batch"),
                                     mesh))
    assert got["tokens"].is_cuda and torch.equal(got["tokens"].cpu(),
                                                 batch["tokens"])
