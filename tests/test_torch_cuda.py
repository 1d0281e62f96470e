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
between the fused and the per-round DES paths (both float32)."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import gpt7b_job
from repro_torch.configs import PAPER_WORKLOADS, make_job
from repro_torch.core.dag import VIRTUAL
from repro_torch.core.des import DESProblem, simulate
from repro_torch.core.des_torch import DESOptions, TorchDES
from repro_torch.core.ga import GAOptions, delta_fast
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
    before = waterfill.maxmin_launches
    ms_b, feas_b = td.batch_makespan(xs)
    assert waterfill.maxmin_launches > before
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
    (when E >= N), with S lanes of active sets and capacities."""
    con = np.concatenate([np.arange(min(n, e)) % c,
                          rng.integers(0, c, max(e - n, 0))])
    task = np.concatenate([np.arange(min(n, e)),
                           rng.integers(0, n, max(e - n, 0))])
    order = np.argsort(con, kind="stable")
    con_ptr = np.zeros(c + 1, dtype=np.int32)
    con_ptr[1:] = np.cumsum(np.bincount(con, minlength=c))
    tensors = (con_ptr, task[order].astype(np.int32),
               rng.uniform(0.1, 3.0, e).astype(np.float32),
               rng.random((s, n)) < density,
               rng.uniform(0.1, 5.0, (s, c)).astype(np.float32),
               rng.uniform(1.0, 4.0, n).astype(np.float32))
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
    con_ptr = torch.tensor([0, 2, 3], dtype=torch.int32, device=cuda)
    ent_task = torch.tensor([0, 1, 1], dtype=torch.int32, device=cuda)
    ent_w = torch.tensor([1.0, 2.0, 1.0], device=cuda)
    flows = torch.tensor([1.0, 2.0, 3.0], device=cuda)
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
        waterfill.fill_maxmin(*args[:5], args[5][:-1].contiguous())
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
        "    torch.tensor([0, 2], **i32), torch.tensor([0, 5], **i32),\n"
        "    torch.ones(2, device='cuda'),\n"
        "    torch.ones((1, 3), dtype=torch.bool, device='cuda'),\n"
        "    torch.ones((1, 1), device='cuda'), torch.ones(3, device='cuda'))\n"
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


def _counts():
    return (waterfill.launches, waterfill.maxmin_launches,
            REGISTRY.counter("des_event_trips_total").value(),
            REGISTRY.counter("des_fill_rounds_total").value())


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
    c0 = _counts()
    ms_f, feas_f = fused.batch_makespan(xs)
    c1 = _counts()
    ms_r, feas_r = per_round.batch_makespan(xs)
    c2 = _counts()
    assert c1[0] == c0[0]                          # no fill_round launch
    assert c1[1] - c0[1] == c1[2] - c0[2] > 0      # one launch per trip
    assert c2[0] - c1[0] == c2[3] - c1[3] > 0      # one launch per round
    assert c2[1] == c1[1]
    ms_p, feas_p = plain.batch_makespan(xs)
    c3 = _counts()
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
