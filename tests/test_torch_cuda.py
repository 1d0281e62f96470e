"""The port's Hopper kernels, the torch DES, Alg. 2's kernel closure and
the longest-path layer on a CUDA device.

Skipped without one (the kernels have no CPU mode).  This file imports no
JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: rtol/atol 1e-5 waterfill kernel against its plain version
(float32 sums in another order, as in tests/test_kernels.py); none for
tclosure and maxplus, which are bit-equal to their plain versions (a
boolean product; a max of float32 sums, each rounded once); rel 5e-5 DES
against the numpy oracle (as in tests/test_des_jax.py); atol 1e-5 x max
EST for longest paths (float32) against Alg. 4 (float64)."""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import gpt7b_job
from repro_torch.core.dag import VIRTUAL
from repro_torch.core.des import DESProblem, simulate
from repro_torch.core.des_torch import DESOptions, TorchDES
from repro_torch.core.ga import GAOptions, delta_fast
from repro_torch.core.pruning import (cal_task_time_windows, dep_weights,
                                      estimate_t_up)
from repro_torch.core.schedule import build_comm_dag
from repro_torch.core.traffic import JobSpec
from repro_torch.core.xbound import (reachability_bitset,
                                     reachability_kernel, x_upper_bound)
from repro_torch.kernels import _build, maxplus, ops, tclosure, waterfill
from repro_torch.kernels.ref import (NEG_INF, fill_matvec_ref, maxplus_ref,
                                     tclosure_step_ref)

pytestmark = pytest.mark.cuda

RTOL = ATOL = 1e-5
# the sweep of tests/test_kernels.py, plus the main path's (C, N)
SHAPES = [(3, 5), (100, 257), (130, 64), (1, 1), (128, 128), (80, 832)]
# tests/test_kernels.py's closure and max-plus sweeps, plus megatron-462b's n
TC_SIZES = [1, 5, 64, 127, 128, 130, 257, 801]
TC_DTYPES = [torch.bool, torch.int8, torch.int32, torch.float32]
MP_SHAPES = [(3, 4, 5), (64, 64, 64), (130, 17, 70), (1, 1, 1),
             (128, 128, 128), (801, 801, 801)]


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
    before = waterfill.launches
    ms_b, feas_b = td.batch_makespan(xs)
    assert waterfill.launches > before
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
