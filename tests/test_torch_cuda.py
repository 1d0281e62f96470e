"""The port's Hopper kernel and the torch DES on a CUDA device.

Skipped without one (the kernel has no CPU mode).  This file imports no
JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: rtol/atol 1e-5 kernel against its plain version (float32 sums
in another order, as in tests/test_kernels.py); rel 5e-5 DES against the
numpy oracle (as in tests/test_des_jax.py)."""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import gpt7b_job
from repro_torch.core.des import DESProblem, simulate
from repro_torch.core.des_torch import DESOptions, TorchDES
from repro_torch.core.ga import GAOptions, delta_fast
from repro_torch.core.schedule import build_comm_dag
from repro_torch.core.traffic import JobSpec
from repro_torch.kernels import ops, waterfill
from repro_torch.kernels.ref import fill_matvec_ref

pytestmark = pytest.mark.cuda

RTOL = ATOL = 1e-5
# the sweep of tests/test_kernels.py, plus the main path's (C, N)
SHAPES = [(3, 5), (100, 257), (130, 64), (1, 1), (128, 128), (80, 832)]


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
