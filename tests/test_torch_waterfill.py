"""The port's water-filling matvec (`repro_torch.kernels`) against the JAX
reference: its plain-torch path on the CPU against `repro.kernels.ref` and
the Pallas kernel in interpret mode, on the shape sweep of
tests/test_kernels.py.  The Hopper kernel itself is held against the plain
path in tests/test_torch_cuda.py, on a CUDA device.

Tolerance: rtol/atol 1e-5, as in tests/test_kernels.py -- float32 sums of
at most a few hundred terms, taken in another order on each side."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jax_ops
from repro.kernels.ref import fill_matvec_ref as jax_fill_matvec_ref
from repro_torch.kernels import ops, waterfill
from repro_torch.kernels.ref import fill_round_ref

RTOL = ATOL = 1e-5
SHAPES = [(3, 5), (100, 257), (130, 64), (1, 1), (128, 128)]


def _w(rng, c, n):
    return (rng.random((c, n)) * (rng.random((c, n)) < 0.3)) \
        .astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("rhs_cols", [1, 2, 3])
def test_fill_matvec_matches_jax(shape, rhs_cols):
    c, n = shape
    rng = np.random.default_rng(c * 1000 + n + rhs_cols)
    w = _w(rng, c, n)
    rhs = rng.random((n, rhs_cols)).astype(np.float32)
    got = ops.fill_matvec(torch.from_numpy(w), torch.from_numpy(rhs)).numpy()
    want_ref = np.asarray(jax_fill_matvec_ref(jnp.asarray(w),
                                              jnp.asarray(rhs)))
    want_pallas = np.asarray(jax_ops.fill_matvec(w, rhs, backend="pallas",
                                                 interpret=True))
    assert got.shape == (c, rhs_cols)
    np.testing.assert_allclose(got, want_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want_pallas, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(3, 5), (34, 273), (130, 64)])
def test_fill_round_matches_jax(shape):
    c, n = shape
    rng = np.random.default_rng(c + n)
    w = _w(rng, c, n)
    level = rng.random(n).astype(np.float32)
    unfrozen = (rng.random(n) < 0.5).astype(np.float32)
    used, denom = ops.fill_round(torch.from_numpy(w),
                                 torch.from_numpy(level),
                                 torch.from_numpy(unfrozen))
    for backend in ("pallas", "ref"):
        ju, jd = jax_ops.fill_round(w, level, unfrozen, backend=backend,
                                    interpret=True)
        np.testing.assert_allclose(used.numpy(), np.asarray(ju),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(denom.numpy(), np.asarray(jd),
                                   rtol=RTOL, atol=ATOL)


def test_fill_round_batched_equals_per_lane():
    """A leading batch axis on (level, unfrozen) is the per-lane rounds
    stacked: the DES evaluates a whole GA population in one call."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(_w(rng, 80, 832))
    level = torch.from_numpy(rng.random((6, 832)).astype(np.float32))
    unfrozen = torch.from_numpy(
        (rng.random((6, 832)) < 0.5).astype(np.float32))
    used, denom = ops.fill_round(w, level, unfrozen)
    assert used.shape == denom.shape == (6, 80)
    for b in range(6):
        u, d = fill_round_ref(w, level[b], unfrozen[b])
        torch.testing.assert_close(used[b], u, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(denom[b], d, rtol=RTOL, atol=ATOL)


def test_cuda_backend_on_cpu_tensor_raises():
    w = torch.ones((4, 3))
    rhs = torch.ones((3, 2))
    before = waterfill.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        ops.fill_matvec(w, rhs, backend="cuda")
    with pytest.raises(ValueError, match="not a CUDA device"):
        ops.fill_round(w, rhs[:, 0], rhs[:, 1], backend="cuda")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ops.fill_matvec(w, rhs, backend="pallas")
    assert waterfill.launches == before
