"""The port's closure step (`repro_torch.kernels`) against the JAX reference:
its plain-torch path on the CPU against `repro.kernels.ref` and the Pallas
kernel in interpret mode, on the shape and dtype sweeps of
tests/test_kernels.py.  The Hopper kernel itself is held against the plain
path in tests/test_torch_cuda.py, on a CUDA device.

Tolerance: none -- a boolean closure is exact, so every comparison is bit
equality."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
from repro.kernels import ops as jax_ops
from repro.kernels.ref import tclosure_step_ref as jax_tclosure_step_ref
from repro_torch.kernels import ops, tclosure
from repro_torch.kernels.ref import tclosure_step_ref, transitive_closure_ref


@pytest.mark.parametrize("n", [1, 5, 64, 127, 128, 130, 257])
@pytest.mark.parametrize("density", [0.02, 0.2])
def test_tclosure_step_matches_jax(n, density):
    rng = np.random.default_rng(n + int(density * 100))
    a = rng.random((n, n)) < density
    got = ops.tclosure_step(torch.from_numpy(a)).numpy()
    want_ref = np.asarray(jax_tclosure_step_ref(jnp.asarray(a)))
    want_pallas = np.asarray(jax_ops.tclosure_step(a, backend="pallas",
                                                   interpret=True))
    assert got.dtype == np.bool_ and got.shape == (n, n)
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_array_equal(got, want_pallas)


@pytest.mark.parametrize("dtype", [np.bool_, np.int8, np.int32, np.float32])
def test_tclosure_dtypes(dtype):
    rng = np.random.default_rng(40)
    a = (rng.random((40, 40)) < 0.1).astype(dtype)
    got = ops.tclosure_step(torch.from_numpy(a)).numpy()
    want = np.asarray(jax_ops.tclosure_step(a, backend="pallas",
                                            interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tclosure_step_ref(
        torch.from_numpy(a != 0)).numpy())


def test_transitive_closure_vs_bruteforce():
    n = 30
    rng = np.random.default_rng(30)
    a = np.triu(rng.random((n, n)) < 0.15, k=1)
    got = ops.transitive_closure(torch.from_numpy(a)).numpy()
    reach = a.copy()
    for _ in range(n):
        reach = reach | (reach @ a)
    np.testing.assert_array_equal(got, reach)
    np.testing.assert_array_equal(
        got, transitive_closure_ref(torch.from_numpy(a)).numpy())
    np.testing.assert_array_equal(got, np.asarray(jax_ops.transitive_closure(
        a, backend="pallas", interpret=True)))


@settings(max_examples=15, deadline=None)
@given(st.integers(2, 40), st.integers(0, 2**31 - 1))
def test_property_closure_idempotent(n, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(np.triu(rng.random((n, n)) < 0.2, k=1))
    cl = ops.transitive_closure(a)
    assert torch.equal(ops.tclosure_step(cl), cl)   # a fixed point
    assert torch.equal(cl, transitive_closure_ref(a))


def test_ref_backend_default_on_cpu():
    rng = np.random.default_rng(16)
    a = torch.from_numpy(rng.random((16, 16)) < 0.2)
    assert torch.equal(ops.tclosure_step(a), tclosure_step_ref(a))
    assert torch.equal(ops.tclosure_step(a, backend="ref"),
                       tclosure_step_ref(a))


def test_cuda_backend_on_cpu_tensor_raises():
    a = torch.ones((4, 4), dtype=torch.bool)
    before = tclosure.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        ops.tclosure_step(a, backend="cuda")
    with pytest.raises(ValueError, match="not a CUDA device"):
        ops.transitive_closure(a, backend="cuda")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ops.tclosure_step(a, backend="pallas")
    assert tclosure.launches == before
