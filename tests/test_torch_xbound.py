"""Alg. 2's closure by matrix squaring in the port
(`repro_torch.core.xbound`, backend 'kernel') against the JAX reference's
`reachability_kernel`, the bitset closure of both packages, and the
reference's X̄, on the CPU (the plain-torch path of the tclosure kernel).
Mirrors tests/test_pruning.py.  On a CUDA device the kernel's closure is
held against the bitset in tests/test_torch_cuda.py.

Tolerance: none -- reachability and X̄ are exact, so every comparison is
equality."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings

from conftest import gpt7b_job, random_comm_dags
from repro.core import xbound as jax_xbound
from repro.core.schedule import build_comm_dag as jax_build_comm_dag
from repro_torch.core import xbound
from repro_torch.core.des import DESProblem
from repro_torch.core.pruning import estimate_t_up
from repro_torch.kernels import tclosure
from test_torch_des import port_dag


@pytest.fixture(scope="module")
def dags():
    ref = jax_build_comm_dag(gpt7b_job(4))
    return ref, port_dag(ref)


def test_kernel_closure_matches_reference(dags):
    ref, dag = dags
    got = xbound.reachability_kernel(dag, device="cpu")
    assert got.dtype == np.bool_ and got.shape == (dag.num_tasks,) * 2
    np.testing.assert_array_equal(got, jax_xbound.reachability_kernel(ref))
    np.testing.assert_array_equal(got, jax_xbound.reachability_bitset(ref))
    np.testing.assert_array_equal(got, xbound.reachability_bitset(dag))
    np.testing.assert_array_equal(
        got, xbound.reachability(dag, "kernel", device="cpu"))


@settings(max_examples=20, deadline=None)
@given(random_comm_dags(max_tasks=9))
def test_property_closure_backends_agree(ref):
    dag = port_dag(ref)
    got = xbound.reachability_kernel(dag, device="cpu")
    np.testing.assert_array_equal(got, xbound.reachability_bitset(dag))
    np.testing.assert_array_equal(got, jax_xbound.reachability_kernel(ref))


def test_x_upper_bound_on_kernel_matches_reference(dags):
    ref, dag = dags
    t_up = estimate_t_up(DESProblem(dag))
    got = xbound.x_upper_bound(dag, t_up, closure_backend="kernel",
                               device="cpu")
    np.testing.assert_array_equal(got, jax_xbound.x_upper_bound(
        ref, t_up, closure_backend="kernel"))
    np.testing.assert_array_equal(got, xbound.x_upper_bound(
        dag, t_up, closure_backend="bitset"))


def test_kernel_closure_without_cuda_raises(dags, monkeypatch):
    """No CUDA device and none named: the kernel closure refuses instead of
    running on the CPU; 'auto' still takes the bitset, as the reference."""
    _, dag = dags
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = tclosure.launches
    with pytest.raises(RuntimeError, match="CUDA device"):
        xbound.reachability_kernel(dag)
    with pytest.raises(RuntimeError, match="CUDA device"):
        xbound.x_upper_bound(dag, 1.0, closure_backend="kernel")
    np.testing.assert_array_equal(xbound.reachability(dag),
                                  xbound.reachability_bitset(dag))
    assert tclosure.launches == before
