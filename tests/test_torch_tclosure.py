"""The port's closure step (`repro_torch.kernels`) against the JAX reference:
its plain-torch path on the CPU against `repro.kernels.ref` and the Pallas
kernel in interpret mode, on the shape and dtype sweeps of
tests/test_kernels.py.  The Hopper kernel itself is held against the plain
path in tests/test_torch_cuda.py, on a CUDA device.

The kernel's packed layout (the word stride, padding bits zero) and its
choice of path by n (`tclosure.plan`) are held here too, through the plain
replay `tclosure_packed_ref`.

Tolerance: none -- a boolean closure is exact, so every comparison is bit
equality."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
from repro.kernels import ops as jax_ops
from repro.kernels.ref import tclosure_step_ref as jax_tclosure_step_ref
from repro_torch.kernels import ops, tclosure
from repro_torch.kernels.ref import (tclosure_packed_ref, tclosure_step_ref,
                                     transitive_closure_ref)


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


# The kernel's packed layout and its choice of path (`tclosure.plan`),
# held through the plain replay `ref.tclosure_packed_ref`.
@pytest.mark.parametrize("n", [1, 31, 32, 33, 127, 801])
@pytest.mark.parametrize("density", [0.005, 0.2])
def test_packed_replay_matches_plain_and_jax(n, density):
    rng = np.random.default_rng(n * 3 + int(density * 1000))
    a = rng.random((n, n)) < density
    got = tclosure_packed_ref(torch.from_numpy(a))
    assert got.dtype == torch.bool and got.shape == (n, n)
    assert torch.equal(got, tclosure_step_ref(torch.from_numpy(a)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_tclosure_step_ref(jnp.asarray(a))))


def test_packed_replay_of_a_full_row_and_column():
    """Set bits in the last column and the last word's padding position:
    nothing reaches past column n."""
    n = 33
    a = torch.zeros((n, n), dtype=torch.bool)
    a[:, n - 1] = True
    a[n - 1, :] = True
    assert torch.equal(tclosure_packed_ref(a), tclosure_step_ref(a))


@pytest.mark.parametrize("n,ws", [(1, 4), (32, 4), (128, 4), (129, 8),
                                  (801, 28), (1024, 32), (1025, 36),
                                  (1310, 44)])
def test_word_stride(n, ws):
    assert tclosure.word_stride(n) == ws
    assert ws % 4 == 0 and 32 * ws >= n


def test_plan_picks_the_path_by_n():
    sms = 132
    limit = max(n for n in range(1, 2000) if tclosure.plan(n, sms).resident)
    assert limit == 1310
    for n in (1, 5, 801, limit):
        p = tclosure.plan(n, sms)
        assert p.resident and p.smem <= tclosure.MAX_SMEM_BYTES
        assert p.blocks == min(sms, n) and 1 <= p.warps <= 32
        rows, chunks = -(-n // p.blocks), -(-(-(-n // 32)) // 2)
        assert p.smem == 4 * n * p.ws + 16 + 4 * rows * p.ws
        assert p.warps == min(32, rows * chunks)
    for n in (limit + 1, 2000, 20000):
        p = tclosure.plan(n, sms)
        assert not p.resident and p.smem + tclosure.SLAB_BYTES \
            <= tclosure.MAX_SMEM_BYTES
    assert tclosure.plan(801, sms) == tclosure.Plan(
        ws=28, resident=True, blocks=132, warps=32, smem=90512)
    with pytest.raises(ValueError, match="shared memory"):
        tclosure.plan(10 ** 6, sms)


@pytest.mark.parametrize("n", [1, 5, 131, 132, 133, 801, 1310])
def test_resident_rows_cover_every_row_once(n):
    """Block b owns rows b, b + G, ... (the kernel's deal): every row
    once, at most `rows` per block, which sizes the accumulators."""
    p = tclosure.plan(n, 132)
    owned = [i for b in range(p.blocks) for i in range(b, n, p.blocks)]
    assert sorted(owned) == list(range(n))
    assert max(len(range(b, n, p.blocks)) for b in range(p.blocks)) \
        == -(-n // p.blocks)


def test_layout_matches_the_source():
    src = (Path(tclosure.__file__).parent / "csrc" / "tclosure.cu") \
        .read_text()
    const = {name: int(v) for name, v in
             re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kChunkWords"] == tclosure.CHUNK_WORDS
    assert const["kRows"] == tclosure.STREAM_ROWS
    assert 2 * const["kWarp"] * const["kTileWords"] * 4 \
        == tclosure.SLAB_BYTES
