"""Hopper kernel for the tropical (max, +) matrix product (CUDA C++, sm_90a).

`maxplus(a, b)` computes ``out[i, j] = max_k a[i, k] + b[k, j]`` in
float32, clamped at ``NEG_INF`` (the finite "no path"), for a (M, K) and b
(K, N).  It replaces the Pallas kernel `repro/kernels/maxplus.py:40
maxplus`; the source, with what bounds it on the card, is
`csrc/maxplus.cu`: a tiled CUDA-core product with ``fmaxf`` for the sum,
bit-identical to the plain version.

The kernel is built with ``nvcc`` at first use from that source alone and
loaded with ``ctypes`` (`repro_torch.kernels._build`).  This module
launches the kernel and nothing else: the plain version lives in
`repro_torch.kernels.ref`, and the choice between the two is
`repro_torch.kernels.ops`'s.

`launches` counts the kernel's launches, so a run can show that its path
went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0


def _kernel():
    return _build.function(
        "maxplus", "maxplus",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _check(name: str, t: torch.Tensor, device: torch.device) -> None:
    if not t.is_cuda:
        raise ValueError(f"maxplus kernel: {name} is on {t.device}, not a "
                         f"CUDA device")
    if t.device != device:
        raise ValueError(f"maxplus kernel: {name} is on {t.device}, a on "
                         f"{device}")
    if t.dtype != torch.float32:
        raise ValueError(f"maxplus kernel: {name} is {t.dtype}, needs "
                         f"torch.float32")
    if t.dim() != 2:
        raise ValueError(f"maxplus kernel: {name} must be a matrix, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"maxplus kernel: {name} must be contiguous")


def maxplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Max-plus product of a (M, K) and b (K, N) -> (M, N), float32, on
    the kernel.  Raises on anything the kernel does not take; launches on
    the current stream and does not synchronise."""
    global launches
    _check("a", a, a.device)
    _check("b", b, a.device)
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"maxplus kernel: a has K={k}, b K={k2}")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if out.numel():
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = _kernel()(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k,
                            n, stream)
        if err != 0:
            raise RuntimeError(f"maxplus kernel launch failed: "
                               f"cudaError {err}")
        launches += 1
    return out
