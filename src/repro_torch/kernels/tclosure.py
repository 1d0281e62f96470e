"""Hopper kernel for one boolean transitive-closure step (CUDA C++, sm_90a).

`tclosure_step(a)` computes ``A | (A . A)`` in the OR-AND semiring for a
square 0/1 matrix ``a`` (bool, int8, int32 or float32; nonzero is set) and
returns it as bool.  It replaces the Pallas kernel
`repro/kernels/tclosure.py:41 tclosure_step`; the source, with what bounds
it on the card, is `csrc/tclosure.cu`: it packs each row into 32-bit words
and squares the packed matrix exactly, with no atomics.

The kernel is built with ``nvcc`` at first use from that source alone and
loaded with ``ctypes`` (`repro_torch.kernels._build`).  This module
launches the kernel and nothing else: the plain version lives in
`repro_torch.kernels.ref`, and the choice between the two is
`repro_torch.kernels.ops`'s.

`launches` counts the kernel's launches (one per step), so a run can show
that its path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0

# element types the kernel reads, by the code its C interface takes
_DTYPES = {torch.bool: 0, torch.int8: 1, torch.int32: 2, torch.float32: 3}


def _kernel():
    return _build.function(
        "tclosure", "tclosure_step",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_void_p])


def tclosure_step(a: torch.Tensor) -> torch.Tensor:
    """``A | (A . A)`` as bool (n, n) for a square 0/1 matrix on the
    kernel.  Raises on anything the kernel does not take; launches on the
    current stream and does not synchronise."""
    global launches
    if not a.is_cuda:
        raise ValueError(f"tclosure kernel: a is on {a.device}, not a CUDA "
                         f"device")
    if a.dtype not in _DTYPES:
        raise ValueError(f"tclosure kernel: a is {a.dtype}, needs one of "
                         f"{sorted(map(str, _DTYPES))}")
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"tclosure kernel: needs a square matrix, got "
                         f"{tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError("tclosure kernel: a must be contiguous")
    n = a.shape[0]
    out = torch.empty((n, n), dtype=torch.bool, device=a.device)
    if n:
        bits = torch.empty((n, (n + 31) // 32), dtype=torch.int32,
                           device=a.device)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = _kernel()(a.data_ptr(), _DTYPES[a.dtype], bits.data_ptr(),
                            out.data_ptr(), n, stream)
        if err != 0:
            raise RuntimeError(f"tclosure kernel launch failed: "
                               f"cudaError {err}")
        launches += 1
    return out
