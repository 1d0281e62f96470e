"""Hopper kernel for the fused water-filling matvec (CUDA C++, sm_90a).

`fill_matvec(w, rhs)` computes ``w @ rhs`` for a constraint-task incidence
matrix ``w`` (C, N) shared by every lane of a batch of right-hand sides
(N, R) or (B, N, R).  `fill_round` is the DES layout of the same kernel:
one progressive-filling round's per-constraint ``(used, denom)`` from the
lanes' ``level`` and ``unfrozen`` vectors.  It replaces the Pallas kernel
`repro/kernels/waterfill.py:47 fill_matvec`; the source, with what bounds
it on the card, is `csrc/waterfill.cu`.

The kernel is built with ``nvcc`` at first use from that source alone and
loaded with ``ctypes`` (`repro_torch.kernels._build`).  This module
launches the kernel and nothing else: the plain version lives in
`repro_torch.kernels.ref`, and the choice between the two is
`repro_torch.kernels.ops`'s.

`launches` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0


def _kernel():
    return _build.function(
        "waterfill", "waterfill_fill_matvec",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _check(name: str, t: torch.Tensor, device: torch.device) -> None:
    if not t.is_cuda:
        raise ValueError(f"waterfill kernel: {name} is on {t.device}, "
                         f"not a CUDA device")
    if t.device != device:
        raise ValueError(f"waterfill kernel: {name} is on {t.device}, "
                         f"w on {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"waterfill kernel: {name} is {t.dtype}, "
                         f"needs torch.float32")
    if not t.is_contiguous():
        raise ValueError(f"waterfill kernel: {name} must be contiguous")


def fill_matvec(w: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``w (C, N) @ rhs`` for rhs (N, R) -> (C, R) or (B, N, R) ->
    (B, C, R), float32, on the kernel.  Raises on anything the kernel does
    not take; launches on the current stream and does not synchronise."""
    global launches
    _check("w", w, w.device)
    _check("rhs", rhs, w.device)
    if w.dim() != 2 or rhs.dim() not in (2, 3):
        raise ValueError(f"waterfill kernel: needs w (C, N) and rhs (N, R) "
                         f"or (B, N, R), got {tuple(w.shape)} and "
                         f"{tuple(rhs.shape)}")
    c, n = w.shape
    batch, n2, r = rhs.shape if rhs.dim() == 3 else (1, *rhs.shape)
    if n2 != n:
        raise ValueError(f"waterfill kernel: w has N={n}, rhs N={n2}")
    if batch > 65535:
        raise ValueError(f"waterfill kernel: batch {batch} exceeds the "
                         f"grid's 65535")
    out = torch.empty((batch, c, r), dtype=torch.float32, device=w.device)
    if out.numel():
        with torch.cuda.device(w.device):
            stream = torch.cuda.current_stream(w.device).cuda_stream
            err = _kernel()(
                w.data_ptr(), rhs.data_ptr(), out.data_ptr(), batch, c, n,
                r, stream)
        if err != 0:
            raise RuntimeError(f"waterfill kernel launch failed: "
                               f"cudaError {err}")
        launches += 1
    return out if rhs.dim() == 3 else out[0]


def fill_round(w: torch.Tensor, level: torch.Tensor, unfrozen: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One DES filling round on the kernel: ``level``/``unfrozen`` (N,) or
    (B, N) -> per-constraint ``(used, denom)`` (C,) or (B, C)."""
    out = fill_matvec(w, torch.stack([level, unfrozen], dim=-1))
    return out[..., 0], out[..., 1]
