"""Hopper kernels for water-filling (CUDA C++, sm_90a).

`fill_matvec(w, rhs)` computes ``w @ rhs`` for a constraint-task incidence
matrix ``w`` (C, N) shared by every lane of a batch of right-hand sides
(N, R) or (B, N, R).  `fill_round` is the DES layout of the same kernel:
one progressive-filling round's per-constraint ``(used, denom)`` from the
lanes' ``level`` and ``unfrozen`` vectors.  `fill_maxmin` runs every
progressive-filling round of one DES event trip, for every lane, in one
launch, with the incidence as CSR in shared memory; one launch may serve
the members of an ensemble, lane by lane.  Both replace the
Pallas kernel `repro/kernels/waterfill.py:47 fill_matvec` (`fill_maxmin`
with the `while_loop` of `repro/core/des_jax.py:256 _maxmin` around it);
the source, with what bounds each on the card, is `csrc/waterfill.cu`.

The kernel is built with ``nvcc`` at first use from that source alone and
loaded with ``ctypes`` (`repro_torch.kernels._build`).  This module
launches the kernel and nothing else: the plain version lives in
`repro_torch.kernels.ref`, and the choice between the two is
`repro_torch.kernels.ops`'s.

`launches` counts `fill_matvec`'s launches and `maxmin_launches`
`fill_maxmin`'s, so a run can show that its path went through the kernel.
Both count launches made from the host: a call that a CUDA graph's
capture records counts none, and neither do the graph's replays, whose
launches only a device trace shows.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0
maxmin_launches = 0
MAX_SMEM_BYTES = 232448    # 227 KB: the most shared memory a block may have


def _kernel():
    return _build.function(
        "waterfill", "waterfill_fill_matvec",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _maxmin_kernel():
    return _build.function(
        "waterfill", "waterfill_fill_maxmin",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def maxmin_smem_bytes(n: int, c: int, e: int) -> int:
    """Shared memory one block of `fill_maxmin` needs: the CSR (con_ptr,
    ent_task, ent_w), phi, alpha_c and caps at 4 bytes, and the active,
    unfrozen and hit flags at 1 byte (`maxmin_smem_bytes` in the source)."""
    return 4 * (c + 1) + 8 * e + 4 * n + 8 * c + 3 * n


def _check(name: str, t: torch.Tensor, device: torch.device,
           dtype: torch.dtype = torch.float32) -> None:
    if not t.is_cuda:
        raise ValueError(f"waterfill kernel: {name} is on {t.device}, "
                         f"not a CUDA device")
    if t.device != device:
        raise ValueError(f"waterfill kernel: {name} is on {t.device}, "
                         f"the first operand on {device}")
    if t.dtype != dtype:
        raise ValueError(f"waterfill kernel: {name} is {t.dtype}, "
                         f"needs {dtype}")
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


def fill_maxmin(con_ptr: torch.Tensor, ent_task: torch.Tensor,
                ent_w: torch.Tensor, active: torch.Tensor, caps: torch.Tensor,
                flows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted max-min fair rates of S lanes on the kernel: every
    progressive-filling round in one launch.

    con_ptr (M, C+1) int32, ent_task (M, E) int32 and ent_w (M, E) float32
    are the incidence of M problems as CSR by constraint (each con_ptr row
    rising from 0 to E, every ``ent_task`` in [0, N): the kernel checks
    both with a device assert, which fails the launch at the next
    synchronisation), flows (M, N) float32; one problem is M = 1.  active
    (S, N) bool and caps (S, C) float32 with S a multiple of M: lane s
    reads member s % M (genome-major, member-minor lanes).  Returns
    ``rates`` (S, N) float32, ``flows * phi * active``, and ``rounds``
    (S,) int32, the rounds each lane ran.  Raises on anything the kernel
    does not take, a problem too large for one block's shared memory
    included; launches on the current stream and does not synchronise."""
    global maxmin_launches
    dev = active.device
    for name, t, dtype in (("con_ptr", con_ptr, torch.int32),
                           ("ent_task", ent_task, torch.int32),
                           ("ent_w", ent_w, torch.float32),
                           ("active", active, torch.bool),
                           ("caps", caps, torch.float32),
                           ("flows", flows, torch.float32)):
        _check(name, t, dev, dtype)
    if active.dim() != 2 or caps.dim() != 2 or con_ptr.dim() != 2:
        raise ValueError(f"waterfill kernel: needs active (S, N), caps "
                         f"(S, C) and con_ptr (M, C+1), got "
                         f"{tuple(active.shape)}, {tuple(caps.shape)} and "
                         f"{tuple(con_ptr.shape)}")
    m = con_ptr.shape[0]
    (s, n), (s2, c), e = active.shape, caps.shape, ent_task.shape[-1]
    if s2 != s or c < 1 or m < 1 or con_ptr.shape != (m, c + 1) \
            or ent_task.shape != (m, e) or ent_w.shape != (m, e) \
            or flows.shape != (m, n) or s % m:
        raise ValueError(
            f"waterfill kernel: shapes disagree: active {tuple(active.shape)}"
            f", caps {tuple(caps.shape)}, con_ptr {tuple(con_ptr.shape)}, "
            f"ent_task {tuple(ent_task.shape)}, ent_w {tuple(ent_w.shape)}, "
            f"flows {tuple(flows.shape)} (lanes a multiple of the members)")
    smem = maxmin_smem_bytes(n, c, e)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"waterfill kernel: N={n}, C={c}, E={e} need "
                         f"{smem} bytes of shared memory per block, more "
                         f"than the {MAX_SMEM_BYTES} a block may have")
    rates = torch.empty((s, n), dtype=torch.float32, device=dev)
    rounds = torch.empty(s, dtype=torch.int32, device=dev)
    if s:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _maxmin_kernel()(
                con_ptr.data_ptr(), ent_task.data_ptr(), ent_w.data_ptr(),
                active.data_ptr(), caps.data_ptr(), flows.data_ptr(),
                rates.data_ptr(), rounds.data_ptr(), s, m, n, c, e, stream)
            if err != 0:
                raise RuntimeError(f"waterfill fill_maxmin launch failed: "
                                   f"cudaError {err}")
            if not torch.cuda.is_current_stream_capturing():
                maxmin_launches += 1
    return rates, rounds
