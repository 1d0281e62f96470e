"""Public kernel entry points: the choice between a Hopper kernel and its
plain-torch version.

``backend="auto"`` launches the kernel for CUDA tensors and takes the plain
version (`repro_torch.kernels.ref`) for tensors on the CPU, the only place
it runs.  ``"cuda"`` always launches the kernel, and so raises on a CPU
tensor; ``"ref"`` always runs the plain version.  Nothing falls back: a
kernel that fails to build or launch raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels import waterfill as _waterfill

BACKENDS = ("auto", "cuda", "ref")


def _pick(backend: str, t: torch.Tensor) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; "
                         f"pick from {BACKENDS}")
    if backend == "auto":
        return "cuda" if t.is_cuda else "ref"
    return backend


def fill_matvec(w: torch.Tensor, rhs: torch.Tensor, *,
                backend: str = "auto") -> torch.Tensor:
    """``w (C, N) @ rhs`` for rhs (N, R) or (B, N, R), float32."""
    if _pick(backend, rhs) == "cuda":
        return _waterfill.fill_matvec(w, rhs)
    return _ref.fill_matvec_ref(w, rhs)


def fill_round(w: torch.Tensor, level: torch.Tensor, unfrozen: torch.Tensor,
               *, backend: str = "auto"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One DES max-min filling round: per-constraint (used, denom) from one
    fused pass over the incidence matrix (the `repro_torch.core.des_torch`
    inner reduction; called once per saturation level of every event)."""
    if _pick(backend, level) == "cuda":
        return _waterfill.fill_round(w, level, unfrozen)
    return _ref.fill_round_ref(w, level, unfrozen)
