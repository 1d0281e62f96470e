"""Plain-torch versions of the port's kernels.

They define the semantics (`repro.kernels.ref` is their JAX counterpart):
the CPU tests run them, `repro_torch.kernels.ops` takes them for tensors
on the CPU, and `chip_smoke.py` holds each Hopper kernel against them on
the card.  Every function accepts a leading batch axis on its per-lane
operands.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30  # finite stand-in for -inf in max-plus (the later kernels)


def fill_matvec_ref(w: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Fused water-filling matvec pair: one pass over the incidence matrix.

    w:   (C, N) constraint-task incidence weights
    rhs: (N, R) or (B, N, R) stacked right-hand sides
         (R=2: [phi*active, unfrozen])
    returns (C, R) or (B, C, R) = w @ rhs in float32.
    """
    return w.to(torch.float32) @ rhs.to(torch.float32)


def fill_round_ref(w: torch.Tensor, level: torch.Tensor,
                   unfrozen: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """One DES fair-share filling round: per-constraint (used, denom) for
    ``level``/``unfrozen`` of shape (N,) or (B, N)."""
    out = fill_matvec_ref(w, torch.stack([level, unfrozen], dim=-1))
    return out[..., 0], out[..., 1]
