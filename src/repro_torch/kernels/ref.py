"""Plain-torch versions of the port's kernels.

They define the semantics (`repro.kernels.ref` is their JAX counterpart):
the CPU tests run them, `repro_torch.kernels.ops` takes them for tensors
on the CPU, and `chip_smoke.py` holds each Hopper kernel against them on
the card.  The water-filling pair accepts a leading batch axis on its
per-lane operands.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30  # finite stand-in for -inf in max-plus


def tclosure_step_ref(a: torch.Tensor) -> torch.Tensor:
    """One squaring step of boolean transitive closure: A | (A @ A > 0),
    the product in float32 (exact for n <= 2^24; TF32 is off)."""
    a = a != 0
    f = a.to(torch.float32)
    return a | (f @ f > 0.5)


def transitive_closure_ref(a: torch.Tensor, max_steps: int | None = None
                           ) -> torch.Tensor:
    """Full closure by repeated squaring (host loop; offline planning code)."""
    a = a != 0
    n = a.shape[0]
    steps = max_steps if max_steps is not None else max(
        1, math.ceil(math.log2(max(n, 2))))
    for _ in range(steps):
        nxt = tclosure_step_ref(a)
        if bool((nxt == a).all()):
            return nxt
        a = nxt
    return a


def maxplus_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Tropical (max, +) matrix product: out[i,j] = max_k a[i,k] + b[k,j].

    Entries <= NEG_INF are treated as 'no edge'.
    """
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    return (a[:, :, None] + b[None]).amax(1).clamp_min(NEG_INF)


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
