"""Public kernel entry points: the choice between a Hopper kernel and its
plain-torch version.

``backend="auto"`` launches the kernel for CUDA tensors and takes the plain
version (`repro_torch.kernels.ref`) for tensors on the CPU, the only place
it runs.  ``"cuda"`` always launches the kernel, and so raises on a CPU
tensor; ``"ref"`` always runs the plain version.  Nothing falls back: a
kernel that fails to build or launch raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import maxplus as _maxplus
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import tclosure as _tclosure
from repro_torch.kernels import waterfill as _waterfill

NEG_INF = _ref.NEG_INF

BACKENDS = ("auto", "cuda", "ref")


def _pick(backend: str, t: torch.Tensor) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; "
                         f"pick from {BACKENDS}")
    if backend == "auto":
        return "cuda" if t.is_cuda else "ref"
    return backend


def tclosure_step(a: torch.Tensor, *, backend: str = "auto"
                  ) -> torch.Tensor:
    """One boolean closure-squaring step ``A | (A . A)`` -> bool (n, n)."""
    if _pick(backend, a) == "cuda":
        return _tclosure.tclosure_step(a)
    return _ref.tclosure_step_ref(a)


def transitive_closure(a: torch.Tensor, *, backend: str = "auto"
                       ) -> torch.Tensor:
    """Full boolean transitive closure by repeated squaring (host loop with
    early fixed-point exit -- this is offline planning code)."""
    a = a.to(torch.bool)
    n = a.shape[0]
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):
        nxt = tclosure_step(a, backend=backend)
        if bool((nxt == a).all()):  # sentinel: ignore[RPR006] one per squaring step: the fixpoint
            return nxt
        a = nxt
    return a


def maxplus(a: torch.Tensor, b: torch.Tensor, *, backend: str = "auto"
            ) -> torch.Tensor:
    """Tropical product ``max_k a[i,k] + b[k,j]``, float32, clamped at
    NEG_INF."""
    if _pick(backend, a) == "cuda":
        return _maxplus.maxplus(a, b)
    return _ref.maxplus_ref(a, b)


def longest_paths(adj: torch.Tensor, *, backend: str = "auto"
                  ) -> torch.Tensor:
    """All-pairs longest path of a weighted DAG adjacency matrix.

    adj[i, j] = edge weight, NEG_INF when no edge.  Diagonal is forced to 0
    (empty path).  Repeated max-plus squaring, host loop with fixed point.
    """
    a = adj.to(torch.float32)
    n = a.shape[0]
    eye = torch.full((n, n), NEG_INF, dtype=torch.float32, device=a.device)
    d = torch.maximum(a, eye.fill_diagonal_(0.0))
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):
        nxt = maxplus(d, d, backend=backend)
        nxt = torch.clamp_min(nxt, NEG_INF)
        if torch.allclose(nxt, d):  # sentinel: ignore[RPR006] one per squaring step: the fixpoint
            return nxt
        d = nxt
    return d


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


def fill_maxmin(con_ptr: torch.Tensor, ent_task: torch.Tensor,
                ent_w: torch.Tensor, active: torch.Tensor, caps: torch.Tensor,
                flows: torch.Tensor, *, backend: str = "auto"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted max-min fair rates by progressive filling, every round of
    one DES event trip: the CSR incidence (con_ptr, ent_task, ent_w) and
    flows of M members on a leading member axis (M = 1 for one problem),
    active (S, N) and caps (S, C), lane s reading member s % M -> (rates
    (S, N), rounds (S,) int32).  The `repro_torch.core.des_torch` rate
    step, once per event trip."""
    if _pick(backend, active) == "cuda":
        return _waterfill.fill_maxmin(con_ptr, ent_task, ent_w, active, caps,
                                      flows)
    return _ref.fill_maxmin_ref(con_ptr, ent_task, ent_w, active, caps,
                                flows)
