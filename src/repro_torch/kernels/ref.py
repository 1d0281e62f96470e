"""Plain-torch versions of the port's kernels.

They define the semantics (`repro.kernels.ref` is their JAX counterpart):
the CPU tests run them, `repro_torch.kernels.ops` takes them for tensors
on the CPU, and `chip_smoke.py` holds each Hopper kernel against them on
the card.  The water-filling pair accepts a leading batch axis on its
per-lane operands.
"""
from __future__ import annotations

import math
from collections.abc import Callable

import torch

NEG_INF = -1e30  # finite stand-in for -inf in max-plus
INF = math.inf


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


def csr_con_id(con_ptr: torch.Tensor) -> torch.Tensor:
    """The constraint of each CSR entry, int64 (E,)."""
    c = con_ptr.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(c, device=con_ptr.device),
        (con_ptr[1:] - con_ptr[:-1]).long())


WARP = 32


def csr_warp_sums(con_ptr: torch.Tensor, ent_task: torch.Tensor,
                  ent_w: torch.Tensor
                  ) -> Callable[[torch.Tensor, torch.Tensor],
                                tuple[torch.Tensor, torch.Tensor]]:
    """A filling round's per-constraint ``(used, denom)`` over the CSR
    incidence, summed in the fused kernel's order: entry k of a row goes
    to lane k % 32, each lane adds its entries' products in row order,
    and lane 0 gathers the 32 partial sums by a shuffle-down tree (16, 8,
    4, 2, 1).  Every product and sum is rounded once (no FMA), so the
    result is the kernel's to the bit.  Returns ``reduce(level,
    unfrozen)`` for (S, N) float32 operands."""
    c, dev = con_ptr.shape[0] - 1, con_ptr.device
    counts = (con_ptr[1:] - con_ptr[:-1]).long()
    steps = max(1, -(-int(counts.max()) // WARP)) if c else 1
    k = torch.arange(steps * WARP, device=dev)
    valid = k < counts[:, None]                              # (C, K)
    ent = torch.where(valid, con_ptr[:-1].long()[:, None] + k, 0)
    # an empty incidence gathers from one zero entry, masked out
    pad = torch.zeros(1, dtype=torch.float32, device=dev)
    w = torch.cat([ent_w.to(torch.float32), pad])[ent]
    task = torch.cat([ent_task.long(), pad.long()])[ent]

    def one(x: torch.Tensor) -> torch.Tensor:
        prod = (w * x[:, task]).view(x.shape[0], c, steps, WARP)
        ok = valid.view(c, steps, WARP)
        acc = torch.zeros((x.shape[0], c, WARP), dtype=torch.float32,
                          device=x.device)
        for j in range(steps):
            acc = torch.where(ok[:, j], acc + prod[:, :, j], acc)
        for off in (16, 8, 4, 2, 1):
            acc = torch.cat([acc[..., :off] + acc[..., off:2 * off],
                             acc[..., off:]], -1)
        return acc[..., 0]

    return lambda level, unfrozen: (one(level), one(unfrozen))


def progressive_filling(reduce: Callable[[torch.Tensor, torch.Tensor],
                                         tuple[torch.Tensor, torch.Tensor]],
                        con_id: torch.Tensor, con_task: torch.Tensor,
                        active: torch.Tensor, caps: torch.Tensor,
                        flows: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted max-min fair rates of an (S, N) batch of active sets under
    (S, C) capacities, one host-driven round at a time.

    ``reduce(level, unfrozen)`` gives one round's per-constraint ``(used,
    denom)`` (S, C) from ``level = phi * active`` and ``unfrozen`` as
    float32 (S, N); ``con_id``/``con_task`` are the incidence entries,
    through which a saturated constraint freezes its tasks.  A lane whose
    unfrozen set is empty has stopped: every update is masked with
    `unfrozen`, so it stays as it was while the other lanes go on.
    Returns ``rates = flows * phi * active`` (S, N) and the rounds each
    lane ran (S,) int32; the host reads one flag per round."""
    S, n, C = active.shape[0], active.shape[1], caps.shape[1]
    f32 = torch.float32
    active_f = active.to(f32)
    phi = torch.zeros((S, n), dtype=f32, device=active.device)
    unfrozen = active.clone()
    rounds = torch.zeros(S, dtype=torch.int32, device=active.device)
    for _ in range(C + 1):
        lanes_on = unfrozen.any(1)
        if not bool(lanes_on.any()):          # one host sync per round
            break
        rounds += lanes_on
        used, denom = reduce(phi * active_f, unfrozen.to(f32))
        # the reference divides by max(denom, 1e-300); in float32 that
        # clamp is 0, and where() drops the denom == 0 constraints
        alpha_c = torch.where(denom > 0, (caps - used) / denom, INF)
        alpha = alpha_c.amin(1).clamp_min(0.0)
        phi = torch.where(unfrozen, phi + alpha[:, None], phi)
        # (1 + 1e-9) rounds to 1 in float32, as in the reference
        sat = torch.isfinite(alpha_c) & (
            alpha_c <= (alpha * (1 + 1e-9) + 1e-18)[:, None])
        hits = torch.zeros((S, n), dtype=f32, device=active.device)
        hits.index_add_(1, con_task, sat[:, con_id].to(f32))
        unfrozen = unfrozen & (hits == 0)
    return flows * phi * active_f, rounds


def fill_maxmin_ref(con_ptr: torch.Tensor, ent_task: torch.Tensor,
                    ent_w: torch.Tensor, active: torch.Tensor,
                    caps: torch.Tensor, flows: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted max-min fair rates by progressive filling for the CSR
    incidence (con_ptr (C+1,), ent_task (E,), ent_w (E,)), one host-driven
    round at a time with `csr_warp_sums` for each round's reduction, so
    every value is the fused kernel's to the bit.  active (S, N) bool,
    caps (S, C), flows (N,) -> (rates (S, N), rounds (S,) int32)."""
    return progressive_filling(
        csr_warp_sums(con_ptr, ent_task, ent_w), csr_con_id(con_ptr),
        ent_task.long(), active, caps, flows)
