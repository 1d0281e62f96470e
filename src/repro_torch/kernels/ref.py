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

from repro_torch.kernels import maxplus as _maxplus
from repro_torch.kernels import tclosure as _tclosure

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
        if bool((nxt == a).all()):  # sentinel: ignore[RPR006] one per squaring step: the fixpoint
            return nxt
        a = nxt
    return a


def tclosure_packed_ref(a: torch.Tensor) -> torch.Tensor:
    """`tclosure_step_ref` the way the kernel computes it: each row packed
    into `ws` words (`tclosure.word_stride`: ceil(n / 32) rounded up to a
    multiple of 4, padding bits zero), then for every set bit k of row i
    the packed row k ORed into row i, then A's own words ORed in and the
    words unpacked to the first n columns only.  Plain torch at the
    kernel's word stride, for the CPU tests; nothing on the card's path
    calls it."""
    a = a != 0
    n = a.shape[0]
    ws = _tclosure.word_stride(n)
    cols = torch.zeros((n, 32 * ws), dtype=torch.int64, device=a.device)
    cols[:, :n] = a.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=a.device)
    words = (cols.view(n, ws, 32) << shifts).sum(-1)        # (n, ws)
    acc = words.clone()
    for k in range(n):                 # walk the set bits, word by word
        hit = (words[:, k // 32] >> (k % 32)) & 1
        acc |= torch.where(hit[:, None] == 1, words[k], 0)
    bits = (acc[:, :, None] >> shifts) & 1                  # (n, ws, 32)
    return bits.reshape(n, 32 * ws)[:, :n] == 1


def maxplus_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Tropical (max, +) matrix product: out[i,j] = max_k a[i,k] + b[k,j].

    Entries <= NEG_INF are treated as 'no edge'.
    """
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    return (a[:, :, None] + b[None]).amax(1).clamp_min(NEG_INF)


def maxplus_split_ref(a: torch.Tensor, b: torch.Tensor,
                      plan: _maxplus.Plan) -> torch.Tensor:
    """`maxplus_ref` the way the kernel computes it under `plan`
    (`maxplus.plan`): a and b padded with NEG_INF to whole tiles and
    k-chunks, block g's range of work units cut into one partial maximum
    per tile it touches (each from NEG_INF), and each entry the maximum of
    the partials that its tile's blocks wrote.  Plain torch, for the CPU
    tests; nothing on the card's path calls it."""
    bm, bn, bk = _maxplus.BM, _maxplus.BN, _maxplus.BK
    (m, k), n = a.shape, b.shape[1]
    kc, tiles_n = plan.kc, plan.tiles_n
    ap = torch.full((plan.tiles_m * bm, kc * bk), NEG_INF,
                    dtype=torch.float32)
    ap[:m, :k] = a
    bp = torch.full((kc * bk, tiles_n * bn), NEG_INF, dtype=torch.float32)
    bp[:k, :n] = b
    # unwritten slots stay NaN, which torch.maximum would carry to the end
    ws = torch.full((plan.blocks, plan.max_seg, bm, bn), math.nan)
    for g in range(plan.blocks):
        u = u0 = _maxplus.unit_start(g, plan.units, plan.blocks)
        u1 = _maxplus.unit_start(g + 1, plan.units, plan.blocks)
        while u < u1:
            t = u // kc
            end = min(u1, (t + 1) * kc)
            tm, tn = divmod(t, tiles_n)
            at = ap[tm * bm:(tm + 1) * bm, (u % kc) * bk:(end - t * kc) * bk]
            bt = bp[(u % kc) * bk:(end - t * kc) * bk, tn * bn:(tn + 1) * bn]
            ws[g, t - u0 // kc] = (at[:, :, None] + bt[None]).amax(1) \
                .clamp_min(NEG_INF)
            u = end
    out = torch.full((plan.tiles_m * bm, tiles_n * bn), NEG_INF)
    for t in range(plan.tiles_m * tiles_n):
        tm, tn = divmod(t, tiles_n)
        first = t * kc      # the blocks owning units first .. first + kc - 1
        g0 = ((first + 1) * plan.blocks - 1) // plan.units
        g1 = ((first + kc) * plan.blocks - 1) // plan.units
        tile = out[tm * bm:(tm + 1) * bm, tn * bn:(tn + 1) * bn]
        for g in range(g0, g1 + 1):
            seg = t - _maxplus.unit_start(g, plan.units, plan.blocks) // kc
            tile.copy_(torch.maximum(tile, ws[g, seg]))
    return out[:m, :n].to(a.device)


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


def _lanes(s: int, m: int) -> int:
    """The genomes of S lanes over M members (lane s reads member s % M)."""
    if m < 1 or s % m:
        raise ValueError(f"{s} lanes are not a multiple of {m} members")
    return s // m


def csr_con_id(con_ptr: torch.Tensor) -> torch.Tensor:
    """The constraint of each CSR entry, int64: (M, E) for M members'
    con_ptr (M, C+1)."""
    c = con_ptr.shape[1] - 1
    ids = torch.arange(c, device=con_ptr.device)
    return torch.stack([torch.repeat_interleave(ids, (p[1:] - p[:-1]).long())
                        for p in con_ptr])


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
    result is the kernel's to the bit.  The incidence is M members',
    (M, C+1), (M, E), (M, E).  Returns ``reduce(level, unfrozen)`` for
    (S, N) float32 operands, S a multiple of M, lane s reading member
    s % M."""
    (m, c1), dev = con_ptr.shape, con_ptr.device
    c = c1 - 1
    counts = (con_ptr[:, 1:] - con_ptr[:, :-1]).long()          # (M, C)
    steps = max(1, -(-int(counts.max()) // WARP)) if c else 1
    k = torch.arange(steps * WARP, device=dev)
    valid = k < counts[..., None]                               # (M, C, K)
    ent = torch.where(valid, con_ptr[:, :-1].long()[..., None] + k, 0)
    # an empty incidence gathers from one zero entry, masked out
    pad = torch.zeros((m, 1), dtype=torch.float32, device=dev)
    w = torch.cat([ent_w.to(torch.float32), pad], 1).gather(
        1, ent.view(m, -1))                                     # (M, C*K)
    task = torch.cat([ent_task.long(), pad.long()], 1).gather(
        1, ent.view(m, -1))
    ok = valid.view(m, c, steps, WARP)

    def one(x: torch.Tensor) -> torch.Tensor:
        pop = _lanes(x.shape[0], m)
        xs = torch.gather(x.view(pop, m, -1), 2, task.expand(pop, m, -1))
        prod = (w * xs).view(pop, m, c, steps, WARP)
        acc = torch.zeros((pop, m, c, WARP), dtype=torch.float32,
                          device=x.device)
        for j in range(steps):
            acc = torch.where(ok[:, :, j], acc + prod[:, :, :, j], acc)
        for off in (16, 8, 4, 2, 1):
            acc = torch.cat([acc[..., :off] + acc[..., off:2 * off],
                             acc[..., off:]], -1)
        return acc[..., 0].reshape(pop * m, c)

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
    through which a saturated constraint freezes its tasks, and ``flows``
    the tasks' flow counts, (M, E), (M, E) and (M, N) for M members, lane
    s reading member s % M.  A lane
    whose unfrozen set is empty has stopped: every update is masked with
    `unfrozen`, so it stays as it was while the other lanes go on.
    Returns ``rates = flows * phi * active`` (S, N) and the rounds each
    lane ran (S,) int32; the host reads one flag per round."""
    S, n, C = active.shape[0], active.shape[1], caps.shape[1]
    m = con_id.shape[0]
    pop = _lanes(S, m)
    f32 = torch.float32
    active_f = active.to(f32)
    phi = torch.zeros((S, n), dtype=f32, device=active.device)
    unfrozen = active.clone()
    rounds = torch.zeros(S, dtype=torch.int32, device=active.device)
    con_id_x = con_id.expand(pop, m, -1)
    con_task_x = con_task.expand(pop, m, -1)
    for _ in range(C + 1):
        lanes_on = unfrozen.any(1)
        if not bool(lanes_on.any()):  # sentinel: ignore[RPR006] one sync per round: the exit test
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
        hits = torch.zeros((pop, m, n), dtype=f32, device=active.device)
        hits.scatter_add_(2, con_task_x, torch.gather(
            sat.view(pop, m, C), 2, con_id_x).to(f32))
        unfrozen = unfrozen & (hits.view(S, n) == 0)
    rates = flows * phi.view(pop, m, n) * active_f.view(pop, m, n)
    return rates.view(S, n), rounds


def fill_maxmin_ref(con_ptr: torch.Tensor, ent_task: torch.Tensor,
                    ent_w: torch.Tensor, active: torch.Tensor,
                    caps: torch.Tensor, flows: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted max-min fair rates by progressive filling for the CSR
    incidence, one host-driven round at a time with `csr_warp_sums` for
    each round's reduction, so every value is the fused kernel's to the
    bit.  M members' con_ptr (M, C+1), ent_task (M, E), ent_w (M, E) and
    flows (M, N) (M = 1 for one problem); active (S, N) bool and caps
    (S, C), S a multiple of M, lane s reading member s % M -> (rates
    (S, N), rounds (S,) int32)."""
    return progressive_filling(
        csr_warp_sums(con_ptr, ent_task, ent_w), csr_con_id(con_ptr),
        ent_task.long(), active, caps, flows)
