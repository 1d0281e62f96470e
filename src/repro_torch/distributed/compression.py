"""Gradient compression: int8 ring all-reduce with error feedback (the
reference's `repro.distributed.compression`).

`ring_allreduce_int8` is a ring reduce-scatter + all-gather over
`torch.distributed` point-to-point ops whose every hop carries int8
payloads -- 4x less wire traffic than bf16/fp32 all-reduce, which
directly shrinks the DP volumes DELTA provisions circuits for.  Each hop
is one `batch_isend_irecv` to the next rank and from the previous one
(the reference's `lax.ppermute` with perm [(i, i + 1 mod n)]).  All hops
share one conservative global scale (max |x| over the ranks, times
n / 127) so partial sums never clip; the per-rank quantization residual
is returned for error feedback (re-injected into the next step's
gradients).  Chunk order, accumulation order, rounding (half to even)
and the scale's float32 arithmetic are the reference's.

Call it on every rank of `group` (default: the world), on the device its
backend takes: NCCL on CUDA tensors, gloo on CPU tensors.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist
import torch.nn.functional as F


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _ppermute(buf: torch.Tensor, group, me: int, n: int) -> torch.Tensor:
    """Send `buf` to the next rank of the ring and receive the previous
    rank's: one batch_isend_irecv."""
    def peer(r: int) -> int:
        return r if group is None else dist.get_global_rank(group, r)

    recv = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf, peer((me + 1) % n), group),
           dist.P2POp(dist.irecv, recv, peer((me - 1) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def ring_allreduce_int8(x: torch.Tensor, group=None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """All-reduce(sum) of a flat f32 vector with int8 ring hops.

    Returns (sum, residual): `sum` is identical on every rank up to int8
    quantization; `residual` is this rank's local quantization error
    (x - dequant(quant(x))) for error feedback.
    """
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    if n == 1:
        return x, torch.zeros_like(x)
    size = x.shape[0]
    pad = (-size) % n
    xp = F.pad(x.to(torch.float32), (0, pad))
    chunks = xp.reshape(n, -1)
    # conservative shared scale: any partial sum of n int8 payloads fits
    amax = torch.max(torch.abs(xp))
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = amax * n / 127.0 + 1e-20
    residual = xp - _dequantize(_quantize(xp, scale), scale)

    # reduce-scatter: at step s rank r sends its partial sum of chunk
    # (r - s) and accumulates the received chunk (r - s - 1); after n-1
    # hops rank r owns the complete sum of chunk (r + 1) % n.
    acc = chunks.clone()
    for step in range(n - 1):
        send_idx = (me - step) % n
        recv_idx = (me - step - 1) % n
        recv = _ppermute(_quantize(acc[send_idx], scale), group, me, n)
        acc[recv_idx] = acc[recv_idx] + _dequantize(recv, scale)
    own = (me + 1) % n
    out = torch.zeros_like(chunks)
    out[own] = _dequantize(_quantize(acc[own], scale), scale)

    # all-gather the reduced chunks around the ring (int8 payloads)
    buf = _quantize(acc[own], scale)
    for step in range(n - 1):
        recv = _ppermute(buf, group, me, n)
        out[(me - step) % n] = _dequantize(recv, scale)
        buf = recv
    total = out.reshape(-1)[:size]
    return total, residual.reshape(-1)[:size]


def mean_grads_int8(grads: Mapping[str, torch.Tensor], group=None,
                    residual: Mapping[str, torch.Tensor] | None = None
                    ) -> tuple[dict, dict]:
    """The DP gradient mean of every tensor of `grads` over the ranks of
    `group` via the int8 ring, with error feedback.  residual: float32
    tensors keyed like grads (None on the first step).  Returns (means in
    each gradient's dtype, the new residuals)."""
    n = dist.get_world_size(group)
    means, res = {}, {}
    for name, g in grads.items():
        v = g.to(torch.float32).reshape(-1)
        r = None if residual is None else residual.get(name)
        if r is not None:
            v = v + r.reshape(-1)
        total, rr = ring_allreduce_int8(v, group)
        means[name] = (total / n).reshape(g.shape).to(g.dtype)
        res[name] = rr.reshape(g.shape)
    return means, res
