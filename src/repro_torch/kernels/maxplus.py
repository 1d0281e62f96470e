"""Hopper kernel for the tropical (max, +) matrix product (CUDA C++, sm_90a).

`maxplus(a, b)` computes ``out[i, j] = max_k a[i, k] + b[k, j]`` in
float32, clamped at ``NEG_INF`` (the finite "no path"), for a (M, K) and b
(K, N).  It replaces the Pallas kernel `repro/kernels/maxplus.py:40
maxplus`; the source, with what bounds it on the card, is
`csrc/maxplus.cu`: a pipelined CUDA-core product whose (tile, k-chunk)
work units are spread evenly over a persistent grid (stream-K), the
partial maxima of split tiles combined by a second small kernel,
bit-identical to the plain version.

`plan` is the host side of that schedule (tile counts, units, grid,
workspace); `repro_torch.kernels.ref.maxplus_split_ref` replays it in
plain torch, so the CPU tests hold the split to the plain product.

The kernel is built with ``nvcc`` at first use from that source alone and
loaded with ``ctypes`` (`repro_torch.kernels._build`).  This module
launches the kernel and nothing else: the plain version lives in
`repro_torch.kernels.ref`, and the choice between the two is
`repro_torch.kernels.ops`'s.

`launches` counts the wrapper's calls that launch (one per product, the
product and its combine together), so a run can show that its path went
through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

launches = 0

# the tiling of csrc/maxplus.cu (kBM, kBN, kBK)
BM, BN, BK = 128, 128, 16


class Plan(NamedTuple):
    tiles_m: int
    tiles_n: int
    kc: int            # k-chunks of BK per tile (1 when K == 0)
    units: int         # work units: tiles x kc, numbered tile by tile
    blocks: int        # the persistent grid
    max_seg: int       # most tiles one block's range of units touches


def unit_start(g: int, units: int, blocks: int) -> int:
    """The first work unit of block g: block g owns [g U / G, (g+1) U / G)."""
    return g * units // blocks


@functools.lru_cache(maxsize=None)
def plan(m: int, k: int, n: int, sms: int) -> Plan:
    """The schedule of one (m, k) x (k, n) product on a card with `sms`
    SMs: one block per SM (the source's __launch_bounds__(256, 1)), never
    more blocks than units.
    Raises when the units do not fit the kernel's 32-bit count."""
    tiles_m, tiles_n = -(-m // BM), -(-n // BN)
    kc = max(1, -(-k // BK))
    units = tiles_m * tiles_n * kc
    if units >= 2 ** 31:
        raise ValueError(f"maxplus kernel: {units} work units for "
                         f"({m}, {k}) x ({k}, {n}), more than 2^31 - 1")
    blocks = max(1, min(units, sms))
    longest = -(-units // blocks)           # units in the longest range
    # a range of L units starting at the last chunk of a tile touches
    # 1 + ceil((L - 1) / kc) tiles
    max_seg = 1 + -(-(longest - 1) // kc)
    return Plan(tiles_m, tiles_n, kc, units, blocks, max_seg)


def _kernel():
    return _build.function(
        "maxplus", "maxplus",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def _check(name: str, t: torch.Tensor, device: torch.device) -> None:
    if not t.is_cuda:
        raise ValueError(f"maxplus kernel: {name} is on {t.device}, not a "
                         f"CUDA device")
    if t.device != device:
        raise ValueError(f"maxplus kernel: {name} is on {t.device}, a on "
                         f"{device}")
    if t.dtype != torch.float32:
        raise ValueError(f"maxplus kernel: {name} is {t.dtype}, needs "
                         f"torch.float32")
    if t.dim() != 2:
        raise ValueError(f"maxplus kernel: {name} must be a matrix, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"maxplus kernel: {name} must be contiguous")


def maxplus(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Max-plus product of a (M, K) and b (K, N) -> (M, N), float32, on
    the kernel.  Raises on anything the kernel does not take; launches on
    the current stream and does not synchronise."""
    global launches
    _check("a", a, a.device)
    _check("b", b, a.device)
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"maxplus kernel: a has K={k}, b K={k2}")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if out.numel():
        p = plan(m, k, n, _build.sm_count(a.device.index))
        ws = torch.empty((p.blocks * p.max_seg, BM * BN),
                         dtype=torch.float32, device=a.device)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = _kernel()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                            ws.data_ptr(), m, k, n, p.blocks, p.max_seg,
                            stream)
        if err != 0:
            raise RuntimeError(f"maxplus kernel launch failed: "
                               f"cudaError {err}")
        launches += 1
    return out
