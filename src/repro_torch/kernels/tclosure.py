"""Hopper kernel for one boolean transitive-closure step (CUDA C++, sm_90a).

`tclosure_step(a)` computes ``A | (A . A)`` in the OR-AND semiring for a
square 0/1 matrix ``a`` (bool, int8, int32 or float32; nonzero is set) and
returns it as bool.  It replaces the Pallas kernel
`repro/kernels/tclosure.py:41 tclosure_step`; the source, with what bounds
it on the card, is `csrc/tclosure.cu`: it packs each row into 32-bit words
(`ws` of them, a multiple of 4) and squares the packed matrix exactly, with
no atomics, on one of two paths chosen by n: `resident` when the packed
matrix fits in one block's shared memory (every block holds all of it),
`streamed` above that (slabs of it through a double-buffered ring).

`plan` is the host side of that choice (word stride, path, grid);
`repro_torch.kernels.ref.tclosure_packed_ref` squares at the same word
stride in plain torch, so the CPU tests hold the packed layout to the plain
step.

The kernel is built with ``nvcc`` at first use from that source alone and
loaded with ``ctypes`` (`repro_torch.kernels._build`).  This module
launches the kernel and nothing else: the plain version lives in
`repro_torch.kernels.ref`, and the choice between the two is
`repro_torch.kernels.ops`'s.

`launches` counts the wrapper's calls that launch (one per step, the pack
and the square together), so a run can show that its path went through the
kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

launches = 0

# element types the kernel reads, by the code its C interface takes
_DTYPES = {torch.bool: 0, torch.int8: 1, torch.int32: 2, torch.float32: 3}
MAX_SMEM_BYTES = 232448    # 227 KB: the most shared memory a block may have
CHUNK_WORDS = 2            # resident: words of a row per item (kChunkWords)
STREAM_ROWS = 8            # the streamed path's rows per block (kRows)
SLAB_BYTES = 2 * 32 * 32 * 4   # its double-buffered ring of 32 x 32 words


class Plan(NamedTuple):
    ws: int            # words per packed row: ceil(n / 32), a multiple of 4
    resident: bool     # the square's path
    blocks: int        # resident: blocks (one per SM, at most one per row)
    warps: int         # resident: warps per block
    smem: int          # dynamic shared memory of one square block, bytes


def word_stride(n: int) -> int:
    """Words per packed row: ceil(n / 32) rounded up to a multiple of 4,
    so that a row is a whole number of 16-byte chunks."""
    words = -(-n // 32)
    return 4 * -(-words // 4)


@functools.lru_cache(maxsize=None)
def plan(n: int, sms: int) -> Plan:
    """The packed layout and the square's path for an (n, n) step on a card
    with `sms` SMs.  Raises when even the streamed path's shared memory
    would exceed a block's."""
    ws = word_stride(n)
    words = -(-n // 32)
    # resident: one block per SM (at most one per row); a block's rows
    # times its rows' chunks of words are its warps' items
    blocks = min(sms, n)
    rows = -(-n // blocks)
    # the matrix, its mbarrier (16 bytes) and the block's row accumulators
    resident = 4 * n * ws + 16 + 4 * rows * ws
    if resident <= MAX_SMEM_BYTES:
        warps = min(32, rows * -(-words // CHUNK_WORDS))
        return Plan(ws, True, blocks, warps, resident)
    smem = 4 * STREAM_ROWS * ws + words
    if smem + SLAB_BYTES > MAX_SMEM_BYTES:
        raise ValueError(f"tclosure kernel: n={n} needs {smem + SLAB_BYTES}"
                         f" bytes of shared memory per block, more than "
                         f"{MAX_SMEM_BYTES}")
    return Plan(ws, False, 0, 0, smem)


def _kernel():
    return _build.function(
        "tclosure", "tclosure_step",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def tclosure_step(a: torch.Tensor) -> torch.Tensor:
    """``A | (A . A)`` as bool (n, n) for a square 0/1 matrix on the
    kernel.  Raises on anything the kernel does not take; launches on the
    current stream and does not synchronise."""
    global launches
    if not a.is_cuda:
        raise ValueError(f"tclosure kernel: a is on {a.device}, not a CUDA "
                         f"device")
    if a.dtype not in _DTYPES:
        raise ValueError(f"tclosure kernel: a is {a.dtype}, needs one of "
                         f"{sorted(map(str, _DTYPES))}")
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"tclosure kernel: needs a square matrix, got "
                         f"{tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError("tclosure kernel: a must be contiguous")
    n = a.shape[0]
    out = torch.empty((n, n), dtype=torch.bool, device=a.device)
    if n:
        p = plan(n, _build.sm_count(a.device.index))
        bits = torch.empty((n, p.ws), dtype=torch.int32, device=a.device)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = _kernel()(a.data_ptr(), _DTYPES[a.dtype], bits.data_ptr(),
                            out.data_ptr(), n, p.ws, int(p.resident),
                            p.blocks, p.warps, stream)
        if err != 0:
            raise RuntimeError(f"tclosure kernel launch failed: "
                               f"cudaError {err}")
        launches += 1
    return out
