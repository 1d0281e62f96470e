"""Hopper kernel for the fused water-filling matvec (CUDA C++, sm_90a).

`fill_matvec(w, rhs)` computes ``w @ rhs`` for a constraint-task incidence
matrix ``w`` (C, N) shared by every lane of a batch of right-hand sides
(N, R) or (B, N, R).  `fill_round` is the DES layout of the same kernel:
one progressive-filling round's per-constraint ``(used, denom)`` from the
lanes' ``level`` and ``unfrozen`` vectors.  It replaces the Pallas kernel
`repro/kernels/waterfill.py:47 fill_matvec`; the source, with what bounds
it on the card, is `csrc/waterfill.cu`.

The kernel is built with ``nvcc`` at first use from that source alone,
into ``build/kernels/`` at the repository root (listed in ``.gitignore``),
and loaded with ``ctypes``.  This module launches the kernel and nothing
else: the plain version lives in `repro_torch.kernels.ref`, and the choice
between the two is `repro_torch.kernels.ops`'s.

`launches` counts the kernel's launches, so a run can show that its main
path went through the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

launches = 0

_SRC = Path(__file__).resolve().parent / "csrc" / "waterfill.cu"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build waterfill.cu")
    return str(path)


def build() -> Path:
    """Compile `csrc/waterfill.cu` into a shared library named by the
    source's hash (a rebuilt source never loads a stale library) and
    return its path.  Idempotent; the compiler's output is raised on
    failure."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    lib = _BUILD_DIR / f"waterfill-{digest}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.waterfill_fill_matvec
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, device: torch.device) -> None:
    if not t.is_cuda:
        raise ValueError(f"waterfill kernel: {name} is on {t.device}, "
                         f"not a CUDA device")
    if t.device != device:
        raise ValueError(f"waterfill kernel: {name} is on {t.device}, "
                         f"w on {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"waterfill kernel: {name} is {t.dtype}, "
                         f"needs torch.float32")
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
            err = _library().waterfill_fill_matvec(
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
