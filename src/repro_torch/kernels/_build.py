"""The nvcc build and ``ctypes`` load that every Hopper kernel shares.

Each kernel is one source, ``csrc/<name>.cu``, with a plain C interface.
It is compiled for ``sm_90a`` at first use, from that source alone, into a
shared library under ``build/kernels/`` at the repository root (listed in
``.gitignore``), named by the source's hash so that a changed source never
loads a stale library; the compiler's report (``-Xptxas -v``: registers,
shared memory, spills) is kept beside it as ``<library>.log``.  `build`
compiles several sources at once, one ``nvcc`` process each, all started
together.  Nothing here runs when the module is imported: the CPU tests
import every module of the port.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build the kernels")
    return str(path)


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` is built: named by the source's hash."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(*names: str) -> list[Path]:
    """Compile `csrc/<name>.cu` for each name that has no library yet, one
    nvcc process each, all started together, and return the libraries'
    paths.  Idempotent; raises with the compiler's output when any source
    fails to build."""
    libs = [library_path(name) for name in names]
    todo = [(name, lib) for name, lib in zip(names, libs) if not lib.exists()]
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _nvcc(), []
    for name, lib in todo:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((cmd, tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for cmd, tmp, lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}")
        else:
            lib.with_suffix(".log").write_text(out)
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def function(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C function `symbol` of `csrc/<name>.cu`, built and loaded on
    first use.  Every pointer and the stream are ``c_void_p`` (a plain int
    would be cut to 32 bits); it returns the launch's cudaError_t."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(ctypes.CDLL(str(build(name)[0])), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name, symbol] = fn
    return fn


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The SMs of CUDA device `device_index`, which the kernels' persistent
    grids are sized by (asked of the driver once)."""
    import torch
    return torch.cuda.get_device_properties(device_index).multi_processor_count
