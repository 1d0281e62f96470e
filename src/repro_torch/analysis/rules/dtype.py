"""RPR003/RPR004: dtype hazards on the host/device seam of hot paths.

History: the reference once built the DES capacity buffers as
float64 on the host and silently downcast at the jit boundary, which
made long-horizon makespans drift by whole timesteps.  The port runs
float32 end to end and is held to the reference at float32 tolerances;
its seam has the same two failure modes, scoped to the hot modules (the
torch DES, the kernel layer and `convert.py`, see `engine.is_hot`):

* RPR003 -- float64 on the device: ``torch.float64`` / ``torch.double``
  (``.to(torch.float64)`` included), a ``"float64"`` dtype string, or a
  ``.double()`` call in a hot module, and the type ``double`` in the
  code of a CUDA source under the hot package's ``kernels/csrc/``
  (comments and string literals are not code).  A float64 tensor runs
  at a fraction of the card's float32 rate and the kernels take float32
  pointers: at best it is slow, at worst a silent reinterpretation.

* RPR004 -- a bare host-side ``np.*`` array construction whose default
  dtype is float64 (``np.zeros``/``ones``/``full``/``empty``/
  ``linspace``, or ``np.array``/``asarray`` over float payloads) with no
  explicit ``dtype=``, and ``torch.tensor``/``torch.as_tensor`` with no
  ``dtype=`` (a float64 array stays float64 on the device).  Chained
  ``.astype(...)`` or ``.to(<dtype>)`` makes the intent explicit and is
  accepted.
"""
from __future__ import annotations

import ast
import glob
import os
import re
from typing import Iterable

from repro_torch.analysis.engine import (FileContext, Finding, call_name,
                                         is_hot, rule)

_F64_DEFAULT_CTORS = {"zeros", "ones", "full", "empty", "linspace",
                      "zeros_like", "ones_like", "full_like", "empty_like",
                      "eye", "identity"}
_ARRAY_CTORS = {"array", "asarray", "ascontiguousarray"}
_TORCH_CTORS = {"torch.tensor", "torch.as_tensor"}
_F64_ATTRS = {"torch.float64", "torch.double"}
_F64_STRINGS = {"float64", "double", "f8"}

# C/C++ comments and string/char literals, removed before the token scan
_CU_NON_CODE = re.compile(
    r'//[^\n]*|/\*.*?\*/|"(?:\\.|[^"\\\n])*"|\'(?:\\.|[^\'\\\n])*\'',
    re.S)
_CU_DOUBLE = re.compile(r"\bdouble\b")


def _dtype_kw(node: ast.Call) -> ast.expr | None:
    for kw in node.keywords:
        if kw.arg == "dtype":
            return kw.value
    return None


def _float64_uses(ctx: FileContext) -> Iterable[tuple[ast.AST, str]]:
    """(node, token) for every float64 request in a module."""
    for node in ctx.nodes:
        if isinstance(node, ast.Attribute) and \
                call_name(node) in _F64_ATTRS:
            yield node, call_name(node)
        elif isinstance(node, ast.Constant) and \
                isinstance(node.value, str) and \
                node.value in _F64_STRINGS:
            yield node, repr(node.value)
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "double" and not node.args:
            yield node, ".double()"


def _cu_sources(ctxs: list[FileContext]) -> dict[str, str]:
    """display path -> absolute path of every `.cu` beside a hot kernel
    package (`<...>/kernels/csrc/*.cu`)."""
    out: dict[str, str] = {}
    for ctx in ctxs:
        if not ctx.abspath or "/kernels/" not in "/" + ctx.path:
            continue
        here = os.path.dirname(ctx.abspath)
        if os.path.basename(here) != "kernels":
            continue
        for cu in sorted(glob.glob(os.path.join(here, "csrc", "*.cu"))):
            disp = f"{os.path.dirname(ctx.path)}/csrc/{os.path.basename(cu)}"
            out[disp.lstrip("/")] = cu
    return out


def _cu_doubles(source: str) -> Iterable[tuple[int, str]]:
    """(line, code of that line) for each `double` in the code."""
    code = _CU_NON_CODE.sub(
        lambda m: re.sub(r"[^\n]", " ", m.group(0)), source)
    for m in _CU_DOUBLE.finditer(code):
        line = code.count("\n", 0, m.start()) + 1
        yield line, " ".join(code.splitlines()[line - 1].split())


@rule(
    code="RPR003",
    name="float64-on-device",
    summary="float64 requested in a hot module (torch.float64/double, "
            "'float64', .double()) or `double` in a hot CUDA source",
    bug="the reference's DES buffers requested float64 across the device "
        "seam and makespans drifted; the port's seam is float32 end to "
        "end and its kernels take float32 pointers",
)
def check_rpr003(ctxs: list[FileContext]) -> Iterable[Finding]:
    for ctx in ctxs:
        if not is_hot(ctx):
            continue
        for node, token in _float64_uses(ctx):
            yield Finding(
                rule="RPR003", path=ctx.path, line=node.lineno,
                message=f"`{token}` in a hot module: the device seam runs "
                        f"float32 (the kernels take float32 pointers and "
                        f"the card's float64 rate is a fraction of its "
                        f"float32 rate); use torch.float32",
                key=f"{token}:{_nearest_scope(ctx.tree, node)}")
    for disp, path in _cu_sources(ctxs).items():
        with open(path, encoding="utf-8") as f:
            source = f.read()
        for line, code in _cu_doubles(source):
            yield Finding(
                rule="RPR003", path=disp, line=line,
                message="`double` in a hot CUDA source: the port's "
                        "kernels compute in float32 (use float)",
                key=f"double:{code}")


def _explicit_cast(ctx: FileContext) -> set[ast.Call]:
    """Calls immediately chained into `.astype(...)` or `.to(<dtype>)`."""
    wrapped: set[ast.Call] = set()
    for node in ctx.nodes:
        if not isinstance(node, ast.Call) or \
                not isinstance(node.func, ast.Attribute) or \
                not isinstance(node.func.value, ast.Call):
            continue
        attr = node.func.attr
        if attr == "astype" or (attr == "to" and (
                _dtype_kw(node) is not None or
                any(call_name(a).startswith("torch.") for a in node.args))):
            wrapped.add(node.func.value)
    return wrapped


def _has_float_payload(node: ast.Call) -> bool:
    """True when an np.array/asarray argument visibly carries floats."""
    for arg in node.args[:1]:
        for sub in ast.walk(arg):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, float):
                return True
            if isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Div):
                return True
    return False


@rule(
    code="RPR004",
    name="bare-host-array-hot-path",
    summary="np.* array construction with float64 default dtype, or "
            "torch.tensor/as_tensor, with no explicit dtype= in a hot "
            "module (host/device dtype seam)",
    bug="the reference's host-side float64 staging arrays crossed the "
        "device boundary as float32 while host consumers stayed float64; "
        "torch.as_tensor of such an array stays float64 on the card",
)
def check_rpr004(ctxs: list[FileContext]) -> Iterable[Finding]:
    for ctx in ctxs:
        if not is_hot(ctx):
            continue
        wrapped = _explicit_cast(ctx)
        for node in ctx.nodes:
            if not isinstance(node, ast.Call) or node in wrapped or \
                    _dtype_kw(node) is not None:
                continue
            name = call_name(node.func)
            tail = name.split(".")[-1]
            if name in _TORCH_CTORS:
                why = "keeps a float64 source's dtype on the device"
            elif name.startswith(("np.", "numpy.")) and (
                    tail in _F64_DEFAULT_CTORS or
                    (tail in _ARRAY_CTORS and _has_float_payload(node))):
                why = "defaults to float64 on the host"
            else:
                continue
            yield Finding(
                rule="RPR004", path=ctx.path, line=node.lineno,
                message=f"`{name}(...)` {why} but the device side of this "
                        f"module runs float32 (the float64 seam); pass an "
                        f"explicit dtype= or chain .astype(...)/.to(dtype)",
                key=f"{name}:{_nearest_scope(ctx.tree, node)}")


def _nearest_scope(tree: ast.Module, target: ast.AST) -> str:
    """Enclosing function/class name for a stable, line-free key."""
    best = "<module>"
    tline = getattr(target, "lineno", 0)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            end = getattr(node, "end_lineno", node.lineno)
            if node.lineno <= tline <= end:
                best = node.name
    return best
