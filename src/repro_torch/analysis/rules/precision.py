"""RPR011: float32 matmuls at reduced precision.

Every parity tolerance of the port assumes true float32 products (the
reference's kernel tests use 1e-5, its DES tests 5e-5), and the closure
kernel's plain version counts on an exact float32 product for n <= 2^24.
TF32 keeps 10 bits of mantissa: with it on, those tolerances fail on the
card only, and the failure looks like a kernel bug.  `repro_torch`
switches TF32 off at import.  The rule flags assigning ``True`` to any
``allow_tf32`` flag (``torch.backends.cuda.matmul.allow_tf32``,
``torch.backends.cudnn.allow_tf32``, or through ``setattr``) and
``torch.set_float32_matmul_precision`` with anything but ``"highest"``,
in every analyzed file.  Reading a flag, or setting it to ``False``, is
not flagged.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.engine import (FileContext, Finding, call_name,
                                         rule, scopes, walk_scope)


def _is_true(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _reduced(node: ast.AST) -> str | None:
    """What `node` switches to reduced precision, if anything."""
    if isinstance(node, (ast.Assign, ast.AnnAssign)) and \
            node.value is not None and _is_true(node.value):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            if isinstance(t, ast.Attribute) and t.attr == "allow_tf32":
                return call_name(t) or "allow_tf32"
    elif isinstance(node, ast.Call):
        name = call_name(node.func)
        if name == "setattr" and len(node.args) == 3 and \
                isinstance(node.args[1], ast.Constant) and \
                node.args[1].value == "allow_tf32" and \
                _is_true(node.args[2]):
            return "setattr(allow_tf32)"
        if name.split(".")[-1] == "set_float32_matmul_precision":
            arg = node.args[0] if node.args else next(
                (k.value for k in node.keywords), None)
            if not (isinstance(arg, ast.Constant) and arg.value == "highest"):
                return "set_float32_matmul_precision"
    return None


@rule(
    code="RPR011",
    name="reduced-precision-matmul",
    summary="allow_tf32 = True, or set_float32_matmul_precision with "
            "anything but 'highest'",
    bug="the port's parity tolerances assume true float32 products; TF32 "
        "fails them on the card only, where it looks like a kernel bug "
        "(repro_torch switches it off at import)",
)
def check(ctxs: list[FileContext]) -> Iterable[Finding]:
    for ctx in ctxs:
        for scope_name, scope in scopes(ctx):
            for node in walk_scope(scope):
                what = _reduced(node)
                if what is not None:
                    yield Finding(
                        rule="RPR011", path=ctx.path, line=node.lineno,
                        message=f"`{what}` in `{scope_name}` switches "
                                f"float32 matmuls to reduced precision "
                                f"(TF32): every parity tolerance of the "
                                f"port assumes true float32; leave TF32 "
                                f"off",
                        key=f"{scope_name}:{what}")
