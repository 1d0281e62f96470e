"""RPR002: public functions mutating caller-passed option/dataclass args.

History: `optimize()` once silently mutated the caller's
`MILPOptions` (the options object is shared across calls; a mutated
time_limit leaked into every later solve).  The repo convention since is
`dataclasses.replace(opts, ...)` for per-call overrides.

The rule flags, inside any public function or method, an attribute
assignment (or augmented assignment, or `setattr`) on a bare parameter
when the parameter is annotated with a package dataclass type or named
like an options object.  Rebinding the parameter first via
`dataclasses.replace(...)`, `copy.deepcopy(...)`, `.copy()` or a fresh
constructor makes later mutations local and is accepted;
``opts = opts or Default()`` is NOT accepted (the caller's object is still
the one being mutated whenever the caller passed one).
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.engine import (FileContext, Finding, annotation_text,
                                   call_name, is_dataclass_def, rule)

# parameter names treated as caller-owned option objects even without a
# resolvable annotation
_OPTIONS_NAMES = {"opts", "options", "config", "cfg"}

_SAFE_REBIND_CALLS = ("replace", "dataclasses.replace", "copy.deepcopy",
                      "deepcopy", "copy.copy")


# class-name suffixes marking a dataclass as an options/config object
# (entity dataclasses like Tenant are mutable state by design; the
# MILPOptions bug class is specifically about *shared configuration* objects)
_OPTIONS_SUFFIXES = ("Options", "Opts", "Config", "Params", "Settings")


def _package_dataclasses(ctxs: list[FileContext]) -> set[str]:
    out: set[str] = set()
    for ctx in ctxs:
        if not ctx.in_package:
            continue
        for node in ctx.nodes:
            if isinstance(node, ast.ClassDef) and is_dataclass_def(node) \
                    and node.name.endswith(_OPTIONS_SUFFIXES):
                out.add(node.name)
    return out


def _tracked_params(fn: ast.FunctionDef | ast.AsyncFunctionDef,
                    dataclasses_: set[str]) -> dict[str, str]:
    """param name -> why it is tracked ('annotation X' / 'name')."""
    out: dict[str, str] = {}
    args = list(fn.args.posonlyargs) + list(fn.args.args) \
        + list(fn.args.kwonlyargs)
    for a in args:
        if a.arg in ("self", "cls"):
            continue
        ann = annotation_text(a.annotation)
        ann_names = {p.strip() for p in ann.replace("|", " ")
                     .replace("[", " ").replace("]", " ")
                     .replace(",", " ").split()}
        hit = ann_names & dataclasses_
        if hit:
            out[a.arg] = f"annotated {sorted(hit)[0]}"
        elif a.arg in _OPTIONS_NAMES:
            out[a.arg] = "an options-style parameter"
    return out


def _is_safe_rebind(value: ast.AST) -> bool:
    """`x = dataclasses.replace(x, ...)` / deepcopy / fresh constructor."""
    if isinstance(value, ast.Call):
        name = call_name(value.func)
        if name in _SAFE_REBIND_CALLS or name.endswith(".copy"):
            return True
        # a fresh constructor call (Type(...)) with no argument sharing the
        # old object is a new instance; approximated by "a Call that is not
        # a BoolOp fallback" -- `opts or Default()` is handled below
        if name and name[0].isupper():
            return True
    return False


@rule(
    code="RPR002",
    name="caller-options-mutation",
    summary="public function mutates a caller-passed options/dataclass "
            "argument instead of dataclasses.replace()",
    bug="optimize() mutated the caller's MILPOptions, leaking a "
        "per-call time_limit into every later solve",
)
def check(ctxs: list[FileContext]) -> Iterable[Finding]:
    dataclasses_ = _package_dataclasses(ctxs)
    for ctx in ctxs:
        for cls_or_mod, fn in _public_functions(ctx.tree):
            tracked = _tracked_params(fn, dataclasses_)
            if not tracked:
                continue
            # parameters rebound to a fresh object before a given line
            rebound_at: dict[str, int] = {}
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    tgt = node.targets[0].id
                    if tgt in tracked and _is_safe_rebind(node.value):
                        rebound_at.setdefault(tgt, node.lineno)
            for node in ast.walk(fn):
                pname, line = _mutation_of(node, tracked)
                if pname is None:
                    continue
                if pname in rebound_at and rebound_at[pname] < line:
                    continue
                qual = f"{cls_or_mod}.{fn.name}" if cls_or_mod else fn.name
                yield Finding(
                    rule="RPR002", path=ctx.path, line=line,
                    message=f"public function `{qual}` mutates caller-"
                            f"passed `{pname}` ({tracked[pname]}); use "
                            f"dataclasses.replace() on a local copy -- "
                            f"mutating shared options leaks state across "
                            f"calls (the MILPOptions bug)",
                    key=f"{qual}.{pname}")


def _public_functions(tree: ast.Module):
    """Yield (enclosing-class-name-or-'', fn) for public defs."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                yield "", node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if not sub.name.startswith("_"):
                        yield node.name, sub


def _mutation_of(node: ast.AST, tracked: dict[str, str]
                 ) -> tuple[str | None, int]:
    """Return (param, line) when `node` writes an attribute of a tracked
    bare parameter."""
    target = None
    if isinstance(node, ast.Assign):
        for t in node.targets:
            if isinstance(t, ast.Attribute):
                target = t
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and \
            isinstance(node.target, ast.Attribute):
        target = node.target
    elif isinstance(node, ast.Call) and call_name(node.func) == "setattr" \
            and node.args and isinstance(node.args[0], ast.Name) and \
            node.args[0].id in tracked:
        return node.args[0].id, node.lineno
    if target is not None and isinstance(target.value, ast.Name) and \
            target.value.id in tracked:
        return target.value.id, node.lineno
    return None, 0
