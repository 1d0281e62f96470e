"""RPR001: dataclass/NamedTuple fields written or plumbed but never read.

History: `JobSpec.ep` was once added, plumbed through `make_job` and the
placement constructors, and then never *read* -- every Table-I MoE
workload silently built a DP-only DAG, losing 24-42% of its traffic and
invalidating the headline comparison.  A field nobody reads is either dead
weight or, much worse, a feature that silently fell off the data path.

Detection is package-wide and name-based: a field of a dataclass /
NamedTuple defined under ``repro_torch`` counts as *read* when any analyzed file
loads an attribute of that name (``obj.field``), names it in a literal
``getattr(obj, "field")``, or the defining class maps it dynamically via a
``getattr(x, f) for f in ...`` sweep over its own fields.  Constructor
keywords, ``dataclasses.replace(...)`` keywords and assignments are writes
("plumbing"), not reads.  Name-matching is deliberately generous -- a
shared name anywhere counts -- so every finding is high-signal.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.engine import (FileContext, Finding, class_fields,
                                   call_name, is_dataclass_def,
                                   is_namedtuple_def, rule)


def _defining_contexts(ctxs: list[FileContext]) -> list[FileContext]:
    """Field definitions are only collected from package modules (module
    name derived from an `src/` layout): a helper dataclass in a test or
    benchmark is not production API."""
    return [c for c in ctxs if c.in_package]


def _read_names(ctxs: list[FileContext]) -> set[str]:
    """Every attribute name the corpus loads, plus literal getattr names."""
    reads: set[str] = set()
    for ctx in ctxs:
        for node in ctx.nodes:
            if isinstance(node, ast.Attribute) and \
                    isinstance(node.ctx, ast.Load):
                reads.add(node.attr)
            elif isinstance(node, ast.Call) and \
                    call_name(node.func) in ("getattr", "hasattr") and \
                    len(node.args) >= 2 and \
                    isinstance(node.args[1], ast.Constant) and \
                    isinstance(node.args[1].value, str):
                reads.add(node.args[1].value)
    return reads


def _dynamic_sweep_classes(ctxs: list[FileContext]) -> set[str]:
    """Class names whose fields are consumed via `_fields`/`asdict`-style
    dynamic sweeps anywhere (e.g. `getattr(self.arrays, f) for f in
    _ARRAY_FIELDS`): their fields cannot be tracked by name, skip them."""
    dynamic: set[str] = set()
    for ctx in ctxs:
        for node in ctx.nodes:
            if isinstance(node, ast.Attribute) and node.attr in (
                    "_fields", "__dataclass_fields__"):
                base = call_name(node.value)
                if base:
                    dynamic.add(base.split(".")[-1])
            elif isinstance(node, ast.Call) and call_name(node.func) in (
                    "dataclasses.asdict", "asdict", "dataclasses.astuple",
                    "astuple", "vars"):
                for arg in node.args:
                    base = call_name(arg)
                    if base:
                        dynamic.add(base.split(".")[-1])
    return dynamic


@rule(
    code="RPR001",
    name="unread-field",
    summary="dataclass/NamedTuple field is never read anywhere in the "
            "analyzed tree (attribute load or literal getattr)",
    bug="JobSpec.ep was plumbed but never read, so Table-I MoE "
        "workloads silently lost their 24-42% EP traffic",
)
def check(ctxs: list[FileContext]) -> Iterable[Finding]:
    reads = _read_names(ctxs)
    dynamic = _dynamic_sweep_classes(ctxs)
    for ctx in _defining_contexts(ctxs):
        for node in ctx.nodes:
            if not isinstance(node, ast.ClassDef):
                continue
            if not (is_dataclass_def(node) or is_namedtuple_def(node)):
                continue
            # `getattr(instance, f) for f in CLASS._fields` sweeps make
            # name-tracking blind; `cls(**mapping)` round-trips do not
            # (those are writes)
            if node.name in dynamic:
                continue
            for fname, fnode in class_fields(node):
                if fname in reads:
                    continue
                yield Finding(
                    rule="RPR001", path=ctx.path, line=fnode.lineno,
                    message=f"field `{node.name}.{fname}` is never read "
                            f"anywhere in the analyzed tree -- plumbed-but-"
                            f"unread fields silently drop features (the "
                            f"JobSpec.ep bug); read it, remove it, or "
                            f"suppress with a justification",
                    key=f"{node.name}.{fname}")
