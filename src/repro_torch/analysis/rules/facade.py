"""RPR009: in-tree calls to the deprecated planner facades.

History: the planner API was unified by collapsing the six-way facade
sprawl (`optimize`,
`optimize_ensemble`, `optimize_failsafe`, `optimize_resilient`,
`fleet_optimize`) into the single typed entry point
``plan(PlanRequest(...))`` in ``repro_torch.core.api``.  The old names remain
as bit-identical shims so downstream callers keep working, but *in-tree*
code growing new calls to them re-forks the API surface the redesign
just unified -- every new mode would again need five signatures kept in
sync.

The rule flags calls to the facade names inside ``repro_torch.*`` modules
(``repro_torch.core.api`` itself excepted: it hosts the shims) whenever the
name is traceable to ``repro_torch.core.api`` -- a ``from
repro_torch.core.api import optimize`` binding, or an attribute call
through an alias of the module (``from repro_torch.core import api;
api.optimize(...)``).  Local
functions that merely share a facade's name are not flagged.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.engine import (FileContext, Finding, call_name,
                                         rule, scopes, walk_scope)

FACADES = {"optimize", "optimize_ensemble", "optimize_failsafe",
           "optimize_resilient", "fleet_optimize"}
API_MODULE = "repro_torch.core.api"


def _facade_bindings(ctx: FileContext) -> tuple[dict[str, str], set[str]]:
    """(local name -> facade it binds, aliases naming repro_torch.core.api)."""
    direct: dict[str, str] = {}
    mod_aliases: set[str] = set()
    for node in ctx.nodes:
        if isinstance(node, ast.ImportFrom):
            if node.module == API_MODULE:
                for a in node.names:
                    if a.name in FACADES:
                        direct[a.asname or a.name] = a.name
            elif node.module == "repro_torch.core":
                for a in node.names:
                    if a.name == "api":
                        mod_aliases.add(a.asname or "api")
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == API_MODULE:
                    mod_aliases.add(a.asname or API_MODULE)
    return direct, mod_aliases


@rule(
    code="RPR009",
    name="deprecated-facade-call",
    summary="in-tree call to a deprecated planner facade instead of "
            "plan(PlanRequest(...))",
    bug="the five optimize_*/fleet_optimize facades were collapsed "
        "into plan(); new in-tree callers of the shims re-fork the API "
        "surface the redesign unified",
)
def check(ctxs: list[FileContext]) -> Iterable[Finding]:
    for ctx in ctxs:
        if not ctx.in_package or ctx.module == API_MODULE:
            continue
        direct, mod_aliases = _facade_bindings(ctx)
        if not direct and not mod_aliases:
            continue
        for scope_name, scope in scopes(ctx):
            for node in walk_scope(scope):
                if not isinstance(node, ast.Call):
                    continue
                facade = _called_facade(node, direct, mod_aliases)
                if facade is None:
                    continue
                yield Finding(
                    rule="RPR009", path=ctx.path, line=node.lineno,
                    message=f"call to deprecated facade `{facade}`; build "
                            f"a PlanRequest and call "
                            f"`repro_torch.core.api.plan` instead",
                    key=f"{scope_name}:{facade}")


def _called_facade(node: ast.Call, direct: dict[str, str],
                   mod_aliases: set[str]) -> str | None:
    if isinstance(node.func, ast.Name):
        return direct.get(node.func.id)
    name = call_name(node.func)
    if "." not in name:
        return None
    prefix, attr = name.rsplit(".", 1)
    if attr in FACADES and prefix in mod_aliases:
        return attr
    return None
