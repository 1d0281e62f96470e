"""RPR005: solver results consumed without gating on the full status set.

History: the fleet loop once treated ``time_limit`` as "has a
solution": under load the MILP can hit its deadline with *no incumbent*,
returning ``status == "time_limit"`` and ``x is None``, and the extraction
crashed (or, worse, scheduled from a stale vector).  The repo convention:

* tuple-unpack form -- ``status, x, info = model.solve(...)`` must branch
  on ``x is None`` (an incumbent can be absent for *any* non-optimal
  status) before touching ``x``;
* result-object form -- ``res = solve_delta_milp(...)`` must consult
  ``res.feasible`` or ``res.status`` before reading ``res.x`` /
  ``res.schedule`` / ``res.makespan``.

The rule flags extraction sites missing those gates, in any analyzed file
(benchmarks included: a demo that crashes on a timeout is still a crash).
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.engine import (FileContext, Finding, call_name,
                                         rule, scopes, walk_scope)

# corpus functions returning a MILPResult-style object
_RESULT_FNS = {"solve_delta_milp", "solve_robust_milp", "solve_resilient"}
_RESULT_PAYLOAD = {"x", "schedule", "makespan", "assignment"}
_RESULT_GATES = {"feasible", "status", "degraded"}


def _is_none_check(node: ast.AST, var: str) -> bool:
    """`var is None` / `var is not None` anywhere inside `node`."""
    if isinstance(node, ast.Compare) and isinstance(node.left, ast.Name) \
            and node.left.id == var and len(node.ops) == 1 \
            and isinstance(node.ops[0], (ast.Is, ast.IsNot)) \
            and isinstance(node.comparators[0], ast.Constant) \
            and node.comparators[0].value is None:
        return True
    return False


@rule(
    code="RPR005",
    name="solver-status-gate",
    summary="solver result payload read without branching on the full "
            "status set (None incumbent / feasible / status)",
    bug="time_limit was treated as 'has a solution'; a deadline hit "
        "with no incumbent returned x=None and the extraction crashed",
)
def check(ctxs: list[FileContext]) -> Iterable[Finding]:
    for ctx in ctxs:
        for scope_name, scope in scopes(ctx):
            yield from _check_tuple_unpack(ctx, scope_name, scope)
            yield from _check_result_objects(ctx, scope_name, scope)


def _check_tuple_unpack(ctx: FileContext, scope_name: str,
                        scope) -> Iterable[Finding]:
    """`status, x, info = md.solve(...)` -> x needs an `is None` gate."""
    payload_vars: dict[str, int] = {}
    for node in walk_scope(scope):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if not isinstance(tgt, ast.Tuple) or len(tgt.elts) < 2:
            continue
        if not isinstance(node.value, ast.Call):
            continue
        fname = call_name(node.value.func)
        if not (fname == "solve" or fname.endswith(".solve")):
            continue
        second = tgt.elts[1]
        if isinstance(second, ast.Name) and second.id != "_":
            payload_vars[second.id] = node.lineno
    if not payload_vars:
        return
    guarded: set[str] = set()
    for node in walk_scope(scope):
        for var in payload_vars:
            if _is_none_check(node, var):
                guarded.add(var)
    for var, assign_line in payload_vars.items():
        if var in guarded:
            continue
        use_line = _first_use(scope, var, after=assign_line)
        if use_line is None:
            continue
        yield Finding(
            rule="RPR005", path=ctx.path, line=use_line,
            message=f"`{var}` unpacked from a .solve() call is used "
                    f"without an `is None` gate: any non-optimal status "
                    f"(time_limit included) can carry no incumbent (the "
                    f"time_limit bug); branch on `{var} is None` first",
            key=f"{scope_name}.{var}")


def _check_result_objects(ctx: FileContext, scope_name: str,
                          scope) -> Iterable[Finding]:
    """`res = solve_delta_milp(...)` -> res.x needs feasible/status gate."""
    result_vars: dict[str, int] = {}
    for node in walk_scope(scope):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if not isinstance(tgt, ast.Name) or not isinstance(node.value,
                                                           ast.Call):
            continue
        fname = call_name(node.value.func).split(".")[-1]
        if fname in _RESULT_FNS:
            result_vars[tgt.id] = node.lineno
    if not result_vars:
        return
    gated: set[str] = set()
    payload_use: dict[str, int] = {}
    for node in walk_scope(scope):
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id in result_vars:
            if node.attr in _RESULT_GATES:
                gated.add(node.value.id)
            elif node.attr in _RESULT_PAYLOAD and \
                    isinstance(node.ctx, ast.Load):
                payload_use.setdefault(node.value.id, node.lineno)
                payload_use[node.value.id] = min(
                    payload_use[node.value.id], node.lineno)
    for var, line in sorted(payload_use.items()):
        if var in gated:
            continue
        yield Finding(
            rule="RPR005", path=ctx.path, line=line,
            message=f"`{var}.x`-style payload read without consulting "
                    f"`{var}.feasible` or `{var}.status`: a time-limited "
                    f"solve can return an infeasible result object (the "
                    f"time_limit bug)",
            key=f"{scope_name}.{var}")


def _first_use(scope, var: str, after: int) -> int | None:
    best: int | None = None
    for node in walk_scope(scope):
        if isinstance(node, ast.Name) and node.id == var and \
                isinstance(node.ctx, ast.Load) and node.lineno > after \
                and (best is None or node.lineno < best):
            best = node.lineno
    return best
