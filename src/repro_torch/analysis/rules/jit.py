"""RPR006/RPR007: host syncs in hot loops and impurity under CUDA-graph
capture.

History: the reference moved its event loop under `jax.jit` and added
`repro.obs` tracing spans, and its Sentinel guards the two
hazards that came with them.  The port's event loop is a Python loop over
device tensors (`des_torch._LaneDES._simulate`), so the same two hazards
take a PyTorch shape:

* RPR006 -- a host sync inside the body of a ``for``/``while`` loop of a
  hot module (see `engine.is_hot`), or anywhere in a corpus function that
  such a body calls: ``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()``, ``.synchronize()``, ``bool``/``int``/``float`` of a
  tensor, or ``if``/``while``/``assert`` on a tensor.  Each one stalls
  the host until the device drains, once per iteration; the event loop
  is allowed one per trip, and each sanctioned sync carries an inline
  suppression with its reason.

* RPR007 -- an impure host call in code that a CUDA graph captures (a
  ``with torch.cuda.graph(...)`` body, the statements between
  ``capture_begin()`` and ``capture_end()``, a function passed to
  ``torch.cuda.make_graphed_callables``) or that ``torch.compile``
  traces (``torch.compile(fn)``, ``@torch.compile``): ``time.*``,
  ``random.*``, ``np.random.*``, ``datetime.*``, a `repro_torch.obs`
  span, or ``.inc``/``.set``/``.observe`` on a counter, gauge or
  histogram made by ``get_counter``/``get_gauge``/``get_histogram``.
  Such a call runs once at capture and never at replay, so a counter
  stops counting and a span times nothing.

Both rules follow a conservative call graph: calls to module-level
functions, ``self.`` methods, and attributes of corpus-module import
aliases.  A value is a *tensor* when it is a parameter annotated
``Tensor`` or a local assigned from a ``torch.*`` call or from another
tensor; ``.shape``/``.dtype``/``.ndim``/``.size()`` derivations and
``bool``/``int``/``float``/``len`` results are host values, as are plain
parameters (a mode string would otherwise drown the signal).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Iterable, Iterator

from repro_torch.analysis.engine import (FileContext, Finding, call_name,
                                         import_map, is_hot, is_tensor_call,
                                         rule, walk_scope, walk_shallow)

_STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout",
                 "requires_grad"}
_STATIC_METHODS = {"size", "dim", "numel", "nelement", "element_size",
                   "stride", "data_ptr", "is_contiguous",
                   "is_floating_point", "get_device"}
_SCALAR_CALLS = {"bool", "int", "float", "len", "isinstance", "hasattr",
                 "callable", "id", "type"}
_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
_IMPURE_PREFIXES = ("time.", "random.", "np.random.", "numpy.random.",
                    "datetime.", "secrets.")
_OBS_MODULE = "repro_torch.obs"
_METRIC_FACTORIES = {"get_counter", "get_gauge", "get_histogram"}
_METRIC_METHODS = {"inc", "dec", "set", "observe"}
_GRAPH_CTX = ("torch.cuda.graph", "cuda.graph")
_GRAPHED = ("torch.cuda.make_graphed_callables", "make_graphed_callables")


# ------------------------------------------------------------- call graph
@dataclass
class _Fn:
    node: ast.FunctionDef | ast.AsyncFunctionDef
    ctx: FileContext
    cls: str | None


class _Graph:
    """Every module-level function and method of the corpus, and the
    resolution of a call target to one of them."""

    def __init__(self, ctxs: list[FileContext]):
        self.fns: dict[tuple[str, str], _Fn] = {}
        for ctx in ctxs:
            for node in ctx.tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.fns[(ctx.path, node.name)] = _Fn(node, ctx, None)
                elif isinstance(node, ast.ClassDef):
                    for sub in node.body:
                        if isinstance(sub, (ast.FunctionDef,
                                            ast.AsyncFunctionDef)):
                            self.fns[(ctx.path, f"{node.name}.{sub.name}")] \
                                = _Fn(sub, ctx, node.name)
        self.module_fns = {(fn.ctx.module, key[1]): key
                           for key, fn in self.fns.items()
                           if fn.cls is None and fn.ctx.module}
        self.imports = {ctx.path: import_map(ctx) for ctx in ctxs}

    def resolve(self, expr: ast.AST, ctx: FileContext) -> tuple | None:
        """Map a function reference expression to a function key, if
        in-corpus."""
        aliases, froms = self.imports[ctx.path]
        if isinstance(expr, ast.Call) and call_name(expr.func) in (
                "functools.partial", "partial"):
            return self.resolve(expr.args[0], ctx) if expr.args else None
        if isinstance(expr, ast.Name):
            key = (ctx.path, expr.id)
            if key in self.fns:
                return key
            if expr.id in froms:
                return self.module_fns.get(froms[expr.id])
            return None
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name):
            base = expr.value.id
            if base == "self":
                for key, fn in self.fns.items():
                    if key[0] == ctx.path and fn.cls and \
                            key[1].endswith("." + expr.attr):
                        return key
                return None
            mod = aliases.get(base)
            if mod is None and base in froms:
                parent, orig = froms[base]
                mod = f"{parent}.{orig}"
            if mod is not None:
                return self.module_fns.get((mod, expr.attr))
        return None

    def closure(self, seeds: Iterable[tuple]) -> dict[tuple, _Fn]:
        """The seeds and every corpus function they call, transitively."""
        reached: dict[tuple, _Fn] = {}
        frontier = list(seeds)
        while frontier:
            key = frontier.pop()
            if key in reached or key not in self.fns:
                continue
            fn = reached[key] = self.fns[key]
            for node in ast.walk(fn.node):
                if isinstance(node, ast.Call):
                    tgt = self.resolve(node.func, fn.ctx)
                    if tgt is not None and tgt not in reached:
                        frontier.append(tgt)
        return reached

    def callees(self, nodes: Iterable[ast.AST], ctx: FileContext
                ) -> set[tuple]:
        return {k for n in nodes if isinstance(n, ast.Call)
                for k in [self.resolve(n.func, ctx)] if k is not None}


def _scoped(tree: ast.Module) -> Iterator[tuple[str, ast.AST, ast.AST]]:
    """(qualname of the enclosing def, that def or the module, node) for
    every node of a file; methods are `Class.method`, nested defs
    `outer.inner`."""
    def visit(node, qual, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                inner = f"{qual}.{child.name}" if qual else child.name
                yield qual or "<module>", scope, child
                yield from visit(child, inner, child if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef))
                    else scope)
            else:
                yield qual or "<module>", scope, child
                yield from visit(child, qual, scope)
    yield from visit(tree, "", tree)


# ----------------------------------------------------- tensor value model
def _is_static_derivation(expr: ast.AST) -> bool:
    """`x.shape`, `x.dtype`, `x.shape[0]`, `x.size(0)`, `len(...)`."""
    node = expr
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
        return True
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _STATIC_METHODS:
            return True
        return call_name(node.func) == "len"
    return False


def _tensor_usage(expr: ast.AST, tensors: set[str]) -> bool:
    """`expr` yields (or carries) a device tensor, not a host value."""
    if _is_static_derivation(expr):
        return False
    if isinstance(expr, ast.Name):
        return expr.id in tensors
    if isinstance(expr, ast.Attribute):
        return expr.attr not in _STATIC_ATTRS and \
            _tensor_usage(expr.value, tensors)
    if isinstance(expr, ast.Call):
        name = call_name(expr.func)
        if name in _SCALAR_CALLS:
            return False
        if is_tensor_call(name):
            return True
        if isinstance(expr.func, ast.Attribute):
            if expr.func.attr in _SYNC_METHODS:
                return False
            if _tensor_usage(expr.func.value, tensors):
                return True
        return any(_tensor_usage(a, tensors) for a in expr.args) or \
            any(_tensor_usage(k.value, tensors) for k in expr.keywords)
    if isinstance(expr, ast.Compare) and (
            all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops) or
            any(isinstance(c, ast.Constant) and isinstance(c.value, str)
                for c in [expr.left, *expr.comparators])):
        return False   # identity tests and string comparisons are host
    if isinstance(expr, ast.Lambda):
        return False
    return any(_tensor_usage(c, tensors) for c in ast.iter_child_nodes(expr))


def _tensors(scope: ast.AST) -> set[str]:
    """Tensor-annotated parameters and the locals assigned from tensors."""
    tensors: set[str] = set()
    if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
        for a in (scope.args.posonlyargs + scope.args.args +
                  scope.args.kwonlyargs):
            if a.annotation is not None and \
                    "Tensor" in ast.unparse(a.annotation):
                tensors.add(a.arg)
    for _ in range(3):  # re-passes pick up tensor-from-tensor chains
        for node in walk_scope(scope):
            if isinstance(node, ast.Assign):
                pairs = [(t, node.value) for t in node.targets]
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and \
                    node.value is not None:
                pairs = [(node.target, node.value)]
            else:
                continue
            for tgt, value in pairs:
                if isinstance(tgt, (ast.Tuple, ast.List)) and \
                        isinstance(value, (ast.Tuple, ast.List)) and \
                        len(tgt.elts) == len(value.elts):
                    pairs.extend(zip(tgt.elts, value.elts))
                elif isinstance(tgt, ast.Name) and \
                        _tensor_usage(value, tensors):
                    tensors.add(tgt.id)
                elif isinstance(tgt, (ast.Tuple, ast.List)) and \
                        _tensor_usage(value, tensors):
                    tensors.update(e.id for e in tgt.elts
                                   if isinstance(e, ast.Name))
    return tensors


def _sync_kind(node: ast.AST, tensors: set[str]) -> str | None:
    """The kind of host sync `node` is, if it is one."""
    if isinstance(node, ast.Call):
        name = call_name(node.func)
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in _SYNC_METHODS and not node.args:
                return node.func.attr
            if node.func.attr == "synchronize":
                return "synchronize"
        if name in ("bool", "int", "float") and len(node.args) == 1 and \
                _tensor_usage(node.args[0], tensors):
            return name
    elif isinstance(node, (ast.If, ast.While, ast.Assert)) and \
            _tensor_usage(node.test, tensors):
        return type(node).__name__.lower()
    return None


def _hot_loops(ctx: FileContext
               ) -> Iterator[tuple[str, ast.AST, list[ast.AST]]]:
    """(qualname, enclosing scope, nodes run once per iteration) for each
    `for`/`while` loop of a file."""
    for qual, scope, node in _scoped(ctx.tree):
        if isinstance(node, (ast.For, ast.AsyncFor)):
            yield qual, scope, list(walk_shallow(node.body))
        elif isinstance(node, ast.While):   # the test runs every iteration
            yield qual, scope, [node, *walk_shallow([node.test, *node.body])]


# ------------------------------------------------------------------ rules
@rule(
    code="RPR006",
    name="host-sync-in-hot-loop",
    summary="host sync (.item/.cpu/.tolist/.numpy/.synchronize, "
            "bool/int/float or if/while/assert on a tensor) inside a loop "
            "of a hot module or a function such a loop calls",
    bug="the port's event loop runs on the card from a host loop: every "
        "sync per iteration drains the device queue (the DES is allowed "
        "one per trip); the reference guards the same seam under "
        "jit",
)
def check_rpr006(ctxs: list[FileContext]) -> Iterable[Finding]:
    graph = _Graph(ctxs)
    seen: set[tuple] = set()

    def report(ctx, qual, scope, nodes, where):
        tensors = _tensors(scope)
        for node in nodes:
            kind = _sync_kind(node, tensors)
            if kind is None or (ctx.path, node.lineno, kind) in seen:
                continue
            seen.add((ctx.path, node.lineno, kind))
            yield Finding(
                rule="RPR006", path=ctx.path, line=node.lineno,
                message=f"host sync `{kind}` {where} `{qual}`: the host "
                        f"waits for the device once per iteration; keep "
                        f"the value on the device or hoist the sync out "
                        f"of the loop (a sanctioned one carries "
                        f"`# sentinel: ignore[RPR006]` and its reason)",
                key=f"{qual}:{kind}")

    seeds: set[tuple] = set()
    for ctx in ctxs:
        if not is_hot(ctx):
            continue
        for qual, scope, nodes in _hot_loops(ctx):
            yield from report(ctx, qual, scope, nodes, "inside a loop of")
            seeds |= graph.callees(nodes, ctx)
    for key, fn in graph.closure(seeds).items():
        yield from report(fn.ctx, key[1], fn.node, ast.walk(fn.node),
                          "in a function that a hot loop calls,")


def _captured(ctx: FileContext
              ) -> Iterator[tuple[str, list[ast.AST]]]:
    """(qualname, nodes) of each region a CUDA graph captures in a file:
    `with torch.cuda.graph(...)` bodies and capture_begin/end spans."""
    for qual, _, node in _scoped(ctx.tree):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(it.context_expr, ast.Call) and
                call_name(it.context_expr.func).endswith(_GRAPH_CTX)
                for it in node.items):
            yield qual, list(walk_shallow(node.body))
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            qual = node.name if qual == "<module>" else f"{qual}.{node.name}"
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(node, field, None)
            if not isinstance(stmts, list):
                continue
            region: list[ast.stmt] | None = None
            for stmt in stmts:
                attr = stmt.value.func.attr if (
                    isinstance(stmt, ast.Expr) and
                    isinstance(stmt.value, ast.Call) and
                    isinstance(stmt.value.func, ast.Attribute)) else ""
                if attr == "capture_begin":
                    region = []
                elif attr == "capture_end" and region is not None:
                    yield qual, list(walk_shallow(region))
                    region = None
                elif region is not None:
                    region.append(stmt)


def _compiled(ctx: FileContext, graph: _Graph) -> set[tuple]:
    """Functions that torch.compile traces or make_graphed_callables
    captures."""
    out: set[tuple] = set()
    for node in ctx.nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if call_name(target) == "torch.compile":
                    out |= {k for k, fn in graph.fns.items()
                            if fn.node is node}
        elif isinstance(node, ast.Call) and node.args:
            name = call_name(node.func)
            if name == "torch.compile":
                refs = [node.args[0]]
            elif name in _GRAPHED:
                arg = node.args[0]
                refs = arg.elts if isinstance(arg, (ast.Tuple, ast.List)) \
                    else [arg]
            else:
                continue
            out |= {k for r in refs for k in [graph.resolve(r, ctx)]
                    if k is not None}
    return out


def _impurity(ctx: FileContext):
    """The file's test for an impure call: (node) -> name or None."""
    aliases, froms = import_map(ctx)
    obs = {local for local, (mod, _) in froms.items()
           if mod == _OBS_MODULE or mod.startswith(_OBS_MODULE + ".")} | \
        {a for a, mod in aliases.items()
         if mod == _OBS_MODULE or mod.startswith(_OBS_MODULE + ".")}
    metrics = {t.id for node in ctx.tree.body if isinstance(node, ast.Assign)
               and isinstance(node.value, ast.Call) and
               call_name(node.value.func).split(".")[-1] in _METRIC_FACTORIES
               for t in node.targets if isinstance(t, ast.Name)}

    def impure(node: ast.AST) -> str | None:
        if not isinstance(node, ast.Call):
            return None
        name = call_name(node.func)
        if name.startswith(_IMPURE_PREFIXES) or name.split(".")[0] in obs:
            return name
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _METRIC_METHODS and \
                call_name(node.func.value) in metrics:
            return name
        return None
    return impure


@rule(
    code="RPR007",
    name="capture-impurity",
    summary="impure host call (time/random/datetime, obs spans and "
            "metrics) in code a CUDA graph captures or torch.compile "
            "traces",
    bug="a captured CUDA graph replays device work only: a counter "
        "incremented or a span opened in the captured body runs once at "
        "capture and never at replay, so the metric is a lie (the "
        "reference's span hazard under jit)",
)
def check_rpr007(ctxs: list[FileContext]) -> Iterable[Finding]:
    graph = _Graph(ctxs)
    tests = {ctx.path: _impurity(ctx) for ctx in ctxs}

    def report(ctx, qual, nodes):
        for node in nodes:
            name = tests[ctx.path](node)
            if name is not None:
                yield Finding(
                    rule="RPR007", path=ctx.path, line=node.lineno,
                    message=f"`{name}(...)` in `{qual}`, which a CUDA "
                            f"graph captures or torch.compile traces: it "
                            f"runs once at capture and never at replay; "
                            f"move it to the host-side caller",
                    key=f"{qual}:{name}")

    seeds: set[tuple] = set()
    for ctx in ctxs:
        seeds |= _compiled(ctx, graph)
        for qual, nodes in _captured(ctx):
            yield from report(ctx, qual, nodes)
            seeds |= graph.callees(nodes, ctx)
    for key, fn in graph.closure(seeds).items():
        yield from report(fn.ctx, key[1], ast.walk(fn.node))
