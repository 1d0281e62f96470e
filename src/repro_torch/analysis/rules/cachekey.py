"""RPR008: compile-cache keys must be hashable statics.

History: the reference's `CompiledDES` bucket cache keys a jit executable by
``(cfg, pad.d, pad.e)`` where ``cfg`` is a NamedTuple of scalars -- the
whole point is that every element is a *hashable static*.  The failure
modes this rule guards:

* keying a cache on a list/dict/set (TypeError at first insert -- found in
  review twice),
* keying on a non-frozen dataclass instance (``eq=True`` without
  ``frozen=True`` sets ``__hash__ = None``: unhashable),
* keying on a frozen-but-array-carrying container (NamedTuple / frozen
  dataclass holding ``np.ndarray`` fields: the tuple hash recurses into
  the unhashable array),
* ``functools.lru_cache`` over parameters of those same types,
* keying on a tensor (a ``Tensor``-annotated parameter, a local made by a
  ``torch.*`` call, or a container with ``Tensor`` fields):
  ``Tensor.__hash__`` is the object's identity, so such a key hits only
  on the very same object and every equal tensor opens a new entry.  The
  port's engine cache (``des_torch._ENGINE_CACHE``), which a captured CUDA
  graph will key, is the site this guards.

Only names that look like caches (``*_CACHE``, ``cache``, ...) are
checked, so ordinary dict writes stay out of scope.
"""
from __future__ import annotations

import ast
import re
from typing import Iterable

from repro_torch.analysis.engine import (FileContext, Finding,
                                         annotation_text, call_name,
                                         class_fields, is_dataclass_def,
                                         is_namedtuple_def, is_tensor_call,
                                         rule, scopes, walk_scope)

_CACHE_NAME_RE = re.compile(r"(?i)(^|_)cache(s|_|$)|^memo")

_UNHASHABLE_ANN_TOKENS = ("list", "List", "dict", "Dict", "set", "Set",
                          "ndarray", "Array", "bytearray", "DataFrame",
                          "Tensor")
_IDENTITY_HASH = "hashes by identity, so the key hits only on the same " \
    "object"


def _ann_unhashable(ann: str) -> bool:
    if not ann:
        return False
    return any(re.search(rf"\b{re.escape(tok)}\b", ann)
               for tok in _UNHASHABLE_ANN_TOKENS)


def _class_info(ctxs: list[FileContext]) -> tuple[set[str], set[str]]:
    """(unhashable class names, array-carrying hashable containers)."""
    unhashable: set[str] = set()
    array_carrying: set[str] = set()
    for ctx in ctxs:
        for node in ctx.nodes:
            if not isinstance(node, ast.ClassDef):
                continue
            if is_dataclass_def(node):
                if not _dataclass_frozen(node):
                    unhashable.add(node.name)
                elif _has_unhashable_fields(node):
                    array_carrying.add(node.name)
            elif is_namedtuple_def(node) and _has_unhashable_fields(node):
                array_carrying.add(node.name)
    return unhashable, array_carrying


def _dataclass_frozen(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        if isinstance(dec, ast.Call) and call_name(dec.func) in (
                "dataclass", "dataclasses.dataclass"):
            for kw in dec.keywords:
                if kw.arg == "frozen" and \
                        isinstance(kw.value, ast.Constant):
                    return bool(kw.value.value)
    return False


def _has_unhashable_fields(cls: ast.ClassDef) -> bool:
    return any(_ann_unhashable(annotation_text(f.annotation))
               for _, f in class_fields(cls))


def _is_cache_name(expr: ast.AST) -> bool:
    name = call_name(expr)
    return bool(name and _CACHE_NAME_RE.search(name.split(".")[-1]))


def _key_elements(key: ast.expr) -> list[ast.expr]:
    if isinstance(key, ast.Tuple):
        return list(key.elts)
    return [key]


def _scope_env(fn) -> tuple[dict[str, str], dict[str, str]]:
    """(local name -> ctor class name, param name -> annotation text)."""
    ctors: dict[str, str] = {}
    for node in walk_scope(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Call):
            cname = call_name(node.value.func).split(".")[-1]
            if is_tensor_call(call_name(node.value.func)):
                ctors[node.targets[0].id] = "@tensor"
            elif cname and cname[0].isupper():
                ctors[node.targets[0].id] = cname
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, (ast.List, ast.Dict, ast.Set,
                                        ast.ListComp, ast.DictComp,
                                        ast.SetComp)):
            ctors[node.targets[0].id] = "@literal"
    params: dict[str, str] = {}
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        for a in (list(fn.args.posonlyargs) + list(fn.args.args) +
                  list(fn.args.kwonlyargs)):
            params[a.arg] = annotation_text(a.annotation)
    return ctors, params


def _element_problem(el: ast.expr, ctors: dict[str, str],
                     params: dict[str, str], unhashable: set[str],
                     array_carrying: set[str]) -> str | None:
    if isinstance(el, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                       ast.DictComp, ast.SetComp)):
        return "a list/dict/set literal is unhashable"
    if isinstance(el, ast.Call):
        cname = call_name(el.func)
        tail = cname.split(".")[-1]
        if tail in ("list", "dict", "set", "bytearray"):
            return f"`{tail}(...)` is unhashable"
        if is_tensor_call(cname):
            return f"`{cname}(...)` is a tensor: it {_IDENTITY_HASH}"
        if tail in unhashable:
            return f"`{tail}` is a non-frozen dataclass (unhashable)"
        if tail in array_carrying:
            return f"`{tail}` carries ndarray fields (hash recurses into " \
                   f"the unhashable array)"
        return None
    if isinstance(el, ast.Name):
        src = ctors.get(el.id)
        if src == "@literal":
            return f"`{el.id}` is a list/dict/set"
        if src == "@tensor":
            return f"`{el.id}` is a tensor: it {_IDENTITY_HASH}"
        if src in unhashable:
            return f"`{el.id}` is a non-frozen `{src}` (unhashable)"
        if src in array_carrying:
            return f"`{el.id}` is a `{src}` carrying ndarray fields"
        ann = params.get(el.id, "")
        if re.search(r"\bTensor\b", ann):
            return f"`{el.id}: {ann}` {_IDENTITY_HASH}"
        if _ann_unhashable(ann):
            return f"`{el.id}: {ann}` is unhashable"
        if ann.split(".")[-1] in unhashable:
            return f"`{el.id}: {ann}` is a non-frozen dataclass (unhashable)"
    return None


@rule(
    code="RPR008",
    name="cache-key-hygiene",
    summary="compile/lookup cache keyed (or lru_cache parameterized) on an "
            "unhashable or array-carrying value",
    bug="CompiledDES bucket keys must be hashable scalars/NamedTuples; "
        "an ndarray or non-frozen dataclass in the key dies at first insert",
)
def check(ctxs: list[FileContext]) -> Iterable[Finding]:
    unhashable, array_carrying = _class_info(ctxs)
    for ctx in ctxs:
        for scope_name, scope in scopes(ctx):
            ctors, params = _scope_env(scope)
            for node in walk_scope(scope):
                key_expr = _cache_key_expr(node)
                if key_expr is None:
                    continue
                for i, el in enumerate(_key_elements(key_expr)):
                    why = _element_problem(el, ctors, params, unhashable,
                                           array_carrying)
                    if why is None:
                        continue
                    yield Finding(
                        rule="RPR008", path=ctx.path, line=node.lineno,
                        message=f"cache key element {i} in `{scope_name}` "
                                f"is not a hashable static: {why}; cache "
                                f"keys must be scalars / frozen scalar "
                                f"containers (the CompiledDES bucket-key "
                                f"contract)",
                        key=f"{scope_name}:key[{i}]")
        yield from _check_lru_cache(ctx)


def _cache_key_expr(node: ast.AST) -> ast.expr | None:
    """Key expression of a cache write/lookup, else None."""
    if isinstance(node, ast.Subscript) and _is_cache_name(node.value):
        return node.slice
    if isinstance(node, ast.Call) and \
            isinstance(node.func, ast.Attribute) and \
            node.func.attr in ("get", "setdefault", "pop") and \
            _is_cache_name(node.func.value) and node.args:
        return node.args[0]
    return None


def _check_lru_cache(ctx: FileContext) -> Iterable[Finding]:
    for _, fn in scopes(ctx):
        if fn is ctx.tree:
            continue
        decorated = False
        for dec in fn.decorator_list:
            name = call_name(dec.func) if isinstance(dec, ast.Call) \
                else call_name(dec)
            if name in ("functools.lru_cache", "lru_cache",
                        "functools.cache", "cache"):
                decorated = True
        if not decorated:
            continue
        for a in (list(fn.args.posonlyargs) + list(fn.args.args) +
                  list(fn.args.kwonlyargs)):
            ann = annotation_text(a.annotation)
            if _ann_unhashable(ann):
                yield Finding(
                    rule="RPR008", path=ctx.path, line=fn.lineno,
                    message=f"@lru_cache on `{fn.name}` with unhashable "
                            f"parameter `{a.arg}: {ann}`: every call "
                            f"raises TypeError; key on hashable statics "
                            f"(shape tuples, frozen configs) instead",
                    key=f"{fn.name}.{a.arg}")
