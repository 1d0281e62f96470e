"""RPR010: a broad handler that swallows a device engine's failure.

History: several of the reference's sites fall back to the CPU quietly
when a device engine fails to build or run.  The port's standing rule is
the opposite: a missing device or a failed kernel raises, so that a
planner never reports a CPU run as a card run (`tests/test_torch_failsafe.py`
pins it).  The rule flags a handler for ``Exception``, ``BaseException``,
``RuntimeError``, ``OSError``, ``ImportError`` or a bare ``except:`` with
no ``raise`` in it, whose ``try`` body builds or runs a device engine or
kernel: ``TorchDES``/``EnsembleTorchDES``/``_LaneDES`` (and calls on a
local made by one of them), any function of a ``repro_torch.kernels``
module but the plain versions in ``kernels.ref`` (the ops, the kernel
wrappers, the loader in ``kernels/_build.py``), or ``torch.cuda.*``.

Scope: ``repro_torch.*`` modules and ``chip_smoke.py``.  A handler that
re-raises, a narrow handler, and a ``try`` around host-only work are not
flagged.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.engine import (PACKAGE, FileContext, Finding,
                                         call_name, import_map, rule, scopes,
                                         walk_scope, walk_shallow)

_BROAD = {"Exception", "BaseException", "RuntimeError", "OSError",
          "ImportError"}
_ENGINES = {"TorchDES", "EnsembleTorchDES", "_LaneDES"}
_KERNELS = PACKAGE + ".kernels"


def _kernel_module(mod: str) -> bool:
    return (mod == _KERNELS or mod.startswith(_KERNELS + ".")) and \
        not mod.endswith(".ref")


def _broad(handler: ast.ExceptHandler) -> str | None:
    """The broad exception type a handler catches, if any."""
    if handler.type is None:
        return "bare"
    types = handler.type.elts if isinstance(handler.type, ast.Tuple) \
        else [handler.type]
    for t in types:
        tail = call_name(t).split(".")[-1]
        if tail in _BROAD:
            return tail
    return None


class _DeviceCalls:
    """Which calls of a file build or run a device engine or kernel."""

    def __init__(self, ctx: FileContext):
        self.aliases, self.froms = import_map(ctx)
        self.local_fns = set()
        if _kernel_module(ctx.module):
            self.local_fns = {n.name for n in ctx.tree.body if isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef))}

    def _module_of(self, name: str) -> str:
        """The module a dotted call target lives in ('' if unknown)."""
        head, _, rest = name.partition(".")
        if head in self.froms:
            mod, orig = self.froms[head]
            if not rest:
                return mod
            head_mod = f"{mod}.{orig}"
        elif head in self.aliases:
            head_mod = self.aliases[head]
        else:
            return ""
        return ".".join([head_mod, *rest.split(".")[:-1]])

    def describe(self, node: ast.Call, engines: set[str]) -> str | None:
        name = call_name(node.func)
        if not name:
            return None
        head, tail = name.split(".")[0], name.split(".")[-1]
        if tail in _ENGINES or name.startswith("torch.cuda.") or \
                head in engines or name in self.local_fns or \
                _kernel_module(self._module_of(name)):
            return name
        return None


@rule(
    code="RPR010",
    name="device-fallback",
    summary="broad except (Exception/BaseException/RuntimeError/OSError/"
            "ImportError/bare) without raise around building or running "
            "a device engine or kernel",
    bug="the reference falls back to the CPU quietly at several sites; "
        "in the port a missing device or a failed kernel raises "
        "(tests/test_torch_failsafe.py pins it)",
)
def check(ctxs: list[FileContext]) -> Iterable[Finding]:
    for ctx in ctxs:
        if not (ctx.in_package or ctx.path.split("/")[-1] ==
                "chip_smoke.py"):
            continue
        calls = _DeviceCalls(ctx)
        for scope_name, scope in scopes(ctx):
            engines = {t.id for n in walk_scope(scope)
                       if isinstance(n, ast.Assign) and
                       isinstance(n.value, ast.Call) and
                       call_name(n.value.func).split(".")[-1] in _ENGINES
                       for t in n.targets if isinstance(t, ast.Name)}
            for node in walk_scope(scope):
                if not isinstance(node, ast.Try):
                    continue
                device = next((d for n in walk_shallow(node.body)
                               if isinstance(n, ast.Call)
                               for d in [calls.describe(n, engines)]
                               if d is not None), None)
                if device is None:
                    continue
                for handler in node.handlers:
                    caught = _broad(handler)
                    if caught is None or any(
                            isinstance(n, ast.Raise)
                            for n in walk_shallow(handler.body)):
                        continue
                    yield Finding(
                        rule="RPR010", path=ctx.path, line=handler.lineno,
                        message=f"`except {caught}` without a raise "
                                f"around `{device}(...)` in "
                                f"`{scope_name}`: a device or kernel "
                                f"failure must raise, not fall back "
                                f"quietly; catch what you handle, or "
                                f"re-raise",
                        key=f"{scope_name}:{caught}")
