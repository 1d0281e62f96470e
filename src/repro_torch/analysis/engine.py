"""Sentinel engine: file contexts, rule registry, suppressions, runner.

A rule is a function ``(ctxs: list[FileContext]) -> Iterable[Finding]``
registered with `@rule(...)`.  Every rule sees the whole analyzed corpus
(several rules are package-wide by nature: "field never read anywhere",
"function reachable from a CUDA-graph capture"); purely local rules just
loop over the contexts.

Findings carry a ``key`` -- a line-number-free fingerprint (rule, path,
symbol/context) -- so baseline entries survive unrelated edits to the same
file.  Suppression is a trailing ``# sentinel: ignore[RPR###]`` comment on
the reported line.

This registry is the port's own: `repro.analysis.engine.RULES` holds the
reference's nine codes, and the two never share a rule.
"""
from __future__ import annotations

import ast
import functools
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator

# directories never analyzed: VCS/cache noise plus the seeded-violation
# fixtures (tests/test_torch_sentinel.py analyzes those explicitly)
EXCLUDED_DIRS = {".git", "__pycache__", ".ruff_cache", "sentinel_fixtures",
                 ".pytest_cache", "node_modules"}

# the package whose modules the package-scoped rules look at
PACKAGE = "repro_torch"

_SUPPRESS_RE = re.compile(
    r"#\s*sentinel:\s*ignore(?:\[(?P<codes>[A-Z0-9,\s]+)\])?")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str          # e.g. "RPR001"
    path: str          # repo-relative posix path
    line: int          # 1-based
    message: str
    key: str           # stable fingerprint (no line numbers) for baselines

    @property
    def baseline_id(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.key)

    def sort_key(self) -> tuple:
        return (self.path, self.line, self.rule, self.key)


@dataclass(frozen=True)
class Rule:
    """Registered rule: code + metadata + the check callable."""

    code: str
    name: str
    summary: str                 # one-line description (rule catalog)
    bug: str                     # the bug class it encodes
    check: Callable[[list["FileContext"]], Iterable[Finding]]


RULES: dict[str, Rule] = {}


def rule(code: str, name: str, summary: str, bug: str):
    """Decorator registering a corpus-level check under an RPR### code."""

    def deco(fn: Callable[[list["FileContext"]], Iterable[Finding]]):
        if code in RULES:
            raise ValueError(f"duplicate sentinel rule code {code}")
        RULES[code] = Rule(code=code, name=name, summary=summary, bug=bug,
                           check=fn)
        return fn

    return deco


@dataclass
class FileContext:
    """One parsed source file."""

    path: str                    # normalized relative posix path
    tree: ast.Module
    lines: list[str] = field(default_factory=list)
    # line -> set of suppressed codes (empty set == suppress everything)
    suppressions: dict[int, set[str]] = field(default_factory=dict)
    module: str = ""             # dotted module name when under a package
    abspath: str = ""            # where the file was read ("" for memory)

    @classmethod
    def parse(cls, path: str, display_path: str,
              source: str | None = None) -> "FileContext":
        abspath = ""
        if source is None:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            abspath = os.path.abspath(path)
        tree = ast.parse(source, filename=display_path)
        ctx = cls(path=display_path, tree=tree,
                  lines=source.splitlines(),
                  module=_module_name(display_path), abspath=abspath)
        ctx.suppressions = _parse_suppressions(ctx.lines)
        return ctx

    @functools.cached_property
    def nodes(self) -> list[ast.AST]:
        """Every node of the file in `ast.walk` order, walked once for
        all the rules."""
        return list(ast.walk(self.tree))

    @property
    def in_package(self) -> bool:
        """A module of the port's package (`repro_torch.*`)."""
        return self.module.startswith(PACKAGE + ".")

    def is_suppressed(self, finding: Finding) -> bool:
        codes = self.suppressions.get(finding.line)
        if codes is None:
            return False
        return not codes or finding.rule in codes


def _module_name(path: str) -> str:
    """Best-effort dotted module name ('' when not under src/)."""
    p = path.replace(os.sep, "/")
    if p.endswith(".py"):
        p = p[:-3]
    if "src/" in p:
        p = p.split("src/", 1)[1]
    parts = [q for q in p.split("/") if q]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _parse_suppressions(lines: list[str]) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    for i, line in enumerate(lines, start=1):
        if "sentinel" not in line:
            continue
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        codes = m.group("codes")
        out[i] = {c.strip() for c in codes.split(",") if c.strip()} \
            if codes else set()
    return out


def iter_python_files(paths: Iterable[str],
                      root: str | None = None) -> Iterator[tuple[str, str]]:
    """Yield (abspath, display_path) for every .py file under `paths`.

    `display_path` is relative to `root` (default: cwd) with forward
    slashes, so findings and baselines are machine-independent.
    """
    root = os.path.abspath(root or os.getcwd())

    def display(p: str) -> str:
        rel = os.path.relpath(os.path.abspath(p), root)
        return rel.replace(os.sep, "/")

    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py"):
                yield os.path.abspath(path), display(path)
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in EXCLUDED_DIRS)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    full = os.path.join(dirpath, fn)
                    yield os.path.abspath(full), display(full)


def collect_contexts(paths: Iterable[str],
                     root: str | None = None
                     ) -> tuple[list[FileContext], list[Finding]]:
    """Parse every file; unparsable files become RPR000 findings."""
    ctxs: list[FileContext] = []
    errors: list[Finding] = []
    for abspath, display_path in iter_python_files(paths, root):
        try:
            ctxs.append(FileContext.parse(abspath, display_path))
        except (SyntaxError, UnicodeDecodeError) as exc:
            errors.append(Finding(
                rule="RPR000", path=display_path,
                line=getattr(exc, "lineno", 1) or 1,
                message=f"file does not parse: {exc.msg}"
                if isinstance(exc, SyntaxError) else f"cannot read: {exc}",
                key="parse-error"))
    return ctxs, errors


def analyze(paths: Iterable[str], select: Iterable[str] | None = None,
            root: str | None = None
            ) -> tuple[list[Finding], list[Finding]]:
    """Run the (selected) rules over `paths` -> (findings, the findings
    an inline ``# sentinel: ignore`` silenced)."""
    # rule modules register themselves on import
    from repro_torch.analysis import rules as _rules  # noqa: F401

    ctxs, findings = collect_contexts(paths, root)
    by_path = {c.path: c for c in ctxs}
    selected = set(select) if select else None
    for code in sorted(RULES):
        if selected is not None and code not in selected:
            continue
        findings.extend(RULES[code].check(ctxs))
    out, suppressed = [], []
    for f in findings:
        ctx = by_path.get(f.path)
        if ctx is not None and ctx.is_suppressed(f):
            suppressed.append(f)
        else:
            out.append(f)
    return (sorted(out, key=Finding.sort_key),
            sorted(suppressed, key=Finding.sort_key))


def analyze_paths(paths: Iterable[str], select: Iterable[str] | None = None,
                  root: str | None = None) -> list[Finding]:
    """Run the (selected) rules over `paths`; suppressions applied."""
    return analyze(paths, select, root)[0]


# ---------------------------------------------------------------- AST utils
def call_name(node: ast.AST) -> str:
    """Dotted name of a call target: 'torch.zeros', 'md.solve', 'float'."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


# `torch.*` calls that make no tensor (devices, flags, contexts, seeds)
_TORCH_NON_TENSOR = (
    "torch.cuda.", "torch.backends.", "torch.distributed.", "torch.utils.",
    "torch.profiler.", "torch.library.", "torch.is_", "torch.get_",
    "torch.are_", "torch.set_", "torch.use_", "torch.device", "torch.Size",
    "torch.finfo", "torch.iinfo", "torch.Generator", "torch.no_grad",
    "torch.inference_mode", "torch.enable_grad", "torch.manual_seed",
    "torch.compile")


def is_tensor_call(name: str) -> bool:
    """A dotted call name that makes a tensor (`torch.zeros`, ...)."""
    return name.startswith("torch.") and \
        not name.startswith(_TORCH_NON_TENSOR)


def is_hot(ctx: FileContext) -> bool:
    """The device seam: the torch DES, the kernel layer and the
    host/device converters, where a dtype or a sync is a correctness or
    a speed bug rather than a style nit."""
    p = "/" + ctx.path
    return "des_torch" in p or "/kernels/" in p or p.endswith("/convert.py")


def scopes(ctx: FileContext):
    """(name, node) for the module and every function of a file."""
    yield "<module>", ctx.tree
    for fn in ctx.nodes:
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield fn.name, fn


def walk_scope(scope) -> Iterator[ast.AST]:
    """Walk a function/module without descending into nested defs (each
    scope is checked on its own)."""
    return walk_shallow(scope.body)


def walk_shallow(nodes: Iterable[ast.AST]) -> Iterator[ast.AST]:
    """Walk `nodes` and what they hold, nested defs excluded."""
    stack = list(nodes)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def import_map(ctx: FileContext) -> tuple[dict[str, str],
                                          dict[str, tuple[str, str]]]:
    """(module aliases, from-imports): `import x.y as z` -> {z: 'x.y'};
    `from x import f` -> {f: ('x', 'f')}."""
    aliases: dict[str, str] = {}
    froms: dict[str, tuple[str, str]] = {}
    for node in ctx.nodes:
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                froms[a.asname or a.name] = (node.module, a.name)
    return aliases, froms


def annotation_text(node: ast.AST | None) -> str:
    if node is None:
        return ""
    return ast.unparse(node)


def is_dataclass_def(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        name = call_name(dec.func) if isinstance(dec, ast.Call) \
            else call_name(dec)
        if name in ("dataclass", "dataclasses.dataclass"):
            return True
    return False


def is_namedtuple_def(cls: ast.ClassDef) -> bool:
    return any(call_name(base) in ("NamedTuple", "typing.NamedTuple")
               for base in cls.bases)


def class_fields(cls: ast.ClassDef) -> list[tuple[str, ast.AnnAssign]]:
    """(name, node) for annotated class-level fields (dataclass/NamedTuple
    style), skipping ClassVar and underscore-private names."""
    out: list[tuple[str, ast.AnnAssign]] = []
    for stmt in cls.body:
        if not isinstance(stmt, ast.AnnAssign) or \
                not isinstance(stmt.target, ast.Name):
            continue
        name = stmt.target.id
        if name.startswith("_"):
            continue
        if "ClassVar" in annotation_text(stmt.annotation):
            continue
        out.append((name, stmt))
    return out
