"""Sentinel reporters: text (CI log) and JSON (tooling)."""
from __future__ import annotations

import json

from repro_torch.analysis.engine import RULES, Finding


def _by_rule(findings: list[Finding]) -> str:
    counts: dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return ", ".join(f"{k}: {v}" for k, v in sorted(counts.items()))


def render_text(findings: list[Finding], baselined: list[Finding],
                files_analyzed: int,
                suppressed: list[Finding] | None = None) -> str:
    lines: list[str] = []
    for f in findings:
        lines.append(f"{f.path}:{f.line}: {f.rule} {f.message}")
    if baselined:
        lines.append(f"# {len(baselined)} baselined finding(s) suppressed "
                     f"(see sentinel_baseline_torch.json)")
    if suppressed:
        lines.append(f"# {len(suppressed)} finding(s) suppressed inline "
                     f"[{_by_rule(suppressed)}]")
    summary = _by_rule(findings)
    lines.append(f"# {files_analyzed} file(s), {len(findings)} finding(s)"
                 + (f" [{summary}]" if summary else ""))
    return "\n".join(lines)


def render_json(findings: list[Finding], baselined: list[Finding],
                files_analyzed: int,
                suppressed: list[Finding] | None = None) -> str:
    return json.dumps({
        "version": 1,
        "files_analyzed": files_analyzed,
        "findings": [
            {"rule": f.rule, "path": f.path, "line": f.line,
             "message": f.message, "key": f.key}
            for f in findings],
        "baselined": [
            {"rule": f.rule, "path": f.path, "line": f.line, "key": f.key}
            for f in baselined],
        "suppressed": [
            {"rule": f.rule, "path": f.path, "line": f.line, "key": f.key}
            for f in suppressed or []],
    }, indent=2) + "\n"


def render_rule_catalog() -> str:
    lines = ["Sentinel rule catalog (repro_torch):"]
    for code in sorted(RULES):
        r = RULES[code]
        lines.append(f"  {r.code}  {r.name}")
        lines.append(f"         {r.summary}")
        lines.append(f"         history: {r.bug}")
    return "\n".join(lines)
