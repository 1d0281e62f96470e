"""Sentinel CLI of the port.

    PYTHONPATH=src python -m repro_torch.analysis [paths]

With no paths (run from the repo root) it reads the port: `src/repro_torch`,
`chip_smoke.py`, `kernel_variants.py` and `tests/test_torch_*.py` -- not
the reference's tests, whose reads would hide a field the port never
reads.

Exit status 0 = no non-baselined findings, 1 = findings (or stale
baseline), 2 = usage error.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys

from repro_torch.analysis.baseline import DEFAULT_BASELINE, Baseline
from repro_torch.analysis.engine import RULES, analyze, iter_python_files
from repro_torch.analysis.report import (render_json, render_rule_catalog,
                                         render_text)

DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py", "kernel_variants.py",
                 "tests/test_torch_*.py")


def default_paths() -> list[str]:
    """`DEFAULT_PATHS` under the current directory, globs expanded."""
    return [p for pat in DEFAULT_PATHS for p in sorted(glob.glob(pat))]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="DELTA-Sentinel static analysis of the PyTorch port")
    ap.add_argument("paths", nargs="*", default=[],
                    help="files/directories to analyze (default: "
                         + " ".join(DEFAULT_PATHS) + ")")
    ap.add_argument("--select", default="",
                    help="comma-separated rule codes (default: all)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit JSON instead of text")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help=f"baseline file (default {DEFAULT_BASELINE}; "
                         f"ignored when absent)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, baselined or not")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the current findings to --baseline and "
                         "exit 0 (grandfathering; guarded by "
                         "repro_torch.analysis.check_baseline)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        from repro_torch.analysis import rules as _rules  # noqa: F401
        print(render_rule_catalog())
        return 0
    if not args.paths and not os.path.isdir("src/repro_torch"):
        ap.error("no paths given and no src/repro_torch here: run from the "
                 "repo root or name the paths")
    paths = args.paths or default_paths()

    select = [s.strip() for s in args.select.split(",") if s.strip()] or None
    if select:
        from repro_torch.analysis import rules as _rules  # noqa: F401
        unknown = [s for s in select if s not in RULES and s != "RPR000"]
        if unknown:
            ap.error(f"unknown rule code(s) {unknown}; "
                     f"known: {sorted(RULES)}")

    findings, suppressed = analyze(paths, select=select)
    nfiles = len(list(iter_python_files(paths)))

    if args.write_baseline:
        Baseline.from_findings(findings).save(args.baseline)
        print(f"wrote {len(findings)} entr{'y' if len(findings) == 1 else 'ies'} "
              f"to {args.baseline}")
        return 0

    baselined: list = []
    stale: list = []
    if not args.no_baseline and os.path.exists(args.baseline):
        bl = Baseline.load(args.baseline)
        findings, baselined, stale = bl.split(findings)

    render = render_json if args.as_json else render_text
    out = render(findings, baselined, nfiles, suppressed)
    if out:
        print(out, end="" if out.endswith("\n") else "\n")
    for e in stale:
        print(f"# stale baseline entry (no longer matches anything -- "
              f"remove it): {e['rule']} {e['path']} {e['key']}")
    return 1 if findings or stale else 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:   # e.g. `... --list-rules | head`
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
