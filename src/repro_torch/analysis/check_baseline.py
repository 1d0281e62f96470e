"""Guard on the port's Sentinel baseline (check_regression.py-style).

Grandfathering must be visible in review: the number of baselined findings
is pinned HERE, in code, so adding a baseline entry requires touching this
file in the same change.  The guard fails when

  * the baseline holds more than ``MAX_BASELINE_ENTRIES`` entries,
  * the baseline holds duplicate entries,
  * (with ``--paths``) an entry matches no current finding -- stale
    entries must be deleted, so the baseline can only shrink over time.

Usage:

    PYTHONPATH=src python -m repro_torch.analysis.check_baseline \
        --paths src/repro_torch chip_smoke.py kernel_variants.py

Exit status 0 = baseline healthy, 1 = guard tripped.
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis.baseline import DEFAULT_BASELINE, Baseline
from repro_torch.analysis.engine import analyze_paths

# The one number a change must edit to grow the baseline.  The shipped tree
# carries zero grandfathered findings: every rule is either clean or
# suppressed inline with a justification comment at the offending line.
MAX_BASELINE_ENTRIES = 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--paths", nargs="*", default=[],
                    help="when given, also fail on stale entries")
    ap.add_argument("--max-entries", type=int, default=MAX_BASELINE_ENTRIES,
                    help="override the pinned entry budget (tests only)")
    args = ap.parse_args(argv)

    problems: list[str] = []
    if not os.path.exists(args.baseline):
        print(f"# no baseline file ({args.baseline}); nothing to guard")
        return 0

    bl = Baseline.load(args.baseline)
    n = len(bl.entries)
    print(f"# baseline {args.baseline}: {n} entr{'y' if n == 1 else 'ies'} "
          f"(budget {args.max_entries})")
    if n > args.max_entries:
        problems.append(
            f"baseline grew to {n} entries > pinned budget "
            f"{args.max_entries}: fix the finding instead, or raise "
            f"MAX_BASELINE_ENTRIES in repro_torch/analysis/check_baseline.py in "
            f"the same change so the grandfathering is visible in review")
    if len(bl.ids()) != n:
        problems.append("baseline holds duplicate entries")

    if args.paths:
        findings = analyze_paths(args.paths)
        _, _, stale = bl.split(findings)
        for e in stale:
            problems.append(
                f"stale baseline entry (matches no current finding; "
                f"delete it): {e['rule']} {e['path']} {e['key']}")

    if problems:
        print("\nSENTINEL BASELINE GUARD:")
        for p in problems:
            print("  - " + p)
        return 1
    print("baseline healthy")
    return 0


if __name__ == "__main__":
    sys.exit(main())
