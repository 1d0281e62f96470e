"""Sentinel baseline: grandfathered findings, committed for review.

``sentinel_baseline_torch.json`` (the port's; the reference keeps
``sentinel_baseline.json``, in the same format, so that a baseline file
reads the same in both) holds findings that predate a rule (or are
accepted with justification) as ``{rule, path, key, note}`` entries -- no
line numbers, so entries survive unrelated edits.  The CLI subtracts
baselined findings before deciding the exit status; `check_baseline` (the
CI guard) fails when the file grows beyond the pinned entry count or
carries entries that no longer match any finding, so grandfathering is
always visible in review and the baseline can only shrink silently.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

from repro_torch.analysis.engine import Finding

DEFAULT_BASELINE = "sentinel_baseline_torch.json"


@dataclass
class Baseline:
    entries: list[dict] = field(default_factory=list)

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path, encoding="utf-8") as f:
            payload = json.load(f)
        entries = payload.get("findings", [])
        for e in entries:
            missing = {"rule", "path", "key"} - set(e)
            if missing:
                raise ValueError(
                    f"baseline entry {e!r} is missing {sorted(missing)}")
        return cls(entries=entries)

    @classmethod
    def from_findings(cls, findings: list[Finding]) -> "Baseline":
        return cls(entries=[
            {"rule": f.rule, "path": f.path, "key": f.key,
             "note": "grandfathered; fix and remove"}
            for f in findings])

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"version": 1, "findings": self.entries}, f, indent=2,
                      sort_keys=True)
            f.write("\n")

    def ids(self) -> set[tuple[str, str, str]]:
        return {(e["rule"], e["path"], e["key"]) for e in self.entries}

    def split(self, findings: list[Finding]
              ) -> tuple[list[Finding], list[Finding], list[dict]]:
        """(new, baselined, stale-entries) for a fresh run's findings."""
        ids = self.ids()
        new = [f for f in findings if f.baseline_id not in ids]
        old = [f for f in findings if f.baseline_id in ids]
        matched = {f.baseline_id for f in old}
        stale = [e for e in self.entries
                 if (e["rule"], e["path"], e["key"]) not in matched]
        return new, old, stale
