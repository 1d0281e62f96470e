"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix; each
metric names the cells it is read in (all cells without a `workloads`
key).  Nothing here knows any particular cell, configuration, mix or
metric: a new one is a new entry and a new file.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Spec:
    raw: dict
    bench: Path = BENCH

    @classmethod
    def load(cls, root: Path = ROOT, bench: Path = BENCH) -> "Spec":
        return cls(json.loads((root / "BENCHMARK.json").read_text()), bench)

    @property
    def run_seconds(self) -> int:
        return int(self.raw["run_seconds"])

    def workload(self, name: str) -> dict:
        for w in self.raw["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in self.raw['workloads']]}")

    def config_entry(self, name: str) -> dict:
        for c in self.raw["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def config(self, workload: dict) -> dict:
        """The configuration file of a cell, as it is run."""
        entry = self.config_entry(workload["config"])
        return json.loads((self.bench.parent / entry["file"]).read_text())

    def traffic(self, workload: dict) -> dict:
        path = self.bench / "traffic" / f"{workload['traffic']}.json"
        return json.loads(path.read_text())

    def limits(self, workload: dict) -> dict[str, float]:
        path = self.bench / "limits" / f"{workload['name']}.json"
        return json.loads(path.read_text())["limits"]

    def metrics(self, workload: dict, kind: str) -> list[dict]:
        """The `end_to_end` or `per_layer` metrics that `workload` reports."""
        return [m for m in self.raw[kind]
                if workload["name"] in m.get("workloads",
                                             [workload["name"]])]

    def reader(self, metric: str) -> ModuleType:
        """The reader of `metric`: `metrics/<metric>.py`, else the one of
        its family, `metrics/<name up to the first dot>.py`, which serves
        every `<family>.<cells>` metric.  Its unit, layer and what it
        moves are `BENCHMARK.json`'s alone."""
        path = self.bench / "metrics" / f"{metric}.py"
        if not path.is_file():
            path = self.bench / "metrics" / f"{metric.split('.')[0]}.py"
        return load_reader(path, metric)


def load_reader(path: Path, name: str) -> ModuleType:
    """A metric's reader module, loaded from its file (names hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load the reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
