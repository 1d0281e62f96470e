"""DELTA-Sentinel for the port: repo-specific static analysis of
`repro_torch` (stdlib-only, AST-based).

The port of `repro.analysis`, under the same module names and rule codes.
Each rule encodes a bug class: the reference's rules keep their logic
where the hazard is the same (unread fields, options mutation, solver
status, cache keys, deprecated facades) and take a PyTorch/CUDA shape
where the reference's rule was about JAX (float64 on the card, host
syncs in hot loops, impurity under CUDA-graph capture); two are new
(a device failure swallowed by a broad handler, TF32).

Usage, from the repo root:

    PYTHONPATH=src python -m repro_torch.analysis [paths]

With no paths it reads `src/repro_torch`, `chip_smoke.py`,
`kernel_variants.py` and `tests/test_torch_*.py`.

Per-line suppression:   ``# sentinel: ignore[RPR006]`` (trailing comment on
the reported line; several codes separated by commas, bare
``# sentinel: ignore`` suppresses every rule on the line).

Grandfathered findings live in ``sentinel_baseline_torch.json`` (see
`repro_torch.analysis.baseline`), in the reference's format;
`repro_torch.analysis.check_baseline` is the guard that keeps the
baseline from growing silently.

This package imports nothing outside the standard library (no torch, no
jax, nothing of `repro`).
"""
from repro_torch.analysis.engine import (FileContext, Finding, Rule, RULES,
                                         analyze, analyze_paths,
                                         collect_contexts, iter_python_files)
from repro_torch.analysis.baseline import Baseline
from repro_torch.analysis.report import render_json, render_text

__all__ = [
    "Baseline",
    "FileContext",
    "Finding",
    "RULES",
    "Rule",
    "analyze",
    "analyze_paths",
    "collect_contexts",
    "iter_python_files",
    "render_json",
    "render_text",
]
