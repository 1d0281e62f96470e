"""Wrappers set on the program from outside, and what they record.

The benchmark changes no file of the program.  It replaces a few of its
names for the length of a run (`Probe.wrap`) and puts every one back
(`Probe.restore`):

  * always, for `correct`: the fitness batches that the torch DES scored
    (`TorchDES.batch_genome_makespan`: genomes, pairs, makespans and
    feasibility) and the X̄ that Alg. 2 gave the GA
    (`repro_torch.core.ga.x_upper_bound`);
  * in a traced run, host spans around Alg. 2 (`xbound`) and around the
    host's numpy DES in the facade and the GA (`host_des`: the ideal run,
    the re-rank and the certification), and whatever a metric's reader
    installs for itself.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Batch:
    request: int
    genomes: np.ndarray      # (S, E) as scored, padding lanes included
    edge_u: np.ndarray
    edge_v: np.ndarray
    makespan: np.ndarray     # (S,) the card's, float32
    feasible: np.ndarray     # (S,)


@dataclass
class Span:
    name: str
    t0: float                # time.perf_counter()
    dur: float
    request: int


@dataclass
class Probe:
    request: int = -1
    batches: list[Batch] = field(default_factory=list)
    xbars: list[tuple[int, np.ndarray]] = field(default_factory=list)
    spans: list[Span] = field(default_factory=list)
    data: dict = field(default_factory=dict)    # readers' own records
    after_batch: list = field(default_factory=list)  # called as each
                                                     # batch returns
    _undo: list = field(default_factory=list)

    def wrap(self, owner, name: str, make) -> None:
        """Replace `owner.name` by `make(original)` until `restore`."""
        orig = getattr(owner, name)
        self._undo.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def timed(self, owner, name: str, label: str) -> None:
        """Record a span `label` around every call of `owner.name`."""
        probe = self

        def make(orig):
            def timed_call(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return orig(*args, **kw)
                finally:
                    probe.spans.append(Span(label, t0,
                                            time.perf_counter() - t0,
                                            probe.request))
            return timed_call
        self.wrap(owner, name, make)

    def restore(self) -> None:
        while self._undo:
            owner, name, orig = self._undo.pop()
            setattr(owner, name, orig)

    def record_outputs(self) -> None:
        """Keep what the timed path produced: the DES's batches and X̄."""
        from repro_torch.core import ga
        from repro_torch.core.des_torch import TorchDES
        probe = self

        def lanes(orig):
            def batch_genome_makespan(des, genomes, edge_u, edge_v,
                                      mask=None):
                ms, feas = orig(des, genomes, edge_u, edge_v, mask)
                probe.batches.append(Batch(
                    probe.request, np.array(genomes, dtype=np.int64),
                    np.array(edge_u, dtype=np.int64),
                    np.array(edge_v, dtype=np.int64), np.array(ms),
                    np.array(feas)))
                for hook in probe.after_batch:
                    hook()
                return ms, feas
            return batch_genome_makespan

        def bound(orig):
            def x_upper_bound(*args, **kw):
                xbar = orig(*args, **kw)
                probe.xbars.append((probe.request, np.array(xbar)))
                return xbar
            return x_upper_bound

        self.wrap(TorchDES, "batch_genome_makespan", lanes)
        self.wrap(ga, "x_upper_bound", bound)

    def time_host_layers(self) -> None:
        """Spans around Alg. 2 and the host's numpy DES (traced runs)."""
        from repro_torch.core import api, ga
        self.timed(ga, "x_upper_bound", "xbound")
        self.timed(api, "simulate", "host_des")
        self.timed(ga, "simulate", "host_des")
