"""Faults planted in the program, for the checks' own tests and for the
upper readings of the numbers no lower precision reaches.

Each fault is a `Probe.wrap` of one name of the program (undone with the
probe), planted before the run records anything:

  answer_altered  the GA's exact re-rank returns the worst finite genome
                  it scored instead of the best: the plan's answer altered
                  where it is produced
  half_batch      the DES simulates the first half of each fitness batch
                  and hands its results to the second half too
  rates_stale     every rate step of an engine returns the rates of its
                  first trip: a step that leaves its state unchanged
"""
from __future__ import annotations

import numpy as np


def answer_altered(probe) -> None:
    from repro_torch.core import ga

    def make(orig):
        def worst_rerank(fit, best_g, score_of, port_weight, top=8):
            finite = [(v, k) for k, v in fit.cache.items() if np.isfinite(v)]
            if not finite:
                return orig(fit, best_g, score_of, port_weight, top)
            return np.frombuffer(max(finite)[1], dtype=np.int64)
        return worst_rerank
    probe.wrap(ga, "_exact_rerank", make)


def half_batch(probe) -> None:
    from repro_torch.core.des_torch import TorchDES

    def make(orig):
        def halved(des, genomes, edge_u, edge_v, mask=None):
            g = np.asarray(genomes)
            half = max(len(g) // 2, 1)
            ms, feas = orig(des, np.concatenate([g[:half], g[:len(g) - half]]),
                            edge_u, edge_v, mask)
            return (np.concatenate([ms[:half], ms[:len(g) - half]]),
                    np.concatenate([feas[:half], feas[:len(g) - half]]))
        return halved
    probe.wrap(TorchDES, "batch_genome_makespan", make)


def rates_stale(probe) -> None:
    from repro_torch.core import des_torch

    def make(orig):
        def stale_step(a, backend):
            step, first = orig(a, backend), []

            def rates(active, caps):
                if not first:
                    first.append(step(active, caps))
                return first[0]
            return rates
        return stale_step
    probe.wrap(des_torch, "_rate_step", make)


FAULTS = {"answer_altered": answer_altered, "half_batch": half_batch,
          "rates_stale": rates_stale}
