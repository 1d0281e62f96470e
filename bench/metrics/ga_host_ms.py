"""ga_host_ms.<mix>: the GA driver's own host time per generation
(selection, variation, repair, dedup and cache), each `ga.generation`
span less the `ga.fitness_batch` spans inside it, in ms."""
import numpy as np


def read(run):
    gens = run.span_records("ga.generation")
    if not gens:
        return None
    batches = sorted(run.span_records("ga.fitness_batch"), key=lambda s: s[1])
    t0 = np.array([b[1] for b in batches])
    dur = np.concatenate([[0.0], np.cumsum([b[2] for b in batches])])
    own = 0.0
    for _, g0, gdur in gens:
        a, b = np.searchsorted(t0, [g0, g0 + gdur])
        own += gdur - (dur[b] - dur[a])
    return 1e3 * own / len(gens)
