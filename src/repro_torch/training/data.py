"""Deterministic synthetic data pipeline (the reference's
`repro.training.data`, numpy only: the same arrays byte for byte).

Restart-safe by construction: batch(step) is a pure function of
(seed, step), so a resumed job consumes exactly the token stream it would
have seen without the failure (no state to checkpoint beyond the step
counter).  The token process is a noisy affine recurrence, so a real
language model can actually learn it (training-loss decrease is asserted
in tests and demonstrated by `repro_torch.examples.train_lm`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seed: int = 0
    noise: float = 0.05
    mult: int = 31
    offset: int = 17

    def batch(self, step: int, batch_size: int, seq_len: int,
              xkv_shape: tuple | None = None) -> dict:
        rng = np.random.default_rng((self.seed, step))
        x0 = rng.integers(0, self.vocab, size=batch_size)
        toks = np.empty((batch_size, seq_len + 1), dtype=np.int32)
        toks[:, 0] = x0
        for t in range(seq_len):
            nxt = (toks[:, t] * self.mult + self.offset) % self.vocab
            flip = rng.random(batch_size) < self.noise
            nxt = np.where(flip,
                           rng.integers(0, self.vocab, size=batch_size),
                           nxt)
            toks[:, t + 1] = nxt
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if xkv_shape is not None:
            batch["xkv"] = rng.standard_normal(
                (batch_size, *xkv_shape), dtype=np.float32)
        return batch

    def with_seed(self, seed: int) -> "SyntheticLM":
        return dataclasses.replace(self, seed=seed)
