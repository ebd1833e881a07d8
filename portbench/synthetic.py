"""Synthetic token batches, a frozen copy of the draws of the program's
``data/pipeline.py`` ``SyntheticLM`` (one process: the whole batch).

Every row is a pure function of (seed, step, row): a Zipf-like unigram
draw with a repeated 8-token motif, so a model's loss can fall.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0):
        self.vocab, self.seq_len, self.batch_rows = vocab, seq_len, batch
        self.seed = seed
        probs = 1.0 / np.arange(1, vocab + 1)
        self._probs = probs / probs.sum()

    def _row(self, step: int, row: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, row]))
        S, V = self.seq_len, self.vocab
        toks = rng.choice(V, size=(S + 1,), p=self._probs).astype(np.int32)
        motif = rng.integers(0, V, size=(8,), dtype=np.int32)
        for start in range(0, S - 8, max(16, S // 8)):
            toks[start:start + 8] = motif
        return toks

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """``{"tokens", "labels"}`` (batch, seq_len) int32: the labels are
        the tokens shifted by one."""
        toks = np.stack([self._row(step, b) for b in range(self.batch_rows)])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
