"""Deterministic synthetic token pipeline with host sharding + prefetch
(port of ``repro.data.pipeline``: the same draws, numpy only).

Every batch row is a pure function of (seed, step, global row index), so:
(a) restarts reproduce the exact stream with no data-state checkpointing
beyond the step counter, (b) each process generates only its slice (host
sharding by the process rank of ``distributed.backend``; on a 1-process
runtime that is the whole batch), and the K-process global batch is
bitwise-equal to the 1-process one, (c) a background thread keeps
``prefetch`` batches ahead of the training loop.

The token distribution is a mixture of Zipf-like unigram draws and repeated
n-gram motifs so that a small LM's loss actually decreases (pure-uniform
tokens give a flat loss — useless for the convergence tests)."""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.distributed import backend as _backend


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, frames_dim: Optional[int] = None,
                 embeds_len: int = 0, embeds_dim: Optional[int] = None):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.frames_dim = frames_dim
        self.embeds_len = embeds_len
        self.embeds_dim = embeds_dim
        n_proc = _backend.process_count()
        if global_batch % n_proc:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {n_proc} processes")
        self.host_batch = global_batch // n_proc
        self.host_offset = _backend.process_rank() * self.host_batch
        # Zipf-ish unigram distribution (shared across rows)
        probs = 1.0 / np.arange(1, vocab + 1)
        self._probs = probs / probs.sum()

    def _row(self, step: int, row: int):
        """One *global* batch row: a pure function of (seed, step, global
        row index) — invariant to process count, so K processes each
        stacking their own row range reproduce the 1-process batch
        bitwise."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, row]))
        S, V = self.seq_len, self.vocab
        toks = rng.choice(V, size=(S + 1,), p=self._probs).astype(np.int32)
        # inject a repeated motif (learnable structure)
        motif = rng.integers(0, V, size=(8,), dtype=np.int32)
        for start in range(0, S - 8, max(16, S // 8)):
            toks[start:start + 8] = motif
        frames = embeds = None
        if self.frames_dim:
            frames = rng.standard_normal(
                (S, self.frames_dim)).astype(np.float32) * 0.02
        if self.embeds_len:
            embeds = rng.standard_normal(
                (self.embeds_len, self.embeds_dim)).astype(np.float32) * 0.02
        return toks, frames, embeds

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rows = [self._row(step, self.host_offset + b)
                for b in range(self.host_batch)]
        toks = np.stack([r[0] for r in rows])
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.frames_dim:
            out["frames"] = np.stack([r[1] for r in rows])
        if self.embeds_len:
            out["embeds"] = np.stack([r[2] for r in rows])
        return out

    def iterator(self, start_step: int = 0, prefetch: int = 2
                 ) -> Iterator[Dict[str, np.ndarray]]:
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            s = start_step
            while not stop.is_set():
                q.put(self.batch(s))
                s += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
