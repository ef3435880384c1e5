"""Deterministic synthetic LM data pipeline.

Produces structured pseudo-language (Zipfian unigrams + bigram transitions +
copy motifs) so small models have real signal to learn — loss decreases
measurably within a few hundred steps, unlike uniform-random tokens.

Deterministic + seekable: the stream is a pure function of (seed, step), so
resuming from a checkpoint cursor reproduces the exact batch sequence — the
fault-tolerance property large jobs need.  Prefetch: a one-slot background
thread hides generation latency behind the train step.

The counterpart of ``repro.data.pipeline``, numpy only: ``batch_at`` is the
same code, so both packages draw the same batches; ``make_batch_specs``
(JAX shape structs for lowering) has no counterpart here.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    n_codebooks: int = 0
    zipf_a: float = 1.2

    def batch_at(self, step: int) -> dict:
        """Pure function of (seed, step) — the seekable cursor."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        shape = (self.batch, self.seq_len)
        if self.n_codebooks:
            shape = shape + (self.n_codebooks,)
        # Zipfian unigrams (bounded to vocab).
        toks = rng.zipf(self.zipf_a, size=shape)
        toks = np.minimum(toks - 1, self.vocab - 1)
        # Deterministic bigram structure: every even position continues a
        # fixed permutation chain of its predecessor (learnable signal).
        perm_rng = np.random.default_rng(self.seed)
        perm = perm_rng.permutation(self.vocab)
        if self.n_codebooks:
            toks[:, 1::2, :] = perm[toks[:, 0::2, :][
                :, : toks[:, 1::2, :].shape[1]]]
        else:
            toks[:, 1::2] = perm[toks[:, 0::2][:, : toks[:, 1::2].shape[1]]]
        return {"tokens": toks.astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """One-slot background prefetch (overlap host datagen with device step)."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step

        def worker():
            s = start_step
            while not self._stop.is_set():
                b = source.batch_at(s)
                try:
                    self._q.put((s, b), timeout=0.5)
                    s += 1
                except queue.Full:
                    continue

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def next(self) -> tuple[int, dict]:
        return self._q.get()

    def stop(self):
        self._stop.set()
