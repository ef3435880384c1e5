"""The token stream, frozen: a copy of ``SyntheticLM.batch_at`` from
``src/repro_torch/data/pipeline.py`` (the launcher's data, a pure numpy
function of (seed, step)), so that the reference rebuilds every batch the
program trained on without reading the program."""
from __future__ import annotations

from dataclasses import dataclass

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
        """Pure function of (seed, step): Zipfian unigrams with every odd
        position the image of its predecessor under a fixed permutation."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        shape = (self.batch, self.seq_len)
        if self.n_codebooks:
            shape = shape + (self.n_codebooks,)
        toks = rng.zipf(self.zipf_a, size=shape)
        toks = np.minimum(toks - 1, self.vocab - 1)
        perm_rng = np.random.default_rng(self.seed)
        perm = perm_rng.permutation(self.vocab)
        if self.n_codebooks:
            toks[:, 1::2, :] = perm[toks[:, 0::2, :][
                :, : toks[:, 1::2, :].shape[1]]]
        else:
            toks[:, 1::2] = perm[toks[:, 0::2][:, : toks[:, 1::2].shape[1]]]
        return {"tokens": toks.astype(np.int32)}
