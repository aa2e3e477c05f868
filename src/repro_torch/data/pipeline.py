"""Deterministic synthetic data streams (counterpart of
`repro.data.pipeline`): each batch is a pure function of (seed, step), in
numpy, so a stream here gives the same batches as the reference's for the
same seed.  Only `ClickStream` (DeepFM) so far; the reference module
imports JAX, so its numpy code is copied rather than imported.
"""
from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np


class ClickStream:
    """Synthetic CTR batches for DeepFM: (fields (B,F) int32, labels (B,))."""

    def __init__(self, field_vocabs: Sequence[int], batch: int, seed: int = 0):
        self.field_vocabs = np.asarray(field_vocabs)
        self.batch, self.seed = batch, seed
        rng = np.random.default_rng(seed)
        self._w = rng.standard_normal(len(field_vocabs)) * 0.5

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        F = len(self.field_vocabs)
        fields = (rng.random((self.batch, F)) * self.field_vocabs).astype(np.int32)
        # learnable signal: label correlates with parity of a weighted sum
        z = ((fields % 7) * self._w).sum(axis=1)
        p = 1 / (1 + np.exp(-z + z.mean()))
        labels = (rng.random(self.batch) < p).astype(np.float32)
        return fields, labels

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
