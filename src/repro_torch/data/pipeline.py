"""Deterministic synthetic data streams (counterpart of
`repro.data.pipeline`): each batch is a pure function of (seed, step), in
numpy, so a stream here gives the same batches as the reference's for the
same seed, and a restart that seeks to step k resumes the same sequence.
`TokenStream` (LM batches), `ClickStream` (DeepFM), `GraphBatchStream`
(molecule batches for the GNNs) and `prefetch`, a background thread that
buffers a stream ahead of its consumer.  The reference module imports JAX,
so its numpy code is copied rather than imported.  `shard_batch` places a
host batch on a mesh (the distributed input feeding).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence, Tuple

import numpy as np


class TokenStream:
    """Synthetic LM batches: (tokens (B,S) int32, targets (B,S) int32).

    A cheap Markov-ish mixture (unigram + shifted copy) so the loss is
    learnable: a pure-uniform stream gives a flat loss and hides optimizer
    bugs.
    """

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        base = rng.integers(0, self.vocab, (self.batch, self.seq + 1))
        # copy structure: token t+1 = token t + 1 (mod V) half the time
        copy = (np.roll(base, 1, axis=1) + 1) % self.vocab
        use = rng.random((self.batch, self.seq + 1)) < 0.5
        toks = np.where(use, copy, base).astype(np.int32)
        return toks[:, :-1], toks[:, 1:].astype(np.int32)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


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


class GraphBatchStream:
    """Batched small molecules with static shapes: (feats (B,N,d) f32,
    coords (B,N,3) f32, senders (B,E) int32, receivers (B,E) int32, mask
    (B,E) bool, energy (B,) f32).  Edges are drawn with replacement; a
    self-loop is masked out.  The target energy is a smooth invariant: the
    sum of the masked-in edges' lengths."""

    def __init__(self, batch: int, n_nodes: int = 30, n_edges: int = 64,
                 d_feat: int = 16, seed: int = 0):
        self.batch, self.n_nodes, self.n_edges = batch, n_nodes, n_edges
        self.d_feat, self.seed = d_feat, seed

    def batch_at(self, step: int):
        rng = np.random.default_rng((self.seed, step))
        B, N, E = self.batch, self.n_nodes, self.n_edges
        coords = rng.standard_normal((B, N, 3)).astype(np.float32)
        feats = rng.standard_normal((B, N, self.d_feat)).astype(np.float32)
        senders = rng.integers(0, N, (B, E)).astype(np.int32)
        receivers = rng.integers(0, N, (B, E)).astype(np.int32)
        mask = (senders != receivers)
        d = np.linalg.norm(
            coords[np.arange(B)[:, None], senders]
            - coords[np.arange(B)[:, None], receivers],
            axis=-1,
        )
        energy = (d * mask).sum(axis=1).astype(np.float32)
        return feats, coords, senders, receivers, mask, energy

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def prefetch(it: Iterator, size: int = 2) -> Iterator:
    """The items of `it`, in order, produced up to `size` ahead by a
    background thread (double buffering by default)."""
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item


def shard_batch(batch, mesh, spec):
    """A host batch (a tree of arrays or tensors, the same on every rank:
    the streams are seeded) placed on `mesh` under `spec` (a
    `dist.sharding.P`, e.g. `batch_spec(mesh, 1)`): every rank keeps the
    block of its mesh coordinate on its device, as a DTensor."""
    import torch

    from repro_torch.dist.sharding import Sharding, mesh_device
    from repro_torch.train import tree as T

    dev = mesh_device(mesh)
    sharding = Sharding(mesh, spec)
    return T.tree_map(lambda x: sharding.place(torch.as_tensor(x), dev), batch)
