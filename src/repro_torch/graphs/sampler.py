"""Fixed-fanout neighbour sampling (counterpart of `repro.graphs.sampler`),
what the `minibatch_lg` shape needs.

Layered fixed-fanout sampling à la GraphSAGE: for a batch of seed vertices
draw `fanout[0]` neighbours each, then `fanout[1]` neighbours of those, …
with replacement, masked for isolated vertices, so every shape is static.

The sampler holds the CSR on the graph's device, built there by a stable
sort (`device_csr`, the arrays of `graphs.graph.build_csr`).  Drawing and
sampling are separate: `NeighborSampler.draws` makes one uniform int32 in
[0, 2^31 - 1) per slot under the reference's key schedule (per hop `key,
sub = split(key)`, then `randint(sub, (B, f1, ..., fk), 0, 2^31 - 1)`,
through `core.prng`: the reference's integers bit for bit), and
`sample_draws` turns draws into layers and masks, a pure function of
(seeds, draws).  `sample(key, seeds)` is the two, the reference's
`NeighborSampler.sample`.  A block of rows of the batch draws its rows of
the global draw (`row0`, through the draws' start counter).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.graphs.graph import Graph

DRAW_HIGH = (1 << 31) - 1      # jnp.iinfo(jnp.int32).max, exclusive


def device_csr(g: Graph) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indptr (n+1,) int64, indices (E,) int32) on `g`'s device: the real
    half-edges by a stable sort on the sender, as `build_csr` orders them
    on the host."""
    s = g.senders[: g.n_edges]
    order = torch.sort(s, stable=True).indices
    indices = g.receivers[: g.n_edges][order]
    counts = torch.bincount(s, minlength=g.n_nodes)
    indptr = torch.zeros(g.n_nodes + 1, dtype=torch.int64, device=s.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return indptr, indices


def hop_draws(key: prng.Key, shape: Sequence[int], device, row0: int = 0) -> torch.Tensor:
    """One hop's draw of the rows from `row0` on of a global (R, *rest)
    draw: `randint(key, shape, 0, DRAW_HIGH)`, int32, where `shape` is
    (rows, *rest), from the counter row0 * prod(rest)."""
    per_row = int(np.prod(shape[1:], dtype=np.int64))
    return prng.randint(key, tuple(shape), 0, DRAW_HIGH, device, start=row0 * per_row)


def sample_neighbors(indptr: torch.Tensor, indices: torch.Tensor, frontier: torch.Tensor,
                     u: torch.Tensor, tables=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each frontier vertex, the neighbours at offsets u % degree of
    its CSR row, (frontier.shape + (fan,)), and where it has any.  With
    `tables` (a `dist.lookup.TableSplit`), `indices` is this rank's block
    of the whole array and the positions are read through `tables.take`."""
    f = frontier.long()
    start = indptr[f]
    deg = indptr[f + 1] - start
    offs = u.long() % torch.clamp(deg, min=1)[..., None]
    n = indices.shape[0] if tables is None else tables.rows(indices)
    pos = torch.clamp(start[..., None] + offs, max=n - 1)
    nbr = indices[pos] if tables is None else tables.take(indices, pos)
    return nbr, (deg[..., None] > 0).expand(nbr.shape)


@dataclasses.dataclass(frozen=True)
class SampledSubgraph:
    """Layered fixed-fanout sample.

    layers[k] has shape (batch, fanout[0], …, fanout[k-1]) of global vertex
    ids; masks[k] marks slots backed by a real neighbour.  layers[0] is the
    seed batch itself.
    """
    layers: Tuple[torch.Tensor, ...]
    masks: Tuple[torch.Tensor, ...]

    @property
    def batch(self) -> int:
        return int(self.layers[0].shape[0])


class NeighborSampler:
    """Uniform neighbour sampler over the CSR of `g`, on `g`'s device."""

    def __init__(self, g: Graph, fanout: Sequence[int]):
        self.indptr, self.indices = device_csr(g)
        self.fanout = tuple(int(f) for f in fanout)
        self.n_nodes = g.n_nodes

    def draws(self, key: prng.Key, batch: int, device=None, *, row0: int = 0
              ) -> Tuple[torch.Tensor, ...]:
        """The reference's draws for a batch of `batch` seeds (rows row0
        on of the global batch), on `device` (the CSR's by default): per
        hop `key, sub = split(key)`, then (batch, fanout[0], ...,
        fanout[k]) integers under `sub`."""
        device = self.indptr.device if device is None else device
        out, shape = [], (batch,)
        for f in self.fanout:
            key, sub = prng.split(key)
            shape = shape + (f,)
            out.append(hop_draws(sub, shape, device, row0))
        return tuple(out)

    def sample(self, key: prng.Key, seeds: torch.Tensor, *, row0: int = 0) -> SampledSubgraph:
        """The reference's `NeighborSampler.sample(key, seeds)`: seeds
        rows row0 on of the batch the key draws for."""
        return self.sample_draws(seeds, self.draws(key, seeds.shape[0], seeds.device,
                                                   row0=row0))

    def sample_draws(self, seeds: torch.Tensor, draws: Sequence[torch.Tensor]
                     ) -> SampledSubgraph:
        """The sample given the draws (`draws`, or the reference's)."""
        layers = [seeds]
        masks = [torch.ones(seeds.shape, dtype=torch.bool, device=seeds.device)]
        frontier, fmask = seeds, masks[0]
        for u in draws:
            nbr, has = sample_neighbors(self.indptr, self.indices, frontier, u)
            mask = has & fmask[..., None]
            nbr = torch.where(mask, nbr, 0)
            layers.append(nbr)
            masks.append(mask)
            frontier, fmask = nbr, mask
        return SampledSubgraph(layers=tuple(layers), masks=tuple(masks))


def aggregate_mean(child_feats: torch.Tensor, child_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the innermost fanout axis: (…, F, D) -> (…, D)."""
    w = child_mask[..., None].to(child_feats.dtype)
    s = (child_feats * w).sum(dim=-2)
    cnt = torch.clamp(w.sum(dim=-2), min=1.0)
    return s / cnt


def tree_edges(sub: SampledSubgraph):
    """Flatten a layered sample into (global_ids, node_mask, senders,
    receivers, edge_mask).

    Node slots are the union of all layers (seeds first); each sampled
    child slot contributes one directed edge child -> parent, the
    information flow of sampled-GraphSAGE training.  The flat form lets
    every GNN forward, which takes raw edge arrays, run unchanged on
    minibatches."""
    dev = sub.layers[0].device
    ids = [sub.layers[0].reshape(-1)]
    masks = [sub.masks[0].reshape(-1)]
    offsets = [0]
    total = ids[0].shape[0]
    for lay, msk in zip(sub.layers[1:], sub.masks[1:]):
        offsets.append(total)
        ids.append(lay.reshape(-1))
        masks.append(msk.reshape(-1))
        total += lay.numel()

    senders, receivers, emask = [], [], []
    for k in range(1, len(sub.layers)):
        child = sub.layers[k]
        fan = child.shape[-1]
        n_parents = child.numel() // fan
        senders.append(offsets[k] + torch.arange(n_parents * fan, dtype=torch.int32, device=dev))
        receivers.append(offsets[k - 1] + torch.arange(
            n_parents, dtype=torch.int32, device=dev).repeat_interleave(fan))
        emask.append(sub.masks[k].reshape(-1))
    return (torch.cat(ids), torch.cat(masks), torch.cat(senders), torch.cat(receivers),
            torch.cat(emask))
