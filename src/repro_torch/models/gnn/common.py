"""Shared GNN substrate (counterpart of `repro.models.gnn.common`): the MLP,
the masked segment reductions and the message-passing primitive.

The reference keeps an MLP as weights `ws[i]` of shape (in, out) applied as
`x @ w + b`; here each layer is an `nn.Linear`, whose weight is (out, in),
so carried weights are transposed (`models.gnn.gnn_params_from_numpy`,
`models.deepfm.deepfm_params_from_numpy`).

Message passing runs over raw edge arrays (senders, receivers, mask), as in
the reference, so one forward serves full graphs, block-diagonal molecule
batches and sampled trees.  The segment ops follow `jax.ops.segment_sum` /
`segment_max` with `num_segments`: every id must lie in [0, num_segments)
(callers route masked edges to vertex 0, as the reference's cells do), an
empty segment sums to 0 and its max is -inf.

A full graph split over ranks (`dist.graph.GraphSplit`, the models'
`split=`) runs the same ops over a rank's vertex block and the edges into
it: the segment ops take its local receivers and block size, and what an
edge reads of its sender comes from the rows gathered from every rank.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import prng
from repro_torch.device import DeviceLike, resolve_device

Activation = Callable[[torch.Tensor], torch.Tensor]


class MLP(nn.Module):
    """f32 linear layers with `act` between them and none after the last
    (SiLU by default, as the reference's `mlp_apply`).  Initialised as the
    reference's `mlp_init(key, dims)`: layer i's weight under the i-th key
    of `split(key, len(dims) - 1)`, drawn (in, out) as the reference holds
    it, times the He scale (2 / in)^0.5, and stored transposed; biases
    zero."""

    def __init__(self, dims: Sequence[int], *, key: prng.Key, device: DeviceLike = "cuda",
                 act: Activation = F.silu):
        super().__init__()
        dev = resolve_device(device)
        self.act = act
        self.layers = nn.ModuleList()
        for k, i, o in zip(prng.split(key, len(dims) - 1), dims[:-1], dims[1:]):
            # shapes on "meta", then the drawn parameters: `nn.utils.skip_init`'s
            # `to_empty` imports torch's symbolic-shape machinery (sympy) the first
            # time a process calls it, seconds on the card's host
            layer = nn.Linear(i, o, device="meta")
            w = prng.normal(k, (i, o), dev) * (2.0 / i) ** 0.5
            layer.weight = nn.Parameter(w.T.contiguous())
            layer.bias = nn.Parameter(torch.zeros(o, device=dev))
            self.layers.append(layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *hidden, last = self.layers
        for layer in hidden:
            x = self.act(layer(x))
        return last(x)


def segment_sum(x: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Σ of the rows of `x` by `segment_ids` into `num_segments` rows."""
    out = x.new_zeros((num_segments,) + tuple(x.shape[1:]))
    return out.index_add(0, segment_ids.long(), x)


def segment_max(x: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Max of the rows of `x` by `segment_ids`; -inf where a segment is
    empty.  Ties share the gradient evenly, as jax's scatter-max does."""
    idx = segment_ids.long().view((-1,) + (1,) * (x.ndim - 1)).expand_as(x)
    out = x.new_full((num_segments,) + tuple(x.shape[1:]), float("-inf"))
    return out.scatter_reduce(0, idx, x, "amax")


def segment_mean(x: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean of the (masked-in) rows of `x` by segment; 0 where none."""
    if mask is not None:
        x = torch.where(mask[..., None], x, 0)
        ones = mask.to(x.dtype)
    else:
        ones = x.new_ones(x.shape[:-1])
    s = segment_sum(x, segment_ids, num_segments)
    cnt = segment_sum(ones, segment_ids, num_segments)
    return s / torch.clamp(cnt, min=1.0)[..., None]


def gather_scatter_sum(h: torch.Tensor, senders: torch.Tensor, receivers: torch.Tensor,
                       mask: torch.Tensor, n_nodes: int, split=None) -> torch.Tensor:
    """Σ_{j∈N(i)} h_j, the canonical message-passing primitive.  With
    `split` (a `dist.graph.GraphSplit`), h holds this rank's vertex rows,
    the senders read the rows gathered from every rank and the receivers
    and `n_nodes` are the rank's own."""
    src = h if split is None else split.gather(h)
    msg = torch.where(mask[:, None], src[senders.long()], 0)
    return segment_sum(msg, receivers, n_nodes)


def degrees_from_edges(receivers: torch.Tensor, mask: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """(n_nodes,) f32 count of masked-in edges into each vertex."""
    return segment_sum(mask.to(torch.float32), receivers, n_nodes)
