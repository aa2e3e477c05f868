"""Edge-list (segment) neighbourhood operators (counterpart of the segment
half of `repro.core.spmv`): gather by sender, reduce by receiver into
`n_nodes + 1` slots, drop the sentinel slot.

Fills match the reference's `jax.ops.segment_*`: a vertex with no edges
gets int32 min (the `segment_max` identity); a vertex whose neighbours are
all masked gets `_NEG`.
"""
from __future__ import annotations

import torch

from repro_torch.graphs.graph import Graph

_NEG = -(1 << 30)
INT32_MIN = -(1 << 31)


def _gather(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """x[senders] for an (n_nodes,) vector; sentinel rows read vertex 0 and
    are masked by the caller."""
    if x.shape[0] == 0:
        return x.new_zeros(g.e_pad)
    return x[g.senders_gather]


def neighbor_sum_segment(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """N_c(v) = Σ_{u∈N(v)} x(u)."""
    contrib = torch.where(g.edge_mask, _gather(g, x), 0).to(x.dtype)
    out = x.new_zeros(g.n_nodes + 1)
    return out.index_add_(0, g.receivers_long, contrib)[: g.n_nodes]


def _segment_max(rows: torch.Tensor, contrib: torch.Tensor, n_slots: int,
                 fill: int = INT32_MIN) -> torch.Tensor:
    """Max of `contrib` at its int64 `rows` into `n_slots` slots; an empty
    slot reads `fill` (`jax.ops.segment_max`'s identity by default)."""
    out = torch.full((n_slots,), fill, dtype=contrib.dtype, device=contrib.device)
    return out.scatter_reduce_(0, rows, contrib, "amax")


def neighbor_max_segment(g: Graph, p: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Max_Np(v) = max_{u∈N(v), mask(u)} p(u); `_NEG` where no live
    neighbour, int32 min where no neighbour at all."""
    live = g.edge_mask & _gather(g, mask)
    contrib = torch.where(live, _gather(g, p), _NEG).to(torch.int32)
    return _segment_max(g.receivers_long, contrib, g.n_nodes + 1)[: g.n_nodes]


def neighbor_any_segment(g: Graph, flag: torch.Tensor) -> torch.Tensor:
    """Does v have a neighbour with `flag` set?"""
    contrib = (g.edge_mask & _gather(g, flag)).to(torch.int32)
    return _segment_max(g.receivers_long, contrib, g.n_nodes + 1)[: g.n_nodes] > 0
