"""Neighbourhood operators (counterpart of `repro.core.spmv`).

* the segment path (`*_segment`): gather by sender, reduce by receiver
  into `n_nodes + 1` slots, drop the sentinel slot.  Fills match the
  reference's `jax.ops.segment_*`: a vertex with no edges gets int32 min
  (the `segment_max` identity); a vertex whose neighbours are all masked
  gets `_NEG`.
* the tiled path (`spmv_tiled`, `neighbor_max_tiled`): the BSR tile
  schedule, `backend="ref"` as plain torch, `backend="pallas"` (the
  reference's name for its kernel path, kept so its callers port
  unchanged) through the Hopper kernels on CUDA tensors and their plain
  versions on CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.graphs.graph import Graph

BACKENDS = ("ref", "pallas")

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


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; valid: {BACKENDS}")


def spmv_tiled(tiled, rhs: torch.Tensor, *, backend: str = "ref",
               col_flags: torch.Tensor | None = None) -> torch.Tensor:
    """N = A @ rhs over the BSR tiles: rhs (n_block_cols·T, L), col_flags
    (n_block_cols,) int32 or None (a gated column adds nothing on any
    lane); returns (n_block_rows·T, L) float32.  "ref": `tile_spmv`;
    "pallas": `hopper.tc_spmv`."""
    _check_backend(backend)
    if backend == "pallas":
        from repro_torch.hopper.tc_spmv import tc_spmv

        return tc_spmv(tiled, rhs, col_flags=col_flags)
    from repro_torch.core.engine import tile_spmv

    return tile_spmv(tiled.tiles, tiled.tile_rows, tiled.tile_cols, rhs,
                     tiled.n_block_rows, tiled.tile_size, col_flags=col_flags)


def neighbor_max_tiled(tiled, p: torch.Tensor, mask: torch.Tensor, *,
                       backend: str = "ref") -> torch.Tensor:
    """Tiled phase ①: per row, the max of `p` over neighbours with `mask`
    set; p, mask (n_padded,), returns (n_padded,) int32.  "ref":
    `tile_neighbor_max` (its floor rule); "pallas": `hopper.tc_neighbor_max`
    (every covered row floored at `_NEG`, as the Pallas kernel)."""
    _check_backend(backend)
    if backend == "pallas":
        from repro_torch.hopper.tc_neighbor_max import tc_neighbor_max

        return tc_neighbor_max(tiled, p, mask)
    from repro_torch.core.engine import tile_neighbor_max

    return tile_neighbor_max(tiled.tiles, tiled.tile_rows, tiled.tile_cols,
                             torch.where(mask, p, _NEG), tiled.n_block_rows,
                             tiled.tile_size)
