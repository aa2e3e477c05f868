"""Tile-local retiling: apply an `EdgeDelta` without rebuilding the tiling
(counterpart of `repro.dyngraph.retile`; the same results, array for
array, with the tile payload edited on the tiling's device).

A delta touches only the tiles its endpoints land in.  `apply_delta`
edits exactly those:

  int8      byte edits: `tiles[t, u % T, v % T] = 0 | 1`.
  bitpack   word edits on the packed int32 words: each touched word is
            read once, ORed with (add) or ANDed with the complement of
            (remove) the bits the delta sets in it.  Tiles are never
            unpacked.

Fast path: every add lands in an existing tile and no remove drains one;
the payload is edited on a copy and `tile_rows`, `tile_cols` and
`row_starts` are the same tensors as before.  Structural path: the tile
keys (block-row · nbc + block-col) come to the host, new keys merge in
by one sort, each old tile is copied once into its merged slot on
the device, and drained tiles drop out; `row_starts` and the padding are
re-derived from the keys.  Either way the result equals
`build_block_tiles(apply_graph_delta(g, delta))`, its padding included,
and a partitioned tiling gets its partition rebuilt at the same
threshold, on the device (`partition_tiles`).

`apply_graph_delta` is the edge-list twin, on the device: the patched
graph is the canonical edge list a fresh `from_edges` of the mutated
graph gives, content hash included.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.tiling import (
    BlockTiledGraph,
    padded_tile_count,
    partition_tiles,
)
from repro_torch.device import to_torch
from repro_torch.dyngraph.delta import EdgeDelta, _pair_keys, sorted_unique
from repro_torch.graphs.graph import Graph

_BITS = 32


def _half_edges(pairs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(m, 2) canonical pairs → both directed half-edges (2m,) + (2m,)."""
    lo, hi = pairs[:, 0], pairs[:, 1]
    return np.concatenate([lo, hi]), np.concatenate([hi, lo])


def apply_graph_delta(g: Graph, delta: EdgeDelta) -> Graph:
    """Mutate the edge list with strict set semantics, on `g`'s device.
    Raises if a `remove` edge is absent or an `add` edge present.

    `g` holds both directions of every edge sorted by (sender, receiver),
    as `from_edges` leaves it, so its half-edge keys `sender·n + receiver`
    are sorted: membership is a binary search, and the result (kept keys
    and both directions of the adds, sorted) is the canonical edge list a
    fresh `from_edges` of the mutated graph gives, without a host round
    trip of the edge list."""
    delta.check_bounds(g.n_nodes)
    if delta.is_empty:
        return g
    n = g.n_nodes
    dev = g.device
    half = g.senders[: g.n_edges].long() * n + g.receivers[: g.n_edges].long()

    def member(keys: np.ndarray) -> np.ndarray:
        k = to_torch(keys, dev)
        at = torch.searchsorted(half, k).clamp(max=max(half.numel() - 1, 0))
        hit = half[at] == k if half.numel() else torch.zeros_like(k, dtype=torch.bool)
        return hit.cpu().numpy()

    missing = ~member(_pair_keys(delta.remove, n))
    if missing.any():
        u, v = delta.remove[missing.argmax()]
        raise ValueError(
            f"delta removes {int(missing.sum())} edge(s) not in the graph "
            f"(first: ({int(u)}, {int(v)})) — deltas are strict set mutations"
        )
    present = member(_pair_keys(delta.add, n))
    if present.any():
        u, v = delta.add[present.argmax()]
        raise ValueError(
            f"delta adds {int(present.sum())} edge(s) already in the graph "
            f"(first: ({int(u)}, {int(v)})) — deltas are strict set mutations"
        )

    rem_u, rem_v = _half_edges(delta.remove)
    add_u, add_v = _half_edges(delta.add)
    kept = half[~torch.isin(half, to_torch(rem_u * n + rem_v, dev))]
    keys, _ = torch.sort(torch.cat([kept, to_torch(add_u * n + add_v, dev)]))
    return Graph(senders=(keys // n).to(torch.int32), receivers=(keys % n).to(torch.int32),
                 n_nodes=n, n_edges=int(keys.numel()))


def _edit_tiles(
    tiles: torch.Tensor,
    tidx: np.ndarray,    # (k,) tile index per half-edge
    u: np.ndarray,       # (k,) row vertex ids
    v: np.ndarray,       # (k,) column vertex ids
    T: int,
    *,
    set_bit: bool,
) -> None:
    """In-place cell edits on the device, either storage (by dtype).

    Packed words: the edits are grouped by word on the host (the OR of the
    bits each word takes), then each touched word is read, edited and
    written once, so edits that share a word never race."""
    if not tidx.size:
        return
    dev = tiles.device
    rloc, cloc = u % T, v % T
    if tiles.dtype == torch.int32:   # bitpack
        W = tiles.shape[-1]
        flat = (tidx.astype(np.int64) * T + rloc) * W + cloc // _BITS
        cell = sorted_unique(flat * _BITS + cloc % _BITS)   # sorted by word
        word = cell // _BITS
        bits = np.left_shift(np.uint32(1), (cell % _BITS).astype(np.uint32))
        starts = np.flatnonzero(np.r_[True, word[1:] != word[:-1]])
        idx = to_torch(word[starts], dev)
        mask = to_torch(np.bitwise_or.reduceat(bits, starts), dev)   # int32 bits
        view = tiles.view(-1)
        cur = view[idx]
        view[idx] = (cur | mask) if set_bit else (cur & ~mask)
    else:
        index = tuple(to_torch(a.astype(np.int64), dev) for a in (tidx, rloc, cloc))
        tiles.index_put_(index, torch.tensor(1 if set_bit else 0, dtype=tiles.dtype,
                                             device=dev))


def _drained(tiles: torch.Tensor, touched: np.ndarray) -> np.ndarray:
    """The tiles among `touched` (host indices) that hold no edge now."""
    if not touched.size:
        return touched
    held = tiles[to_torch(touched, tiles.device)].reshape(touched.size, -1)
    return touched[~(held != 0).any(dim=1).cpu().numpy()]


def _repartition(old: BlockTiledGraph, out: BlockTiledGraph) -> BlockTiledGraph:
    """A delta can move a tile across the nnz threshold either way, and the
    dense partition holds copies of edited tiles: a partitioned input gets
    its partition rebuilt over the edited tile list, at its threshold, on
    the device.  The plan-level "auto" gate is `api.plan.patch_plan`'s."""
    if old.partition is None:
        return out
    return dataclasses.replace(
        out, partition=partition_tiles(out, old.partition.threshold)
    )


def apply_delta(tiled: BlockTiledGraph, delta: EdgeDelta) -> BlockTiledGraph:
    """Repack only the touched tiles of a `BlockTiledGraph`.

    The result equals `build_block_tiles(apply_graph_delta(g, delta))`
    array for array.  Trusts its delta (bounds and strictness are
    `apply_graph_delta`'s checks, which `api.plan.patch_plan` runs first on
    the same canonical batch)."""
    delta.check_bounds(tiled.n_nodes)
    if delta.is_empty:
        return tiled
    T = tiled.tile_size
    nbc = tiled.n_block_cols
    nt = tiled.n_tiles
    dev = tiled.device

    rows_np = tiled.tile_rows[:nt].cpu().numpy()
    cols_np = tiled.tile_cols[:nt].cpu().numpy()
    tile_keys = rows_np.astype(np.int64) * nbc + cols_np   # sorted (row-major)

    add_u, add_v = _half_edges(delta.add)
    rem_u, rem_v = _half_edges(delta.remove)
    add_keys = (add_u // T) * np.int64(nbc) + (add_v // T)
    rem_keys = (rem_u // T) * np.int64(nbc) + (rem_v // T)

    new_keys = sorted_unique(add_keys)
    new_keys = new_keys[~np.isin(new_keys, tile_keys, assume_unique=True)]
    if new_keys.size == 0:
        # fast path: every edit lands in an existing tile
        stored = tiled.tiles.clone()
        ridx = np.searchsorted(tile_keys, rem_keys)
        _edit_tiles(stored, ridx, rem_u, rem_v, T, set_bit=False)
        _edit_tiles(stored, np.searchsorted(tile_keys, add_keys), add_u, add_v, T,
                    set_bit=True)
        drained = _drained(stored, sorted_unique(ridx))
        if drained.size == 0:
            return _repartition(tiled, dataclasses.replace(tiled, tiles=stored))
        keep = np.ones(nt, bool)
        keep[drained] = False
        return _repartition(tiled, _rebuild_index(
            tiled, stored[:nt][to_torch(keep, dev)], tile_keys[keep]))

    # structural path: merge new (zero) tiles into the sorted list
    merged_keys = np.sort(np.concatenate([tile_keys, new_keys]))   # disjoint
    n_merged = int(merged_keys.shape[0])
    merged = torch.zeros((n_merged,) + tuple(tiled.tiles.shape[1:]),
                         dtype=tiled.tiles.dtype, device=dev)
    old_pos = np.searchsorted(merged_keys, tile_keys)
    merged.index_copy_(0, to_torch(old_pos, dev), tiled.tiles[:nt])
    rem_idx = np.searchsorted(merged_keys, rem_keys)
    _edit_tiles(merged, rem_idx, rem_u, rem_v, T, set_bit=False)
    _edit_tiles(merged, np.searchsorted(merged_keys, add_keys), add_u, add_v, T,
                set_bit=True)
    drained = _drained(merged, sorted_unique(rem_idx))
    if drained.size:
        keep = np.ones(n_merged, bool)
        keep[drained] = False
        merged, merged_keys = merged[to_torch(keep, dev)], merged_keys[keep]
    return _repartition(tiled, _rebuild_index(tiled, merged, merged_keys))


def _rebuild_index(
    tiled: BlockTiledGraph, tiles: torch.Tensor, keys: np.ndarray
) -> BlockTiledGraph:
    """Rows, cols, `row_starts` and the pad-to-8 zero tiles from a sorted
    real-tile list (the structural path's O(n_tiles) tail, no edge
    scatter)."""
    nbc = tiled.n_block_cols
    dev = tiled.device
    n_real = int(tiles.shape[0])
    rows = (keys // nbc).astype(np.int32)
    cols = (keys % nbc).astype(np.int32)
    counts = np.bincount(rows, minlength=tiled.n_block_rows)
    row_starts = np.zeros(tiled.n_block_rows + 1, dtype=np.int32)
    np.cumsum(counts, out=row_starts[1:])

    target = padded_tile_count(n_real)
    last_row = rows[-1] if n_real else np.int32(0)
    # an empty tiling stores zero tiles at (0, 0), as `build_block_tiles`
    pad = target - n_real
    tiles = torch.cat([tiles, torch.zeros((pad,) + tuple(tiles.shape[1:]),
                                          dtype=tiles.dtype, device=dev)])
    rows = np.concatenate([rows, np.full(pad, last_row, np.int32)])
    cols = np.concatenate([cols, np.zeros(pad, np.int32)])
    return dataclasses.replace(
        tiled,
        tiles=tiles,
        tile_rows=to_torch(rows, dev),
        tile_cols=to_torch(cols, dev),
        row_starts=to_torch(row_starts, dev),
        n_tiles=n_real,
    )
