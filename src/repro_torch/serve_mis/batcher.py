"""Block-diagonal multi-graph packing: one solve, many graphs (counterpart
of `repro.serve_mis.batcher`).

Small-graph MIS requests cost launches and host round trips, not compute,
so `Solver.solve_many` runs one convergence loop over a whole batch.  The
packing concatenates cached plans block-diagonally:

* every member's vertex range is padded to whole T-blocks before it is
  offset, so no tile spans two graphs and each member's neighbourhoods
  are untouched;
* priorities are each member's own (its own key and degree
  statistics: Eq. 1's d̄ is a per-graph mean), placed at its offset, so
  each slot's rounds are those of a solo solve of the member with the
  same priorities: the batch returns every member's solo MIS and rounds;
* padding-slot vertices start dead (`alive0`) and the static `col_gate`
  pins their block-columns off for the engines' empty-C tile skip, so the
  kernels take column flags that the gate zeroes;
* shapes are rounded to a `Bucket` (powers of two over blocks, tiles and
  edges), as the reference rounds them, so the tile arrays and
  `signature()` equal the reference's.  The port compiles no per-shape
  program, so the containers declare their real counts: `batch.g` holds
  the real half-edges only (a sentinel edge would scatter into a segment
  slot torch keeps, and millions of them serialise on its atomics), and
  `batch.tiled.n_tiles` counts the real tiles before the bucket's
  all-zero padding tiles, pinned to the last real block-row.

Validate per member on its plan graph, never on `batch.g`.  Tiles
concatenate from the plan cache on the device: a batch never re-tiles a
member.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.heuristics import Priorities, make_priorities
from repro_torch.core.prng import Key
from repro_torch.core.spmv import _NEG
from repro_torch.core.tiling import BlockTiledGraph, next_pow2, partition_tiles
from repro_torch.device import to_torch
from repro_torch.graphs.graph import Graph
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve_mis.planner import TilePlan


class Bucket(NamedTuple):
    """Shape class of a packed batch (the reference's compile key)."""
    tile_size: int
    n_blocks: int      # total block rows/cols (incl. empty trailing slots)
    n_tiles_pad: int   # padded stored-tile count
    e_pad: int         # padded half-edge count
    storage: str = "int8"   # tile storage format (members must agree)


def bucket_for(plans: Sequence[TilePlan], tile_size: int) -> Bucket:
    """Smallest bucket that fits `plans` (powers of two per dimension)."""
    blocks = sum(p.n_blocks for p in plans)
    tiles = sum(p.tiled.n_tiles for p in plans)
    edges = sum(p.g.n_edges for p in plans)
    return Bucket(
        tile_size=int(tile_size),
        n_blocks=next_pow2(max(blocks, 1)),
        n_tiles_pad=next_pow2(max(tiles, 8)),
        e_pad=next_pow2(max(edges, 8)),
        storage=plans[0].tiled.storage if plans else "int8",
    )


def request_key(base_key: Key, plan: TilePlan) -> Key:
    """A member's own key, folded from `base_key` and the graph's content
    (`plan.graph_key`, the build-parameter-free hash), so its priorities
    depend on neither its batch, nor its slot, nor the arrival order, nor
    the plan's tile size or storage: the int8 and bitpack plans of one
    graph draw alike.  The reference's `request_key`, bit for bit."""
    return prng.fold_in(base_key, int(plan.graph_key[:8], 16) & 0x7FFFFFFF)


# Priorities by plan content hash.  Bounded FIFO: priority vectors are
# small beside plans, but a stream of distinct graphs must not grow without
# limit.
PriorityCache = Dict[str, Priorities]
PRIORITY_CACHE_CAP = 4096


def member_priorities(
    plan: TilePlan,
    key: Key,
    heuristic: str,
    cache: Optional[PriorityCache] = None,
) -> Priorities:
    """One member's priorities, through `cache` when given (keyed by the
    plan's content hash: a cache serves one base key and heuristic, and
    callers with their own keys pass none).  A hit skips the
    degrees and the draw."""
    if cache is not None and plan.key in cache:
        obs_metrics.counter("batcher.priority_cache.hits").inc()
        return cache[plan.key]
    if cache is not None:
        obs_metrics.counter("batcher.priority_cache.misses").inc()
    pri = make_priorities(heuristic, key, plan.n_nodes, plan.g.degrees())
    if cache is not None:
        cache[plan.key] = pri
        while len(cache) > PRIORITY_CACHE_CAP:
            del cache[next(iter(cache))]   # FIFO (dicts keep insertion order)
    return pri


def _padded_tail_len(sp_nnz: int) -> int:
    """The reference's sentinel-padded COO tail length, the length its
    signature names (the port keeps the real entries only)."""
    return next_pow2(max(int(sp_nnz), 8))


@dataclasses.dataclass(frozen=True)
class PackedBatch:
    """A block-diagonal batch, ready for one `run_tc_mis`."""
    g: Graph                    # block-diagonal graph, real half-edges only
    tiled: BlockTiledGraph
    priorities: Priorities      # (n_blocks·T,), _NEG in padding slots
    alive0: torch.Tensor        # (n_blocks·T,) bool, False in padding slots
    col_gate: torch.Tensor      # (n_blocks,) int32 real-vertex occupancy
    offsets: tuple              # member vertex offsets (multiples of T)
    sizes: tuple                # member real vertex counts
    bucket: Bucket
    n_real_edges: int = 0
    n_real_tiles: int = 0

    def signature(self) -> str:
        """The reference's shape-class id: the bucket, whether H3's resolve
        key rides along, and a partition's threshold and padded list
        sizes; the storage last."""
        b = self.bucket
        resolve = "r" if self.priorities.resolve is not None else "-"
        part = self.tiled.partition
        hy = "" if part is None else (
            f".h{part.threshold}:{part.dense.n_tiles_pad}"
            f":{_padded_tail_len(part.sp_nnz)}"
        )
        return (
            f"T{b.tile_size}.b{b.n_blocks}.t{b.n_tiles_pad}.e{b.e_pad}"
            f".{resolve}{hy}.{b.storage}"
        )

    def unpack(self, x) -> List[np.ndarray]:
        """Slice a packed per-vertex vector into per-member host vectors
        (plan ids)."""
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        return [x[off: off + n] for off, n in zip(self.offsets, self.sizes)]


def pack_batch(
    plans: Sequence[TilePlan],
    priorities: Sequence[Priorities],
    *,
    bucket: Optional[Bucket] = None,
) -> PackedBatch:
    """Concatenate cached per-graph plans, with each member's priorities,
    into one block-diagonal batch on the plans' device.

    Hybrid routing survives batching only when every member is partitioned
    at one threshold: the batch partition is then rebuilt over the packed
    tile list (padding tiles are all-zero, in neither half), the partition
    a plan of the packed graph would get.  Otherwise the batch runs
    dense-only."""
    if not plans:
        raise ValueError("pack_batch needs at least one plan")
    if len(priorities) != len(plans):
        raise ValueError(f"{len(plans)} plans but {len(priorities)} priorities")
    T = plans[0].tiled.tile_size
    if any(p.tiled.tile_size != T for p in plans):
        raise ValueError("all plans in a batch must share tile_size")
    storage = plans[0].tiled.storage
    if any(p.tiled.storage != storage for p in plans):
        raise ValueError("all plans in a batch must share tile storage")
    dev = plans[0].device
    if any(p.device != dev for p in plans):
        raise ValueError("all plans in a batch must share a device")
    has_resolve = priorities[0].resolve is not None
    if any((pri.resolve is not None) != has_resolve for pri in priorities):
        raise ValueError("members disagree on the H3 resolve key")
    need = bucket_for(plans, T)
    if bucket is None:
        bucket = need
    if (need.n_blocks > bucket.n_blocks or need.n_tiles_pad > bucket.n_tiles_pad
            or need.e_pad > bucket.e_pad or bucket.tile_size != T
            or bucket.storage != storage):
        raise ValueError(f"batch needs {need}, bucket {bucket} too small")

    n_total = bucket.n_blocks * T
    sel = torch.full((n_total,), _NEG, dtype=torch.int32, device=dev)
    res = torch.full((n_total,), _NEG, dtype=torch.int32, device=dev) if has_resolve else None
    alive0 = torch.zeros(n_total, dtype=torch.bool, device=dev)
    col_gate = np.zeros(bucket.n_blocks, dtype=np.int32)
    offsets: List[int] = []
    sizes: List[int] = []
    src_parts, dst_parts, tile_parts, row_parts, col_parts = [], [], [], [], []

    boff = 0
    for plan, pri in zip(plans, priorities):
        g, t = plan.g, plan.tiled
        voff = boff * T
        offsets.append(voff)
        sizes.append(g.n_nodes)
        sel[voff: voff + g.n_nodes] = pri.select.to(dev)
        if has_resolve:
            res[voff: voff + g.n_nodes] = pri.resolve.to(dev)
        alive0[voff: voff + g.n_nodes] = True
        col_gate[boff: boff + plan.n_blocks] = 1
        src_parts.append(g.senders[: g.n_edges] + voff)
        dst_parts.append(g.receivers[: g.n_edges] + voff)
        if t.n_tiles:
            tile_parts.append(t.tiles[: t.n_tiles])
            row_parts.append(t.tile_rows[: t.n_tiles].cpu().numpy() + boff)
            col_parts.append(t.tile_cols[: t.n_tiles].cpu().numpy() + boff)
        boff += plan.n_blocks

    s = torch.cat(src_parts)
    r = torch.cat(dst_parts)
    batch_g = Graph(senders=s, receivers=r, n_nodes=n_total, n_edges=int(s.shape[0]))

    # tiles: concat + all-zero padding tiles pinned to the last real
    # block-row, as `build_block_tiles` pads (either storage)
    cell = tuple(plans[0].tiled.tiles.shape[1:])
    tile_dtype = plans[0].tiled.tiles.dtype
    if tile_parts:
        tiles = torch.cat(tile_parts)
        rows = np.concatenate(row_parts).astype(np.int32)
        cols = np.concatenate(col_parts).astype(np.int32)
    else:
        tiles = torch.zeros((0,) + cell, dtype=tile_dtype, device=dev)
        rows = np.zeros(0, dtype=np.int32)
        cols = np.zeros(0, dtype=np.int32)
    n_real_tiles = int(tiles.shape[0])
    n_pad = bucket.n_tiles_pad - n_real_tiles
    last_row = rows[-1] if n_real_tiles else np.int32(0)
    tiles = torch.cat([tiles, torch.zeros((n_pad,) + cell, dtype=tile_dtype, device=dev)])
    rows = np.concatenate([rows, np.full(n_pad, last_row, np.int32)])
    cols = np.concatenate([cols, np.zeros(n_pad, np.int32)])
    counts = np.bincount(rows[:n_real_tiles], minlength=bucket.n_blocks)
    row_starts = np.zeros(bucket.n_blocks + 1, dtype=np.int32)
    np.cumsum(counts, out=row_starts[1:])
    batch_tiled = BlockTiledGraph(
        tiles=tiles,
        tile_rows=to_torch(rows, dev),
        tile_cols=to_torch(cols, dev),
        row_starts=to_torch(row_starts, dev),
        n_tiles=n_real_tiles,
        n_nodes=n_total,
        tile_size=T,
        n_block_rows=bucket.n_blocks,
        n_block_cols=bucket.n_blocks,
        storage=storage,
    )
    parts = [p.tiled.partition for p in plans]
    if all(pt is not None for pt in parts) and len({pt.threshold for pt in parts}) == 1:
        batch_tiled = dataclasses.replace(
            batch_tiled, partition=partition_tiles(batch_tiled, parts[0].threshold))

    return PackedBatch(
        g=batch_g,
        tiled=batch_tiled,
        priorities=Priorities(select=sel, resolve=res),
        alive0=alive0,
        col_gate=to_torch(col_gate, dev),
        offsets=tuple(offsets),
        sizes=tuple(sizes),
        bucket=bucket,
        n_real_edges=int(s.shape[0]),
        n_real_tiles=n_real_tiles,
    )
