"""Sharded TC-MIS: block-row slabs over a `torch.distributed` group
(counterpart of `repro.core.distributed`).

Layout: each rank owns a contiguous slab of block-rows of the tiled
adjacency (local rows, global columns) and the matching slice of the
state vectors.  Per round the only communication is the all-gather of the
pending, candidate and alive sets, as int32 frontier words
(`core.tiling.pack_frontier_words`) when `DistConfig.bitpack`, else as
one byte per vertex.  Everything else is rank-local: phase ① is the plain
`core.engine.tile_neighbor_max` on the pre-masked priorities
(`core.spmv.neighbor_max_tiled(backend="ref")`: the floor
rule of the reference's shards, not the Hopper dense max, which floors
every covered row), phase ② the split SpMV `hopper.tc_spmv` on the slab
(the kernel on CUDA tensors, its plain version on CPU tensors), phase ③
the own-state update.

A rank stands for a device: the reference's device count is the group's
world size.  `process_group(device)` gives the default group, or, when
none is initialised, a one-rank group on an in-process `HashStore`, as
the reference runs a one-device mesh.  CUDA tensors need an NCCL group,
CPU tensors a gloo group; nothing is staged through the host.

The loop is a Python loop with one host read a round
(`alive.any()` of the gathered, identical alive set), so every rank runs
the same rounds.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.engine import block_col_flags
from repro_torch.core.heuristics import Priorities
from repro_torch.core.spmv import _NEG, neighbor_max_tiled
from repro_torch.core.tiling import (
    BlockTiledGraph,
    padded_tile_count,
    pack_frontier_words,
    unpack_frontier_words,
)


# --------------------------------------------------------------------------
# host-side shard construction
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedTiledGraph:
    """Row-partitioned BSR; the leading axis is the shard axis.

    tiles:     (S, nt_pad, T, T) int8, or (S, nt_pad, T, W) int32 words
               when the source tiling is bitpack
    tile_rows: (S, nt_pad) int32, block-row LOCAL to the shard; padding
               tiles sit on local row rows_per_shard - 1
    tile_cols: (S, nt_pad) int32, GLOBAL block-column (padding: 0)
    shard_tiles: real tiles per shard (each shard's list is its real
               tiles, in BSR order, then zero padding tiles)
    """
    tiles: torch.Tensor
    tile_rows: torch.Tensor
    tile_cols: torch.Tensor
    n_nodes: int
    tile_size: int
    rows_per_shard: int
    n_shards: int
    n_block_cols: int
    shard_tiles: Tuple[int, ...]
    storage: str = "int8"

    @property
    def n_padded(self) -> int:
        """Global padded vertex count = S · rows_per_shard · T."""
        return self.n_shards * self.rows_per_shard * self.tile_size

    def slab(self, shard: int) -> BlockTiledGraph:
        """Shard `shard`'s slab as a tiling the Hopper wrappers take:
        `n_block_rows = rows_per_shard`, `n_block_cols` the global padded
        block count, and `row_starts` over the real tiles only (the kernels
        walk it and never reach the padding).  The tile arrays are views
        of this graph's; each slab starts at a multiple of 8 tiles, so
        16-byte aligned when the whole is."""
        rps, k = self.rows_per_shard, self.shard_tiles[shard]
        rows = self.tile_rows[shard]
        counts = torch.bincount(rows[:k].long(), minlength=rps)
        row_starts = torch.zeros(rps + 1, dtype=torch.int32, device=rows.device)
        row_starts[1:] = torch.cumsum(counts, 0).to(torch.int32)
        return BlockTiledGraph(
            tiles=self.tiles[shard],
            tile_rows=rows,
            tile_cols=self.tile_cols[shard],
            row_starts=row_starts,
            n_tiles=k,
            n_nodes=self.n_nodes,
            tile_size=self.tile_size,
            n_block_rows=rps,
            n_block_cols=rps * self.n_shards,
            storage=self.storage,
        )


def shard_tiled(tiled: BlockTiledGraph, n_shards: int) -> ShardedTiledGraph:
    """Split a BSR tiling into `n_shards` row slabs, padded to a rectangle
    of max_nt tiles (the largest shard's real count, floor 1, up to a
    multiple of 8), on the tiling's device.  Storage-agnostic: packed
    tiles shard in their packed form.

    Equals the reference's arrays element for element.  The real tiles are
    in BSR order, so shard s's are the contiguous run of block-rows
    [s·rps, (s+1)·rps) that `row_starts` bounds."""
    T = tiled.tile_size
    nbr = tiled.n_block_rows
    rps = -(-nbr // n_shards)
    bounds = tiled.row_starts.cpu().numpy().astype(np.int64)
    lo = bounds[np.minimum(np.arange(n_shards) * rps, nbr)]
    hi = bounds[np.minimum(np.arange(1, n_shards + 1) * rps, nbr)]
    counts = (hi - lo).tolist()
    max_nt = padded_tile_count(max(counts, default=0))

    dev = tiled.device
    tiles = torch.zeros((n_shards, max_nt) + tuple(tiled.tiles.shape[1:]),
                        dtype=tiled.tiles.dtype, device=dev)
    rows = torch.full((n_shards, max_nt), rps - 1, dtype=torch.int32, device=dev)
    cols = torch.zeros((n_shards, max_nt), dtype=torch.int32, device=dev)
    for s, (a, k) in enumerate(zip(lo.tolist(), counts)):
        tiles[s, :k] = tiled.tiles[a:a + k]
        rows[s, :k] = tiled.tile_rows[a:a + k] - s * rps
        cols[s, :k] = tiled.tile_cols[a:a + k]
    return ShardedTiledGraph(
        tiles=tiles, tile_rows=rows, tile_cols=cols,
        n_nodes=tiled.n_nodes, tile_size=T, rows_per_shard=rps,
        n_shards=n_shards, n_block_cols=rps * n_shards,
        shard_tiles=tuple(counts), storage=tiled.storage,
    )


# --------------------------------------------------------------------------
# the group
# --------------------------------------------------------------------------

_BACKEND_FOR = {"cuda": "nccl", "cpu": "gloo"}


def process_group(device: torch.device):
    """The group a sharded solve on `device` runs over: the default group
    when one is initialised (it must take `device`'s tensors), else a new
    one-rank default group on an in-process `HashStore` (NCCL for CUDA,
    gloo for the CPU).  Returns None, which names the default group."""
    if not dist.is_initialized():
        kw = {"device_id": device} if device.type == "cuda" else {}
        dist.init_process_group(_BACKEND_FOR[device.type], store=dist.HashStore(),
                                rank=0, world_size=1, **kw)
    check_group_device(None, device)
    return None


def check_group_device(group, device: torch.device) -> None:
    """Raise a ValueError unless `group`'s backend takes `device`'s
    tensors (a gloo group cannot gather CUDA tensors, nor NCCL CPU ones)."""
    backend = str(dist.get_backend(group))
    if _BACKEND_FOR[device.type] not in backend:
        raise ValueError(
            f"the process group's backend {backend!r} cannot take tensors on "
            f"{device}: it needs {_BACKEND_FOR[device.type]!r}")


def world_size() -> int:
    """Ranks of the default group; 1 when none is initialised."""
    return dist.get_world_size() if dist.is_initialized() else 1


# the newer spelling where this torch has it (older releases have only
# the other; the newer ones deprecate it)
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


# --------------------------------------------------------------------------
# the distributed algorithm
# --------------------------------------------------------------------------

class DistMISResult(NamedTuple):
    in_mis: torch.Tensor    # (n_padded,) bool, the whole vector on every rank
    rounds: int             # the same on every rank


@dataclasses.dataclass(frozen=True)
class DistConfig:
    max_rounds: int = 1024
    bitpack: bool = True     # gather packed frontier words, not bytes
    lanes: int = 8


def gather_bool(x_local: torch.Tensor, tile_size: int, *, bitpack: bool = True,
                group=None) -> torch.Tensor:
    """(n_local,) bool on every rank -> the (world · n_local,) concatenation
    in rank order, on every rank.  With `bitpack` the payload is the
    (n_local / T, W) int32 frontier words (a bit a vertex at T >= 32, two
    at T = 16), unpacked after the gather; else one byte per vertex."""
    size = dist.get_world_size(group)
    if bitpack:
        words = pack_frontier_words(x_local, tile_size)
        out = words.new_empty((size * words.shape[0], words.shape[1]))
        _all_gather(out, words, group=group)
        return unpack_frontier_words(out, tile_size)
    out = torch.empty(size * x_local.shape[0], dtype=torch.uint8, device=x_local.device)
    _all_gather(out, x_local.to(torch.uint8), group=group)
    return out.bool()


def _local_nbr_max(slab: BlockTiledGraph, p_global: torch.Tensor,
                   mask_global: torch.Tensor) -> torch.Tensor:
    """Phase ① on the slab: the plain `tile_neighbor_max` over every stored
    tile (padding included, as the reference's shards run it), local rows,
    global columns."""
    return neighbor_max_tiled(slab, p_global, mask_global, backend="ref")


def build_distributed_mis(sharded: ShardedTiledGraph, group=None,
                          cfg: DistConfig = DistConfig()):
    """This rank's sharded MIS over `group` (None: the default group, which
    must be initialised, of world size `sharded.n_shards`).  Returns

        run(pri, two_pass=None) -> DistMISResult

    `pri` holds (n_nodes,) or (n_padded,) keys on the slab's device, the
    same on every rank; `two_pass` defaults to `pri.resolve is not None`.
    Every rank must call `run` together."""
    from repro_torch.hopper.tc_spmv import tc_spmv

    rank = dist.get_rank(group)
    size = dist.get_world_size(group)
    if size != sharded.n_shards:
        raise ValueError(f"{sharded.n_shards} shards on a group of {size} ranks")
    slab = sharded.slab(rank)
    dev = slab.device
    check_group_device(group, dev)
    T, n_padded = sharded.tile_size, sharded.n_padded
    n_local = sharded.rows_per_shard * T
    off = rank * n_local

    def gather(x_local: torch.Tensor) -> torch.Tensor:
        return gather_bool(x_local, T, bitpack=cfg.bitpack, group=group)

    def pad(x: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.pad(x, (0, n_padded - x.shape[0]), value=_NEG)

    def run(pri: Priorities, two_pass: Optional[bool] = None) -> DistMISResult:
        two = (pri.resolve is not None) if two_pass is None else two_pass
        select = pad(pri.select)
        resolve = pad(pri.resolve if pri.resolve is not None
                      else torch.full_like(pri.select, _NEG))
        select_l, resolve_l = select[off:off + n_local], resolve[off:off + n_local]

        alive_g = gather(torch.arange(n_local, dtype=torch.int32, device=dev) + off
                         < sharded.n_nodes)
        in_mis_l = torch.zeros(n_local, dtype=torch.bool, device=dev)
        rhs = torch.zeros((n_padded, cfg.lanes), dtype=torch.float32, device=dev)
        rounds = 0
        while rounds < cfg.max_rounds and bool(alive_g.any()):  # repro-lint: disable=RPT010 the one sanctioned sync a round: every rank reads the gathered alive set's any()
            alive_l = alive_g[off:off + n_local]
            # ① the local max against the global select keys
            max_np = _local_nbr_max(slab, select, alive_g)
            if two:
                pend_l = alive_l & (select_l >= max_np)
                max_res = _local_nbr_max(slab, resolve, gather(pend_l))
                cand_l = pend_l & (resolve_l > max_res)
            else:
                cand_l = alive_l & (select_l > max_np)
            # ② the slab against the gathered candidates; every rank sees the
            # same gathered set, so the column skip is exact on every slab
            cand_g = gather(cand_l)
            rhs[:, 0] = cand_g
            rhs[:, 1] = alive_g
            n_c = tc_spmv(slab, rhs, col_flags=block_col_flags(cand_g, T))[:, 0]
            # ③ the own-state update, then the new alive set
            in_mis_l = in_mis_l | cand_l
            alive_g = gather(alive_l & ~cand_l & ~(n_c > 0))
            rounds += 1
        return DistMISResult(in_mis=gather(in_mis_l), rounds=rounds)

    return run
