"""Block-tiled adjacency, its hybrid dense/sparse partition and the
packed-frontier substrate (counterpart of `repro.core.tiling`).

The adjacency matrix is cut into T×T tiles; only non-empty tiles are
stored, sorted by block-row then block-column (BSR order), with
`row_starts` the CSR pointer over block-rows.  The Hopper kernels walk
`row_starts[r]..row_starts[r+1]` within one block-row: the dense SpMV with
a warp per 16-row strip, the others with a thread per row.

Tiles come in two storages:

  int8      (nt, T, T) int8, one byte per cell.
  bitpack   (nt, T, W) int32 words with W = max(T // 32, 1), 1 bit per
            cell: bit j of word w of row v is column 32·w + j; when T < 32
            only the low T bits are live.  The words hold the reference's
            uint32 bits (see `repro_torch.device`).

`build_block_tiles` mirrors the reference array for array: the same tile order,
the same pad-to-8 zero tiles pinned to the last real block-row at column
0, and the single zero tile of an empty graph.

Hybrid routing (`attach_partition`): tiles with at least `threshold`
nonzeros form a compacted dense sub-tiling (same block grid, its own
`row_starts`, so block-rows may own no tile), the rest become a COO tail
of global padded vertex ids that the engines run through segment ops.
The partition equals the reference's array for array.

Packed frontiers (the bitwise round body): a vertex vector rides as
(n_blocks, W) int32 words in the same bit layout as a packed tile row, so
a tile row ANDs straight against a frontier word.  The priority-sorted
helpers below re-pack tiles and frontiers per block-column in descending
priority order, MSB first, for the clz form of the bitwise phase ①; the
bit planes feed the plane-scan kernel.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import to_torch
from repro_torch.graphs.graph import Graph

STORAGES = ("int8", "bitpack")
_BITS = 32

# the "auto" gate of hybrid routing: partition only when there are enough
# tiles for the split to matter and a real sparse tail to peel off
HYBRID_AUTO_MIN_TILES = 16
HYBRID_AUTO_MIN_SPARSE_FRAC = 0.25


def packed_words(tile_size: int) -> int:
    """Words per packed tile row: ceil over 32, floor 1."""
    return max(int(tile_size) // _BITS, 1)


def pack_tile_bits(tiles: torch.Tensor) -> torch.Tensor:
    """(..., T, T) 0/1 -> (..., T, W) int32 words, bits packed along columns.

    Bit j of word w takes column 32·w + j.  One OR per bit position keeps
    the intermediate at the packed size (no (..., T, W, 32) expansion)."""
    T = tiles.shape[-1]
    W = packed_words(T)
    words = torch.zeros(tiles.shape[:-1] + (W,), dtype=torch.int32,
                        device=tiles.device)
    for j in range(min(T, _BITS)):
        # columns j, 32 + j, 64 + j, ... are bit j of words 0, 1, 2, ...
        words |= (tiles[..., j::_BITS] != 0).to(torch.int32) << j
    return words


def unpack_tile_mask(packed: torch.Tensor, tile_size: int) -> torch.Tensor:
    """(..., T, W) int32 words -> (..., T, T) bool edge mask."""
    shifts = torch.arange(_BITS, dtype=torch.int32, device=packed.device)
    # `& 1` after the arithmetic shift: the sign fill lands above bit 0
    bits = (packed[..., None] >> shifts) & 1
    full = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * _BITS,))
    return full[..., : int(tile_size)] != 0


def unpack_tile_bits(packed: torch.Tensor, tile_size: int) -> torch.Tensor:
    """(..., T, W) int32 words -> (..., T, T) int8 — inverse of
    `pack_tile_bits`."""
    return unpack_tile_mask(packed, tile_size).to(torch.int8)


def dense_tile_mask(tiles: torch.Tensor, tile_size: int) -> torch.Tensor:
    """Either storage -> (nt, T, T) bool edge mask (the plain-torch tile
    operators' input; the kernels unpack per tile in registers)."""
    if tiles.dtype == torch.int32:
        return unpack_tile_mask(tiles, tile_size)
    return tiles != 0


def tiles_as_words(tiles: torch.Tensor, tile_size: int) -> torch.Tensor:
    """Tiles in the packed-word form whatever the storage: bitpack tiles
    pass through, int8 tiles pack (the bitwise frontier needs word tiles
    even when the plan stores int8)."""
    if tiles.dtype == torch.int32:
        return tiles
    return pack_tile_bits(tiles)


def padded_tile_count(n_real: int, pad_tiles_to: int | None = None) -> int:
    """Stored tile count for `n_real` real tiles: floor 1 (an empty graph
    still stores one zero tile), optional caller floor, aligned up to 8."""
    stored = max(int(n_real), 1)
    target = max(pad_tiles_to or stored, stored)
    return ((target + 7) // 8) * 8


def next_pow2(x: int) -> int:
    """Smallest power of two ≥ x (≥ 1)."""
    return 1 << max(int(x) - 1, 0).bit_length()


@dataclasses.dataclass(frozen=True)
class BlockTiledGraph:
    """BSR adjacency: only non-empty T×T tiles, row-major block order.

    Attributes:
      tiles:      (n_tiles_pad, T, T) int8 or (n_tiles_pad, T, W) int32.
      tile_rows:  (n_tiles_pad,) int32 block-row of each tile (padding
                  tiles carry the last real block-row).
      tile_cols:  (n_tiles_pad,) int32 block-column of each tile.
      row_starts: (n_block_rows + 1,) int32 CSR pointer over block-rows;
                  it covers real tiles only, so a kernel that walks it
                  never visits padding.
      n_tiles, n_nodes, tile_size, n_block_rows, n_block_cols, storage:
                  static metadata.
      partition:  optional `TilePartition` (hybrid routing); the full tile
                  list above stays authoritative, the partition is a view
                  rebuilt from it.
    """
    tiles: torch.Tensor
    tile_rows: torch.Tensor
    tile_cols: torch.Tensor
    row_starts: torch.Tensor
    n_tiles: int
    n_nodes: int
    tile_size: int
    n_block_rows: int
    n_block_cols: int
    storage: str = "int8"
    partition: Optional["TilePartition"] = None

    @property
    def n_tiles_pad(self) -> int:
        return int(self.tiles.shape[0])

    @property
    def n_padded(self) -> int:
        """Vertex count rounded up to a whole number of tiles."""
        return self.n_block_rows * self.tile_size

    @property
    def device(self) -> torch.device:
        return self.tiles.device

    def to_storage(self, storage: str) -> "BlockTiledGraph":
        """Convert between tile storage formats (exact)."""
        if storage not in STORAGES:
            raise ValueError(f"unknown storage {storage!r}; valid: {STORAGES}")
        if storage == self.storage:
            return self
        if storage == "bitpack":
            tiles = pack_tile_bits(self.tiles)
        else:
            tiles = unpack_tile_bits(self.tiles, self.tile_size)
        out = dataclasses.replace(self, tiles=tiles, storage=storage, partition=None)
        if self.partition is not None:
            # the dense sub-tiling shares the storage: rebuild it
            out = dataclasses.replace(
                out, partition=partition_tiles(out, self.partition.threshold))
        return out


@dataclasses.dataclass(frozen=True)
class TilePartition:
    """The nnz-classified hybrid split of a tiling (built by
    `partition_tiles`).  Empty tiles are in neither half.

    Attributes:
      dense:     compacted `BlockTiledGraph` of the tiles with nnz >=
                 threshold, on the same block grid and storage, with its
                 own `row_starts` and pad-to-8 (its `partition` is None).
      tail_rows: (sp_nnz,) int64 global padded output-vertex id per tail
                 nnz (the tile row axis: the scatter target).
      tail_cols: (sp_nnz,) int64 global padded input-vertex id per tail
                 nnz (the gather source).  These are the reference's
                 `sp_rows[:sp_nnz]` / `sp_cols[:sp_nnz]`; its sentinel
                 padding only ever feeds a segment slot it drops, so the
                 port keeps none (and int64, as `scatter_reduce_` /
                 `index_add_` take it, so a round converts nothing).
      threshold, n_dense_tiles, n_sparse_tiles, sp_nnz: static metadata
                 (sp_nnz counts the tail entries).
    """
    dense: BlockTiledGraph
    tail_rows: torch.Tensor
    tail_cols: torch.Tensor
    threshold: int
    n_dense_tiles: int
    n_sparse_tiles: int
    sp_nnz: int

    @functools.cached_property
    def tail_bits(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """`frontier_bit_slots` of `tail_cols`, made once per partition:
        the packed-frontier tail reads one bit per nnz up to three times
        a round."""
        return frontier_bit_slots(self.tail_cols, self.dense.tile_size)


_POP8: dict = {}


def byte_popcounts(device: torch.device) -> torch.Tensor:
    """(256,) int32 popcount of every byte value, made once per device
    (torch has no popcount: a word counts as the sum of its bytes')."""
    table = _POP8.get(device)
    if table is None:
        table = torch.tensor([bin(b).count("1") for b in range(256)], dtype=torch.int32,
                             device=device)
        _POP8[device] = table
    return table


def tile_nnz(tiled: BlockTiledGraph) -> np.ndarray:
    """Per-tile nnz over the stored list, (n_tiles_pad,) int32, counted on
    the tiling's device in chunks (padding tiles read 0)."""
    t = tiled.tiles
    out = torch.empty(t.shape[0], dtype=torch.int32, device=t.device)
    chunk = max((1 << 24) // t[0].numel(), 1)   # a tiling stores >= 8 tiles
    table = byte_popcounts(t.device) if tiled.storage == "bitpack" else None
    for lo in range(0, t.shape[0], chunk):
        part = t[lo:lo + chunk]
        if table is None:
            counts = (part != 0).sum(dim=(1, 2), dtype=torch.int32)
        else:
            counts = table[part.contiguous().view(torch.uint8).long()].sum(
                dim=(1, 2), dtype=torch.int32)
        out[lo:lo + chunk] = counts
    return out.cpu().numpy()


def tile_stats(tiled: BlockTiledGraph) -> dict:
    """The tiling's footprint and nnz distribution, the reference's
    `tile_stats` key for key.  `nnz_hist` buckets the real tiles by nnz
    in powers of two: key u counts tiles with nnz in (u/2, u], key 0 the
    empty ones (a delta can drain a tile in place), up to u = T²."""
    per_tile = tile_nnz(tiled)[: tiled.n_tiles]
    nnz = int(per_tile.sum())
    cells = tiled.n_tiles * tiled.tile_size * tiled.tile_size
    total_blocks = tiled.n_block_rows * tiled.n_block_cols
    cap = tiled.tile_size * tiled.tile_size
    hist = {0: int(np.count_nonzero(per_tile == 0))}
    upper = 1
    while True:
        hist[upper] = int(np.count_nonzero((per_tile > upper // 2) & (per_tile <= upper)))
        if upper >= cap:
            break
        upper *= 2
    payload = tiled.tiles.numel() * tiled.tiles.element_size()
    index_bytes = 4 * (tiled.tile_rows.numel() + tiled.tile_cols.numel()
                       + tiled.row_starts.numel())
    return dict(
        tile_size=tiled.tile_size,
        n_tiles=tiled.n_tiles,
        storage=tiled.storage,
        block_grid=total_blocks,
        block_occupancy=tiled.n_tiles / max(total_blocks, 1),
        intra_tile_density=nnz / max(cells, 1),
        tile_nnz=per_tile.tolist(),
        nnz_hist=hist,
        tile_payload_bytes=payload,
        bsr_bytes=payload + index_bytes,
        csr_bytes=8 * nnz + 4 * (tiled.n_nodes + 1),
    )


def partition_tiles(
    tiled: BlockTiledGraph, threshold: int, *, nnz: np.ndarray | None = None
) -> TilePartition:
    """Classify tiles by nnz and build the hybrid split, on the tiling's
    device.  Deterministic in (tiles, threshold): equal, array for array,
    to the reference's `partition_tiles`.  Dense tiles keep their
    row-major order, so the compacted CSR stays kernel-legal; the tail
    lists nonzeros by tile, then row, then column (`np.nonzero`'s order),
    built in chunks of tiles so the unpacked masks stay near 16 MB."""
    T = tiled.tile_size
    thr = int(threshold)
    dev = tiled.device
    if nnz is None:
        nnz = tile_nnz(tiled)
    real = np.asarray(nnz)[: tiled.n_tiles]
    dense_idx = np.nonzero(real >= thr)[0]
    sparse_idx = np.nonzero((real > 0) & (real < thr))[0]
    rows_h = tiled.tile_rows.cpu().numpy()

    # dense subset: gather, recompute the CSR, re-pad (empty tiles vanish)
    n_dense = int(dense_idx.shape[0])
    d_rows = rows_h[dense_idx].astype(np.int32)
    d_cols = tiled.tile_cols.cpu().numpy()[dense_idx].astype(np.int32)
    counts = np.bincount(d_rows, minlength=tiled.n_block_rows)
    row_starts = np.zeros(tiled.n_block_rows + 1, dtype=np.int32)
    np.cumsum(counts, out=row_starts[1:])
    target = padded_tile_count(n_dense)
    d_tiles = torch.zeros((target,) + tuple(tiled.tiles.shape[1:]),
                          dtype=tiled.tiles.dtype, device=dev)
    d_tiles[:n_dense] = tiled.tiles[to_torch(dense_idx, dev)]
    last_row = d_rows[-1] if n_dense else np.int32(0)
    d_rows = np.concatenate([d_rows, np.full(target - n_dense, last_row, np.int32)])
    d_cols = np.concatenate([d_cols, np.zeros(target - n_dense, np.int32)])
    dense = BlockTiledGraph(
        tiles=d_tiles,
        tile_rows=to_torch(d_rows, dev),
        tile_cols=to_torch(d_cols, dev),
        row_starts=to_torch(row_starts, dev),
        n_tiles=n_dense,
        n_nodes=tiled.n_nodes,
        tile_size=T,
        n_block_rows=tiled.n_block_rows,
        n_block_cols=tiled.n_block_cols,
        storage=tiled.storage,
    )

    # sparse tail: COO in global padded vertex ids
    sp_idx = to_torch(sparse_idx, dev).long()
    v_parts = [torch.empty(0, dtype=torch.int64, device=dev)]
    u_parts = [torch.empty(0, dtype=torch.int64, device=dev)]
    chunk = max((1 << 24) // (T * T), 1)
    for lo in range(0, sp_idx.shape[0], chunk):
        idx = sp_idx[lo:lo + chunk]
        t_i, r_i, c_i = dense_tile_mask(tiled.tiles[idx], T).nonzero(as_tuple=True)
        v_parts.append(tiled.tile_rows[idx][t_i].long() * T + r_i)
        u_parts.append(tiled.tile_cols[idx][t_i].long() * T + c_i)
    tail_rows, tail_cols = torch.cat(v_parts), torch.cat(u_parts)
    return TilePartition(
        dense=dense,
        tail_rows=tail_rows,
        tail_cols=tail_cols,
        threshold=thr,
        n_dense_tiles=n_dense,
        n_sparse_tiles=int(sparse_idx.shape[0]),
        sp_nnz=int(tail_rows.shape[0]),
    )


def attach_partition(
    tiled: BlockTiledGraph, mode: str = "auto", threshold: int | None = None
) -> BlockTiledGraph:
    """The hybrid-routing policy: `tiled` with a partition attached, or
    without one where the policy says the split will not pay.

      off     never partition (a stale partition is dropped).
      forced  always partition.
      auto    partition iff there are >= HYBRID_AUTO_MIN_TILES non-empty
              tiles and the tail holds >= HYBRID_AUTO_MIN_SPARSE_FRAC of
              them.

    `threshold` defaults to the cost model's break-even
    (`repro_torch.perf.hybrid_density_threshold`)."""
    if mode == "off":
        return tiled if tiled.partition is None else dataclasses.replace(tiled, partition=None)
    if mode not in ("auto", "forced"):
        raise ValueError(f"unknown hybrid mode {mode!r}; valid: auto|off|forced")
    if threshold is None:
        from repro_torch.perf.roofline import hybrid_density_threshold

        threshold = hybrid_density_threshold(tiled.tile_size, tiled.storage)
    thr = int(threshold)
    nnz = tile_nnz(tiled)
    real = nnz[: tiled.n_tiles]
    nonempty = int(np.count_nonzero(real))
    n_sparse = int(np.count_nonzero((real > 0) & (real < thr)))
    if mode == "auto" and (
        nonempty < HYBRID_AUTO_MIN_TILES
        or n_sparse == 0
        or n_sparse < HYBRID_AUTO_MIN_SPARSE_FRAC * nonempty
    ):
        return tiled if tiled.partition is None else dataclasses.replace(tiled, partition=None)
    return dataclasses.replace(tiled, partition=partition_tiles(tiled, thr, nnz=nnz))


def rcm_ordering(g: Graph) -> np.ndarray:
    """Reverse Cuthill–McKee vertex permutation: perm[new_id] = old_id."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    s = g.senders[: g.n_edges].cpu().numpy()
    r = g.receivers[: g.n_edges].cpu().numpy()
    adj = coo_matrix(
        (np.ones(len(s), np.int8), (s, r)), shape=(g.n_nodes, g.n_nodes)
    ).tocsr()
    return np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True))


def build_block_tiles(
    g: Graph,
    tile_size: int = 128,
    *,
    pad_tiles_to: int | None = None,
    reorder: str | None = None,   # None | 'rcm'
    storage: str = "int8",        # 'int8' | 'bitpack'
) -> BlockTiledGraph:
    """Tile `g`'s adjacency matrix on the host; the tiling lives on `g`'s
    device (bitpack words are packed there).

    With reorder='rcm' the tiling indexes PERMUTED vertex ids, exactly as
    the reference's `build_block_tiles` does."""
    T = int(tile_size)
    if T < 8 or (T & (T - 1)):
        raise ValueError(f"tile_size must be a power of two >= 8, got {T}")
    if storage not in STORAGES:
        raise ValueError(f"unknown storage {storage!r}; valid: {STORAGES}")
    s = g.senders[: g.n_edges].cpu().numpy().astype(np.int64)
    r = g.receivers[: g.n_edges].cpu().numpy().astype(np.int64)
    if reorder == "rcm":
        perm = rcm_ordering(g)                 # perm[new_id] = old_id
        inv = np.empty_like(perm)
        inv[perm] = np.arange(g.n_nodes)
        s, r = inv[s], inv[r]
        order = np.lexsort((r, s))
        s, r = s[order], r[order]
    elif reorder is not None:
        raise ValueError(f"unknown reorder {reorder!r} (None or 'rcm')")
    nb = -(-g.n_nodes // T)  # ceil
    tr, tc = s // T, r // T
    key = tr * nb + tc
    uniq, inv = np.unique(key, return_inverse=True)
    n_tiles = int(uniq.shape[0])

    tiles = np.zeros((max(n_tiles, 1), T, T), dtype=np.int8)
    tiles[inv, s % T, r % T] = 1
    tile_rows = (uniq // nb).astype(np.int32)
    tile_cols = (uniq % nb).astype(np.int32)
    if n_tiles == 0:   # an empty graph stores one zero tile at (0, 0)
        tile_rows = np.zeros(1, dtype=np.int32)
        tile_cols = np.zeros(1, dtype=np.int32)

    counts = np.bincount(tile_rows[:n_tiles], minlength=nb)
    row_starts = np.zeros(nb + 1, dtype=np.int32)
    np.cumsum(counts, out=row_starts[1:])

    # pad: zero tiles pinned to the last real block-row at column 0
    stored = tiles.shape[0]
    target = padded_tile_count(n_tiles, pad_tiles_to)
    if target > stored:
        last_row = tile_rows[-1] if n_tiles else 0
        tiles = np.concatenate(
            [tiles, np.zeros((target - stored, T, T), dtype=np.int8)], axis=0
        )
        tile_rows = np.concatenate(
            [tile_rows, np.full(target - stored, last_row, dtype=np.int32)]
        )
        tile_cols = np.concatenate(
            [tile_cols, np.zeros(target - stored, dtype=np.int32)]
        )

    dev = g.device
    tiles_t = to_torch(tiles, dev)
    if storage == "bitpack":
        tiles_t = pack_tile_bits(tiles_t)
    return BlockTiledGraph(
        tiles=tiles_t,
        tile_rows=to_torch(tile_rows, dev),
        tile_cols=to_torch(tile_cols, dev),
        row_starts=to_torch(row_starts, dev),
        n_tiles=n_tiles,
        n_nodes=g.n_nodes,
        tile_size=T,
        n_block_rows=int(nb),
        n_block_cols=int(nb),
        storage=storage,
    )


def pack_vertex_vector(x: torch.Tensor, tiled: BlockTiledGraph) -> torch.Tensor:
    """(n_nodes,) -> (n_padded,) zero-padded to whole tiles."""
    pad = tiled.n_padded - x.shape[0]
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def unpack_vertex_vector(x: torch.Tensor, tiled: BlockTiledGraph) -> torch.Tensor:
    """(n_padded, ...) -> (n_nodes, ...): the real vertices' rows."""
    return x[: tiled.n_nodes]


# --------------------------------------------------------------------------
# packed frontiers: (n_blocks, W) int32 words, one bit per vertex
# --------------------------------------------------------------------------

def _pack_bits(bits: torch.Tensor, tile_size: int, *, msb_first: bool) -> torch.Tensor:
    """(..., T) truthy -> (..., W) int32.  Slot s goes to word s // 32, at
    bit s % 32 (standard layout) or bit 31 - s % 32 (`msb_first`).  The
    bits of a word are disjoint, so an int32 sum is their OR."""
    T = int(tile_size)
    if bits.shape[-1] != T:
        raise ValueError(f"last axis is {bits.shape[-1]}, expected T={T}")
    per = min(T, _BITS)
    b = (bits != 0).to(torch.int32).reshape(bits.shape[:-1] + (packed_words(T), per))
    shifts = torch.arange(per, dtype=torch.int32, device=bits.device)
    if msb_first:
        shifts = (_BITS - 1) - shifts
    return (b << shifts).sum(dim=-1, dtype=torch.int32)


def pack_frontier_bits(bits: torch.Tensor, tile_size: int) -> torch.Tensor:
    """(..., T) truthy -> (..., W) int32 words, bit j of word w = slot
    32·w + j: the layout of `pack_tile_bits`."""
    return _pack_bits(bits, tile_size, msb_first=False)


def unpack_frontier_bits(words: torch.Tensor, tile_size: int) -> torch.Tensor:
    """(..., W) int32 words -> (..., T) bool; inverse of
    `pack_frontier_bits`."""
    return unpack_tile_mask(words, tile_size)


def pack_frontier_words(x: torch.Tensor, tile_size: int) -> torch.Tensor:
    """(n_blocks·T,) truthy vertex vector -> (n_blocks, W) int32 words."""
    return pack_frontier_bits(x.reshape(-1, int(tile_size)), tile_size)


def unpack_frontier_words(words: torch.Tensor, tile_size: int) -> torch.Tensor:
    """(n_blocks, W) int32 words -> (n_blocks·T,) bool."""
    return unpack_frontier_bits(words, tile_size).reshape(-1)


def frontier_bit_slots(ids: torch.Tensor, tile_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each global padded vertex id, its slot in (n_blocks, W) frontier
    words: (int64 index into the flattened words, int32 bit shift)."""
    T = int(tile_size)
    ids = ids.long()
    slot = ids % T
    return (ids // T) * packed_words(T) + slot // _BITS, (slot % _BITS).to(torch.int32)


def gather_frontier_bits(words: torch.Tensor, slots: Tuple[torch.Tensor, torch.Tensor]
                         ) -> torch.Tensor:
    """The bool at each of `slots` (`frontier_bit_slots`) of the frontier
    words: one gather, a shift and a mask per id, not a frontier unpack.
    Unlike a jnp gather, an id past the last block is not clamped: callers
    pass real vertex ids only."""
    index, shift = slots
    # `& 1` after the arithmetic shift: the sign fill lands above bit 0
    return ((words.reshape(-1)[index] >> shift) & 1) != 0


def sort_block_priorities(p: torch.Tensor, tile_size: int):
    """(n_blocks·T,) int32 -> (order, p_sorted), both (n_blocks, T).

    `order[b, s]` is the in-block column in descending-priority slot `s`.
    The sort is stable (H3 select keys tie by design) and runs on `-p` in
    int32, as the reference does: int32 min negates to itself and sorts
    first."""
    blocks = p.reshape(-1, int(tile_size))
    order = torch.argsort(-blocks, dim=1, stable=True)
    return order.to(torch.int32), torch.gather(blocks, 1, order)


def pack_sorted_frontier_bits(bits_sorted: torch.Tensor, tile_size: int) -> torch.Tensor:
    """(..., T) truthy in sorted-slot order -> (..., W) int32 with slot s
    at bit 31 − (s mod 32) of word s // 32: MSB first, so the count of
    leading zeros of a word is its first occupied slot."""
    return _pack_bits(bits_sorted, tile_size, msb_first=True)


def sorted_tile_bits(
    tiles: torch.Tensor,
    tile_cols: torch.Tensor,
    order: torch.Tensor,
    tile_size: int,
) -> torch.Tensor:
    """Tiles (either storage) column-permuted into each block-column's
    priority-slot order and packed MSB first: (nt, T, W) int32.  Built in
    chunks of tiles, so the transient bool mask stays near 16 MB."""
    T = int(tile_size)
    nt = tiles.shape[0]
    out = torch.empty((nt, T, packed_words(T)), dtype=torch.int32, device=tiles.device)
    chunk = max((1 << 24) // (T * T), 1)
    for lo in range(0, nt, chunk):
        hi = min(lo + chunk, nt)
        mask = dense_tile_mask(tiles[lo:hi], T)                   # (c, T, T)
        g_order = order[tile_cols[lo:hi].long()].long()           # (c, T)
        permuted = torch.gather(mask, 2, g_order[:, None, :].expand(-1, T, -1))
        out[lo:hi] = pack_sorted_frontier_bits(permuted, T)
    return out


def sorted_frontier_words(
    words: torch.Tensor, order: torch.Tensor, tile_size: int
) -> torch.Tensor:
    """Standard-layout frontier words -> sorted-slot words, per block
    column (the per-round remap that feeds the clz scan)."""
    bits = unpack_frontier_bits(words, tile_size)                 # (nbc, T)
    bits_sorted = torch.gather(bits, 1, order.long())
    return pack_sorted_frontier_bits(bits_sorted, tile_size)


def pack_priority_planes(
    p: torch.Tensor, tile_size: int, n_bits: int, *, signed: bool = False
) -> torch.Tensor:
    """(n_blocks·T,) int32 -> (n_bits, n_blocks, W) int32 bit planes in
    the standard frontier layout: plane b holds bit b of every priority.
    `signed` flips the sign bit (the order-preserving bias `^ 0x80000000`)
    so two's-complement keys scan in order; the plane scan un-biases."""
    u = p.to(torch.int32)
    if signed:
        u = u ^ -(1 << 31)
    blocks = u.reshape(-1, int(tile_size))
    b = torch.arange(int(n_bits), dtype=torch.int32, device=p.device)
    # `& 1` after the arithmetic shift: the sign fill lands above bit 0
    bits = (blocks[None] >> b[:, None, None]) & 1                 # (n_bits, nb, T)
    return pack_frontier_bits(bits, tile_size)


def tiling_from_arrays(
    arrays: dict, *, n_tiles: int, n_nodes: int, tile_size: int,
    n_block_rows: int, n_block_cols: int, storage: str, device,
) -> BlockTiledGraph:
    """A tiling from the reference's numpy arrays (tiles as stored: int8,
    or uint32 words, which arrive as int32 with the same bits)."""
    if storage not in STORAGES:
        raise ValueError(f"unknown storage {storage!r}; valid: {STORAGES}")
    return BlockTiledGraph(
        tiles=to_torch(arrays["tiles"], device),
        tile_rows=to_torch(arrays["tile_rows"], device),
        tile_cols=to_torch(arrays["tile_cols"], device),
        row_starts=to_torch(arrays["row_starts"], device),
        n_tiles=int(n_tiles),
        n_nodes=int(n_nodes),
        tile_size=int(tile_size),
        n_block_rows=int(n_block_rows),
        n_block_cols=int(n_block_cols),
        storage=storage,
    )
