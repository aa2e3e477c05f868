"""Tiled neighbour max on Hopper (phase ① on the tile schedule): wrappers,
plain versions, launch counts.

  tc_neighbor_max       masked max on the dense frontier; replaces the
                        Pallas `_nbr_max_kernel`
  tc_neighbor_max_bits  priority-plane scan on the packed frontier;
                        replaces `_nbr_max_bits_kernel`

Both kernels live in `csrc/tc_neighbor_max.cu`.  On CUDA tensors a wrapper
launches its kernel on the current stream, or raises; on CPU tensors it
runs the plain-torch version below (what the CPU tests use and
`chip_smoke.py` holds the kernel against).  Each wrapper counts its
kernel launches in `<wrapper>.launches`.

Output of both: (nbr·T,) int32 Max_Np.  A row of a block-row that owns a
tile gets at least `_NEG` (no live neighbour), as the Pallas kernels'
per-row `_NEG` initialisation gives; a block-row that owns no tile gets
int32 min, as `tile_neighbor_max` and the reference's packed wrapper give.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.engine import RESOLVE_PLANE_BITS, SELECT_PLANE_BITS, tile_neighbor_max
from repro_torch.core.spmv import INT32_MIN, _NEG
from repro_torch.core.tiling import BlockTiledGraph, packed_words, tiles_as_words
from repro_torch.hopper.launch import (
    check,
    check_aligned,
    check_tiling,
    entry,
    on_cpu,
    ptr,
    raise_on_error,
    stream,
)

_P, _I = ctypes.c_void_p, ctypes.c_int


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def tc_neighbor_max_plain(tiled: BlockTiledGraph, p: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Plain-torch masked max over the real tiles (the kernel walks
    `row_starts`, which never reaches the zero padding tiles), each covered
    row floored at `_NEG` as the Pallas kernel's rows start there."""
    T, nt = tiled.tile_size, tiled.n_tiles
    out = tile_neighbor_max(
        tiled.tiles[:nt], tiled.tile_rows[:nt], tiled.tile_cols[:nt],
        torch.where(mask, p, _NEG), tiled.n_block_rows, T,
    )
    covered = (tiled.row_starts[1:] > tiled.row_starts[:-1]).repeat_interleave(T)
    return torch.where(covered, out.clamp(min=_NEG), out)


def tc_neighbor_max_bits_plain(
    tiled: BlockTiledGraph, planes: torch.Tensor, mask_words: torch.Tensor, *,
    tiles_words: Optional[torch.Tensor] = None, signed: bool = False,
) -> torch.Tensor:
    """Plain-torch plane scan: per tile row, `cur = tile_word & mask_word`;
    for each plane b, high to low, a nonempty `cur & plane_b` sets bit b
    of the max and narrows `cur`.  Signed planes were biased by
    `^ 0x80000000` and are un-biased here."""
    T, nt = tiled.tile_size, tiled.n_tiles
    words = tiles_words if tiles_words is not None else tiles_as_words(tiled.tiles, T)
    cols = tiled.tile_cols[:nt].long()
    cur = words[:nt] & mask_words[cols][:, None, :]                # (nt, T, W)
    nonempty = (cur != 0).any(dim=2)
    maxv = torch.zeros(cur.shape[:2], dtype=torch.int32, device=cur.device)
    for b in range(planes.shape[0] - 1, -1, -1):
        inter = cur & planes[b][cols][:, None, :]
        has = (inter != 0).any(dim=2)
        maxv = maxv | (has.to(torch.int32) << b)
        cur = torch.where(has[..., None], inter, cur)
    vals = maxv ^ INT32_MIN if signed else maxv
    # the Pallas kernel starts every covered row at _NEG: floor at it
    tile_max = torch.where(nonempty, torch.clamp(vals, min=_NEG), _NEG).to(torch.int32)
    out = torch.full((tiled.n_block_rows, T), INT32_MIN, dtype=torch.int32,
                     device=cur.device)
    index = tiled.tile_rows[:nt].long()[:, None].expand(-1, T)
    out.scatter_reduce_(0, index, tile_max, "amax")
    return out.reshape(-1)


# --------------------------------------------------------------------------
# the kernel launches
# --------------------------------------------------------------------------

def _launch(tiled: BlockTiledGraph, p: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    T, nbr, nbc = tiled.tile_size, tiled.n_block_rows, tiled.n_block_cols
    dev = tiled.tiles.device
    check_tiling(tiled, dev)
    packed = tiled.tiles.dtype == torch.int32
    cell_shape = (T, packed_words(T)) if packed else (T, T)
    check("tiles", tiled.tiles, (torch.int8, torch.int32),
          (tiled.n_tiles_pad,) + cell_shape, dev)
    check_aligned("tiles", tiled.tiles)
    check("p", p, torch.int32, (nbc * T,), dev)
    check("mask", mask, torch.bool, (nbc * T,), dev)
    check_aligned("p", p)
    check_aligned("mask", mask)
    out = torch.empty((nbr * T,), dtype=torch.int32, device=dev)
    fn = entry("tc_neighbor_max", "tc_nbr_max_launch",
               [_P, _I, _P, _P, _P, _P, _P, _I, _I, _P])
    raise_on_error("tc_neighbor_max", fn(
        ptr(tiled.tiles), int(packed), ptr(tiled.row_starts), ptr(tiled.tile_cols),
        ptr(p), ptr(mask), ptr(out), nbr, T, stream(dev),
    ))
    return out


def _plane_bits(signed: bool) -> int:
    """The engines build 32 sign-biased resolve planes or 31 unsigned
    select planes; the kernel is compiled for exactly those two stacks."""
    return RESOLVE_PLANE_BITS if signed else SELECT_PLANE_BITS


def _launch_bits(tiled: BlockTiledGraph, tiles_words, planes, mask_words, signed) -> torch.Tensor:
    T, nbr, nbc = tiled.tile_size, tiled.n_block_rows, tiled.n_block_cols
    W = packed_words(T)
    dev = tiles_words.device
    check_tiling(tiled, dev)
    check("tiles_words", tiles_words, torch.int32, (tiled.n_tiles_pad, T, W), dev)
    check_aligned("tiles_words", tiles_words)
    check("planes", planes, torch.int32, (_plane_bits(signed), nbc, W), dev)
    check("mask_words", mask_words, torch.int32, (nbc, W), dev)
    check_aligned("planes", planes)
    check_aligned("mask_words", mask_words)
    out = torch.empty((nbr * T,), dtype=torch.int32, device=dev)
    fn = entry("tc_neighbor_max", "tc_nbr_max_bits_launch",
               [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
    raise_on_error("tc_neighbor_max_bits", fn(
        ptr(tiles_words), ptr(tiled.row_starts), ptr(tiled.tile_cols), ptr(planes),
        ptr(mask_words), ptr(out), nbr, nbc, T, int(signed), stream(dev),
    ))
    return out


# --------------------------------------------------------------------------
# the wrappers
# --------------------------------------------------------------------------

def tc_neighbor_max(tiled: BlockTiledGraph, p: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Phase ① on the tile schedule: Max_Np(v) = max of `p[u]` over the
    neighbours u of v with `mask[u]`.  `p` (nbc·T,) int32, `mask` (nbc·T,)
    bool; tiles as stored (int8 or packed words)."""
    if on_cpu(tiled.tiles, p, mask):
        return tc_neighbor_max_plain(tiled, p, mask)
    out = _launch(tiled, p, mask)
    tc_neighbor_max.launches += 1
    return out


def tc_neighbor_max_bits(
    tiled: BlockTiledGraph,
    planes: torch.Tensor,
    mask_words: torch.Tensor,
    *,
    tiles_words: Optional[torch.Tensor] = None,
    signed: bool = False,
) -> torch.Tensor:
    """Phase ① on packed words: the priority-plane scan.  `planes` is the
    stack of `tiling.pack_priority_planes`: (32, nbc, W) sign-biased when
    `signed`, else (31, nbc, W) unsigned; `mask_words` (nbc, W) int32."""
    n_bits = _plane_bits(signed)
    if planes.ndim != 3 or planes.shape[0] != n_bits:
        raise ValueError(f"{'signed' if signed else 'unsigned'} planes must be "
                         f"({n_bits}, nbc, W), got shape {tuple(planes.shape)}")
    if tiles_words is None:
        tiles_words = tiles_as_words(tiled.tiles, tiled.tile_size)
    if on_cpu(tiles_words, planes, mask_words):
        return tc_neighbor_max_bits_plain(tiled, planes, mask_words,
                                          tiles_words=tiles_words, signed=signed)
    out = _launch_bits(tiled, tiles_words, planes, mask_words, signed)
    tc_neighbor_max_bits.launches += 1
    return out


tc_neighbor_max.launches = 0
tc_neighbor_max_bits.launches = 0
