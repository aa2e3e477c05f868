"""Block-tiled SpMV on Hopper: wrappers, plain versions, launch counts.

Dense frontier (`csrc/tc_spmv.cu`, replacing the Pallas `_spmv_fused_kernel`
and `_spmv_kernel`; the tile × slab product runs on the tensor cores,
`mma.sync` m16n8k16 in bf16 with an f32 accumulator, a warp per 16-row
strip of a block-row, registers only):

  tc_spmv_fused   phases ②+③ -> (n_c, new_alive, mis_add)
  tc_spmv         phase ②    -> n_c

An f32 RHS enters the tensor cores as three bf16 parts (hi = rn(x), mid =
rn(x - hi), lo = rn(x - hi - mid)) that sum back to x exactly for finite x
with 2^-110 <= |x| < 2^128·(1 - 2^-9), or 0; the tiles are 0/1, so every
product is exact and only the order and rounding of the sums differ from
the plain version: 0/1 lanes come out exact, random f32 lanes within a few
ulps of the sum.  The kernel holds no shared memory and takes the lanes 8
at a time, so any L >= 2 runs (L = 8 on an instance compiled for it).

Packed-word frontier (`csrc/tc_spmv_bits.cu`, replacing
`_spmv_fused_bits_kernel` and `_spmv_bits_kernel`):

  tc_spmv_fused_bits  phases ②+③ -> (hit, new_alive, mis_add) words
  tc_spmv_bits        phase ②    -> hit words

Each returns what the reference's `repro.kernels.ops` wrapper of the same
name returns.  On CUDA tensors it launches its kernel on the current
stream, or raises; on CPU tensors it runs the plain-torch version below,
which the CPU parity tests use and `chip_smoke.py` holds the kernel
against.  Each wrapper counts its kernel launches in `<wrapper>.launches`.
`tc_spmv`, the one the sharded route and the dry run's tcmis cells reach,
has a fake branch (`hopper.launch.fake`): on fake tensors it returns an
empty n_c and reports the launch (`_fake_spmv`).

Inputs (T = tile size, W = max(T // 32, 1), L = lanes, nbr/nbc = block
rows/cols):
  tiled.tiles   (nt, T, T) int8, or (nt, T, W) int32 words (bitpack)
  rhs           (nbc·T, L) float32 (bfloat16 for the split kernel too)
  cand, alive   (nbr·T,) bool — dense fused only
  cand_words    (nbc, W) int32 — the packed candidate set
  alive_words   (nbr, W) int32 — packed fused only
  tiles_words   (nt, T, W) int32 tiles for the packed kernels (default:
                `tiles_as_words(tiled.tiles)`)
  col_flags     (nbc,) int32 or None; a tile in a column flagged 0 adds
                nothing on any lane and hits nothing
Rows no tile maps to come out as n_c = 0 / hit = 0, new_alive = alive &
~cand, mis_add = cand (the reference wrappers' patched epilogue).  For T <
32 the packed outputs keep only the low T bits.

`skip_dma` is accepted for parity: the kernels never load a gated tile or
slab, so both settings run the same code.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.engine import live_bits, tile_spmv, tile_spmv_bits
from repro_torch.core.tiling import BlockTiledGraph, packed_words, tiles_as_words
from repro_torch.hopper.launch import (
    check,
    check_aligned,
    check_tiling,
    entry,
    fake,
    on_cpu,
    ptr,
    raise_on_error,
    report,
    stream,
)

_P, _I = ctypes.c_void_p, ctypes.c_int


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def tc_spmv_plain(tiled: BlockTiledGraph, rhs: torch.Tensor, *,
                  col_flags: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain-torch phase ②: N = A @ rhs, (nbr·T, L) float32."""
    return tile_spmv(tiled.tiles, tiled.tile_rows, tiled.tile_cols, rhs,
                     tiled.n_block_rows, tiled.tile_size, col_flags=col_flags)


def tc_spmv_fused_plain(
    tiled: BlockTiledGraph, rhs: torch.Tensor, cand: torch.Tensor,
    alive: torch.Tensor, *, col_flags: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch phases ②+③: (n_c, new_alive, mis_add)."""
    n_c = tc_spmv_plain(tiled, rhs, col_flags=col_flags)
    new_alive = alive & ~cand & ~(n_c[:, 0] > 0)
    return n_c, new_alive, cand.clone()


def _words(tiled: BlockTiledGraph, tiles_words: Optional[torch.Tensor]) -> torch.Tensor:
    return tiles_words if tiles_words is not None else tiles_as_words(
        tiled.tiles, tiled.tile_size)


def tc_spmv_bits_plain(
    tiled: BlockTiledGraph, cand_words: torch.Tensor, *,
    tiles_words: Optional[torch.Tensor] = None,
    col_flags: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain-torch packed phase ②: (nbr, W) hit words."""
    return tile_spmv_bits(
        _words(tiled, tiles_words), tiled.tile_rows, tiled.tile_cols, cand_words,
        tiled.n_block_rows, tiled.tile_size, col_flags=col_flags,
    )


def tc_spmv_fused_bits_plain(
    tiled: BlockTiledGraph, cand_words: torch.Tensor, alive_words: torch.Tensor,
    *, tiles_words: Optional[torch.Tensor] = None,
    col_flags: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain-torch packed phases ②+③: (hit, new_alive, mis_add) words."""
    hit = tc_spmv_bits_plain(tiled, cand_words, tiles_words=tiles_words,
                             col_flags=col_flags)
    live = live_bits(tiled.tile_size)
    return hit, alive_words & ~cand_words & ~hit & live, cand_words & live


# --------------------------------------------------------------------------
# the kernel launches
# --------------------------------------------------------------------------

def _launch(tiled: BlockTiledGraph, rhs: torch.Tensor, col_flags, fused_io) -> torch.Tensor:
    """Validate everything the dense kernel relies on, allocate, launch,
    raise on a nonzero cudaError_t.  `fused_io` is (cand, alive) or None."""
    T, nbr, nbc = tiled.tile_size, tiled.n_block_rows, tiled.n_block_cols
    dev = tiled.tiles.device
    check_tiling(tiled, dev)
    nt = tiled.n_tiles_pad
    packed = tiled.tiles.dtype == torch.int32
    cell_shape = (T, packed_words(T)) if packed else (T, T)
    check("tiles", tiled.tiles, (torch.int8, torch.int32), (nt,) + cell_shape, dev)
    check_aligned("tiles", tiled.tiles)
    if rhs.ndim != 2:
        raise ValueError(f"rhs must be (nbc*T, L), got shape {tuple(rhs.shape)}")
    L = int(rhs.shape[1])
    if L < 2:
        raise ValueError(f"lanes must be >= 2, got {L}")
    check("rhs", rhs, (torch.float32, torch.bfloat16), (nbc * T, L), dev)
    if fused_io is not None and rhs.dtype != torch.float32:
        raise TypeError("the fused kernel takes a float32 rhs")
    if col_flags is not None:
        check("col_flags", col_flags, torch.int32, (nbc,), dev)

    n_c = torch.empty((nbr * T, L), dtype=torch.float32, device=dev)
    cand = alive = new_alive = mis_add = None
    if fused_io is not None:
        cand, alive = fused_io
        check("cand", cand, torch.bool, (nbr * T,), dev)
        check("alive", alive, torch.bool, (nbr * T,), dev)
        new_alive = torch.empty_like(alive)
        mis_add = torch.empty_like(cand)
    fn = entry("tc_spmv", "tc_spmv_launch",
               [_P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P])
    raise_on_error("tc_spmv", fn(
        ptr(tiled.tiles), int(packed), ptr(tiled.row_starts),
        ptr(tiled.tile_cols), ptr(col_flags), ptr(rhs),
        int(rhs.dtype == torch.bfloat16), ptr(n_c), ptr(cand), ptr(alive),
        ptr(new_alive), ptr(mis_add), nbr, T, L, stream(dev),
    ))
    if fused_io is None:
        return n_c
    return n_c, new_alive, mis_add


def _launch_bits(tiled: BlockTiledGraph, tiles_words, cand_words, alive_words, col_flags):
    """Validate, allocate and launch the packed SpMV; fused iff
    `alive_words` is given.  Returns hit, or (hit, new_alive, mis_add)."""
    T, nbr, nbc = tiled.tile_size, tiled.n_block_rows, tiled.n_block_cols
    W = packed_words(T)
    dev = tiles_words.device
    check_tiling(tiled, dev)
    check("tiles_words", tiles_words, torch.int32, (tiled.n_tiles_pad, T, W), dev)
    check_aligned("tiles_words", tiles_words)
    check("cand_words", cand_words, torch.int32, (nbc, W), dev)
    if col_flags is not None:
        check("col_flags", col_flags, torch.int32, (nbc,), dev)
    hit = torch.empty((nbr, W), dtype=torch.int32, device=dev)
    new_alive = mis_add = None
    if alive_words is not None:
        if nbr != nbc:
            raise ValueError("the fused kernel reads cand_words by block-row too: "
                             f"needs a square block grid, got {nbr}x{nbc}")
        check("alive_words", alive_words, torch.int32, (nbr, W), dev)
        new_alive = torch.empty_like(hit)
        mis_add = torch.empty_like(hit)
    fn = entry("tc_spmv_bits", "tc_spmv_bits_launch",
               [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P])
    raise_on_error("tc_spmv_bits", fn(
        ptr(tiles_words), ptr(tiled.row_starts), ptr(tiled.tile_cols),
        ptr(col_flags), ptr(cand_words), ptr(alive_words), ptr(hit),
        ptr(new_alive), ptr(mis_add), nbr, T, stream(dev),
    ))
    if alive_words is None:
        return hit
    return hit, new_alive, mis_add


def _fake_spmv(tiled: BlockTiledGraph, rhs: torch.Tensor, col_flags) -> torch.Tensor:
    """The split SpMV's fake branch: an empty (nbr·T, L) f32 n_c, and the
    launch's bytes and FLOPs by its bound's arithmetic (`chip_smoke.py`
    `bound_spmv`) with every column active, since a fake tensor holds no
    flags: the real tiles and the RHS slabs of the columns they reach read
    once, the tile schedule and flags read, n_c written; a multiply-add per
    cell of every real tile per lane, as the tensor cores do them."""
    T, nbr, nbc, nt = tiled.tile_size, tiled.n_block_rows, tiled.n_block_cols, tiled.n_tiles
    L = int(rhs.shape[1])
    tile_bytes = tiled.tiles[0].numel() * tiled.tiles.element_size()
    nbytes = (nt * tile_bytes + (tiled.tile_cols.numel() + tiled.row_starts.numel()) * 4
              + (0 if col_flags is None else col_flags.numel() * 4)
              + min(nt, nbc) * T * L * rhs.element_size() + nbr * T * L * 4)
    report("tc_spmv", nbytes, 2.0 * nt * T * T * L)
    return torch.empty((nbr * T, L), dtype=torch.float32, device=rhs.device)


# --------------------------------------------------------------------------
# the wrappers
# --------------------------------------------------------------------------

def tc_spmv(
    tiled: BlockTiledGraph,
    rhs: torch.Tensor,
    *,
    col_flags: Optional[torch.Tensor] = None,
    skip_dma: bool = False,
) -> torch.Tensor:
    """Phase ②: N = A × rhs on the block-tiled adjacency, (nbr·T, L) f32."""
    del skip_dma
    if fake(tiled.tiles, rhs, col_flags):
        return _fake_spmv(tiled, rhs, col_flags)
    if on_cpu(tiled.tiles, rhs, col_flags):
        return tc_spmv_plain(tiled, rhs, col_flags=col_flags)
    out = _launch(tiled, rhs, col_flags, None)
    tc_spmv.launches += 1
    return out


def tc_spmv_fused(
    tiled: BlockTiledGraph,
    rhs: torch.Tensor,
    cand: torch.Tensor,
    alive: torch.Tensor,
    *,
    col_flags: Optional[torch.Tensor] = None,
    skip_dma: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phases ②+③ in one pass: (n_c, new_alive, mis_add)."""
    del skip_dma
    if on_cpu(tiled.tiles, rhs, cand, alive, col_flags):
        return tc_spmv_fused_plain(tiled, rhs, cand, alive, col_flags=col_flags)
    out = _launch(tiled, rhs, col_flags, (cand, alive))
    tc_spmv_fused.launches += 1
    return out


def tc_spmv_bits(
    tiled: BlockTiledGraph,
    cand_words: torch.Tensor,
    *,
    tiles_words: Optional[torch.Tensor] = None,
    col_flags: Optional[torch.Tensor] = None,
    skip_dma: bool = False,
) -> torch.Tensor:
    """Phase ② on packed words: hit = (A × C) > 0, (nbr, W) int32."""
    del skip_dma
    tiles_words = _words(tiled, tiles_words)
    if on_cpu(tiles_words, cand_words, col_flags):
        return tc_spmv_bits_plain(tiled, cand_words, tiles_words=tiles_words,
                                  col_flags=col_flags)
    out = _launch_bits(tiled, tiles_words, cand_words, None, col_flags)
    tc_spmv_bits.launches += 1
    return out


def tc_spmv_fused_bits(
    tiled: BlockTiledGraph,
    cand_words: torch.Tensor,
    alive_words: torch.Tensor,
    *,
    tiles_words: Optional[torch.Tensor] = None,
    col_flags: Optional[torch.Tensor] = None,
    skip_dma: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phases ②+③ on packed words: (hit, new_alive, mis_add) words."""
    del skip_dma
    tiles_words = _words(tiled, tiles_words)
    if on_cpu(tiles_words, cand_words, alive_words, col_flags):
        return tc_spmv_fused_bits_plain(tiled, cand_words, alive_words,
                                        tiles_words=tiles_words, col_flags=col_flags)
    out = _launch_bits(tiled, tiles_words, cand_words, alive_words, col_flags)
    tc_spmv_fused_bits.launches += 1
    return out


tc_spmv.launches = 0
tc_spmv_fused.launches = 0
tc_spmv_bits.launches = 0
tc_spmv_fused_bits.launches = 0
