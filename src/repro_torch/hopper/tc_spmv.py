"""Block-tiled SpMV on Hopper: wrappers, plain versions, launch counts.

`tc_spmv_fused` (phases ②+③) and `tc_spmv` (phase ②) return what the
reference's `repro.kernels.ops.tc_spmv_fused` / `ops.tc_spmv` return.  On
CUDA tensors they launch the kernels of `csrc/tc_spmv.cu` (which replace
the Pallas `_spmv_fused_kernel` and `_spmv_kernel`) on the current stream,
or raise; on CPU tensors they run the plain-torch versions below, which
the CPU parity tests use and `chip_smoke.py` holds the kernels against.
Each wrapper counts its kernel launches in `<wrapper>.launches`.

Inputs (T = tile size, L = lanes, nbr/nbc = block rows/cols):
  tiled.tiles   (nt, T, T) int8, or (nt, T, W) int32 words (bitpack)
  rhs           (nbc·T, L) float32 (bfloat16 for the split kernel too)
  cand, alive   (nbr·T,) bool — fused only
  col_flags     (nbc,) int32 or None; a tile in a column flagged 0 adds
                nothing on any lane
Outputs: n_c (nbr·T, L) float32; fused adds new_alive and mis_add, (nbr·T,)
bool.  Rows no tile maps to come out as n_c = 0, new_alive = alive & ~cand,
mis_add = cand (the reference wrapper's patched epilogue).

`skip_dma` is accepted for parity: the kernels never load a gated tile or
slab, so both settings run the same code.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.engine import tile_spmv
from repro_torch.core.tiling import BlockTiledGraph, packed_words

TILE_SIZES = (8, 16, 32, 64, 128)
SMEM_LIMIT = 232_448     # dynamic shared memory one H100 block may use


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


# --------------------------------------------------------------------------
# the kernel launch
# --------------------------------------------------------------------------

def _lib():
    from repro_torch.hopper.build import library

    lib = library("tc_spmv")
    fn = lib.tc_spmv_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, i, p, p, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(tiled: BlockTiledGraph, rhs: torch.Tensor, col_flags, fused_io) -> torch.Tensor:
    """Validate everything the kernel relies on, allocate, launch, raise on
    a nonzero cudaError_t.  `fused_io` is (cand, alive) or None."""
    T, nbr, nbc = tiled.tile_size, tiled.n_block_rows, tiled.n_block_cols
    dev = tiled.tiles.device
    if dev.type != "cuda":
        raise ValueError(f"the Hopper kernel needs CUDA tensors, got {dev}")
    if T not in TILE_SIZES:
        raise ValueError(f"tile size {T} not supported; valid: {TILE_SIZES}")
    nt = tiled.n_tiles_pad
    packed = tiled.tiles.dtype == torch.int32
    cell_shape = (T, packed_words(T)) if packed else (T, T)
    _check("tiles", tiled.tiles, (torch.int8, torch.int32), (nt,) + cell_shape, dev)
    if tiled.tiles.data_ptr() % 16:
        raise ValueError("tiles must be 16-byte aligned")
    _check("tile_cols", tiled.tile_cols, torch.int32, (nt,), dev)
    _check("row_starts", tiled.row_starts, torch.int32, (nbr + 1,), dev)
    if rhs.ndim != 2:
        raise ValueError(f"rhs must be (nbc*T, L), got shape {tuple(rhs.shape)}")
    L = int(rhs.shape[1])
    if L < 2:
        raise ValueError(f"lanes must be >= 2, got {L}")
    _check("rhs", rhs, (torch.float32, torch.bfloat16), (nbc * T, L), dev)
    if fused_io is not None and rhs.dtype != torch.float32:
        raise TypeError("the fused kernel takes a float32 rhs")
    smem = 8 * T * L + (T * packed_words(T) * 4 if packed else T * T)
    if smem > SMEM_LIMIT:
        raise ValueError(f"T={T}, lanes={L} needs {smem} B of shared memory "
                         f"(> {SMEM_LIMIT})")
    if col_flags is not None:
        _check("col_flags", col_flags, torch.int32, (nbc,), dev)

    n_c = torch.empty((nbr * T, L), dtype=torch.float32, device=dev)
    cand = alive = new_alive = mis_add = None
    if fused_io is not None:
        cand, alive = fused_io
        _check("cand", cand, torch.bool, (nbr * T,), dev)
        _check("alive", alive, torch.bool, (nbr * T,), dev)
        new_alive = torch.empty_like(alive)
        mis_add = torch.empty_like(cand)
    err = _lib()(
        _ptr(tiled.tiles), int(packed), _ptr(tiled.row_starts),
        _ptr(tiled.tile_cols), _ptr(col_flags), _ptr(rhs),
        int(rhs.dtype == torch.bfloat16), _ptr(n_c), _ptr(cand), _ptr(alive),
        _ptr(new_alive), _ptr(mis_add), nbr, T, L,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"tc_spmv kernel launch failed: cudaError_t {err}")
    if fused_io is None:
        return n_c
    return n_c, new_alive, mis_add


def _on_cpu(*tensors) -> bool:
    devices = {t.device.type for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(devices)}")
    return devices == {"cpu"}


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
    if _on_cpu(tiled.tiles, rhs, col_flags):
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
    if _on_cpu(tiled.tiles, rhs, cand, alive, col_flags):
        return tc_spmv_fused_plain(tiled, rhs, cand, alive, col_flags=col_flags)
    out = _launch(tiled, rhs, col_flags, (cand, alive))
    tc_spmv_fused.launches += 1
    return out


tc_spmv.launches = 0
tc_spmv_fused.launches = 0
