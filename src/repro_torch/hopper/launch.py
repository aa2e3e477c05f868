"""What every Hopper kernel wrapper shares: the device rule, argument
checks, the fake branch's test and report, and the ctypes binding of a
built library's C entry point.

A wrapper runs its plain-torch version only when every tensor it was
given lies on the CPU; for CUDA tensors it checks what the kernel relies
on (device, dtype, shape, contiguity), launches on the current stream and
raises on a nonzero `cudaError_t`.  Nothing falls back.

Given fake tensors (the dry run's, `torch._subclasses.fake_tensor`), a
wrapper with a fake branch (`fake`) returns empty outputs of its kernel's
shapes and dtypes and reports the launch's bytes and FLOPs
(`report`); it neither launches nor runs its plain version.  A wrapper
without one refuses fake tensors (`on_cpu` raises).  `fake`,
`fake_mode` and `outside_fake_mode` are the port's one use of that
private module: the dry run and the code it reaches call these.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode, unset_fake_temporarily

TILE_SIZES = (8, 16, 32, 64, 128)


def fake(*tensors) -> bool:
    """True iff a given tensor is a fake tensor: the dry run's."""
    return any(isinstance(t, FakeTensor) for t in tensors)


def fake_mode() -> FakeTensorMode:
    """A new mode whose tensors are fake: shapes, dtypes and devices only."""
    return FakeTensorMode()


def outside_fake_mode():
    """A context in which tensors made are real, inside a fake mode too."""
    return unset_fake_temporarily()


def report(name: str, nbytes: float, flops: float) -> None:
    """A fake branch's launch, to the dry run's counting mode: the bytes
    its kernel moves (each input read once, each output written once) and
    the operations it does, the arithmetic of its bound."""
    from repro_torch.perf.counting import record_kernel

    record_kernel(name, nbytes, flops)


def on_cpu(*tensors) -> bool:
    """True iff every given tensor lies on the CPU; raises on a mix, and on
    fake tensors (a wrapper with a fake branch tests `fake` first)."""
    if fake(*tensors):
        raise ValueError("fake tensors reached a kernel wrapper without a fake branch")
    devices = {t.device.type for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(devices)}")
    return devices == {"cpu"}


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless `t` is on `device`, of `dtype` (or one of a tuple), of
    `shape`, and contiguous."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_tiling(tiled, device: torch.device) -> None:
    """The tile schedule every kernel walks: CUDA tensors, a supported T,
    `tile_cols` (nt,) and `row_starts` (nbr + 1,) int32."""
    if device.type != "cuda":
        raise ValueError(f"the Hopper kernel needs CUDA tensors, got {device}")
    if tiled.tile_size not in TILE_SIZES:
        raise ValueError(f"tile size {tiled.tile_size} not supported; valid: {TILE_SIZES}")
    check("tile_cols", tiled.tile_cols, torch.int32, (tiled.n_tiles_pad,), device)
    check("row_starts", tiled.row_starts, torch.int32, (tiled.n_block_rows + 1,), device)


def check_aligned(name: str, t: torch.Tensor) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def entry(library: str, symbol: str, argtypes: Sequence):
    """The C function `symbol` of csrc/<library>.cu, built on first use,
    with its argument types set (pointers as c_void_p, so none is cut to
    32 bits) and an int (`cudaError_t`) result."""
    from repro_torch.hopper.build import library as load

    fn = getattr(load(library), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
