"""Threefry-2x32 random bits on Hopper: the wrapper, the plain version,
the launch count.

  threefry_bits  element i of a draw under a key: `jax.random.bits`'
                 uint32 word (as int32), or `jax.random.uniform`'s [0, 1)
                 f32 from it.  Replaces no Pallas kernel: it is the
                 counterpart of XLA's lowering of `threefry2x32_p`.

The kernel lives in `csrc/threefry.cu`.  The wrapper allocates the output
on the device it is asked for; where that tensor lies on the CPU it runs
the plain version below (what the CPU tests use and `chip_smoke.py` holds
the kernel against), on a CUDA tensor it launches the kernel or raises,
and on a fake tensor (the dry run's) it reports the launch and returns
the empty output.  Launches count in `threefry_bits.launches`.

`threefry2x32` is the hash itself, written with operators that Python
ints and int64 tensors share, so `core.prng` derives keys with it on the
host (no device work, no sync) and the plain version runs it elementwise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.hopper.launch import entry, fake, on_cpu, ptr, raise_on_error, report, stream

MASK32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
MODES = {"bits": 0, "uniform": 1}
# 32-bit operations an element: 2 adds for the counter and key, 20 rounds
# of add / rotate / xor, 5 injections of 2 adds, the final xor; the
# uniform's shift, or and subtract on top
OPS_PER_ELEMENT = {"bits": 73, "uniform": 76}


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counter words (x0, x1) under the key (k0, k1),
    as JAX's `_threefry2x32_lowering`.  Ints or int64 tensors holding
    values in [0, 2^32); returns the two hashed words alike."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = (((x1 << r) & MASK32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def _as_int32(u: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same bits."""
    return (u - ((u >> 31) << 32)).to(torch.int32)


def threefry_bits_plain(k0: int, k1: int, out: torch.Tensor, mode: str = "bits") -> torch.Tensor:
    """Plain-torch version: fills `out` ((n,) int32 for "bits", f32 for
    "uniform") with element i's draw, the counter's high word i >> 32."""
    n = out.numel()
    i = torch.arange(n, dtype=torch.int64, device=out.device)
    b1, b2 = threefry2x32(k0, k1, i >> 32, i & MASK32)
    u = b1 ^ b2
    if mode == "bits":
        return out.copy_(_as_int32(u))
    one = _as_int32((u >> 9) | 0x3F800000).view(torch.float32)
    return out.copy_(one - 1.0)


def _launch(k0: int, k1: int, out: torch.Tensor, mode: str) -> None:
    dev = out.device
    if dev.type != "cuda":
        raise ValueError(f"the Hopper kernel needs a CUDA tensor, got {dev}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    fn = entry("threefry", "threefry_launch",
               [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p])
    raise_on_error("threefry", fn(k0, k1, out.numel(), MODES[mode], ptr(out), stream(dev)))


def threefry_bits(k0: int, k1: int, n: int, device, mode: str = "bits") -> torch.Tensor:
    """Element i in [0, n) of the draw under the key (k0, k1), on `device`:
    (n,) int32 bits, or (n,) f32 uniforms in [0, 1).  n < 2^32."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options {list(MODES)}")
    if not 0 <= n < 1 << 32:
        raise ValueError(f"a draw holds fewer than 2^32 elements, asked {n}")
    if not (0 <= k0 <= MASK32 and 0 <= k1 <= MASK32):
        raise ValueError(f"key words must be uint32, got ({k0}, {k1})")
    dtype = torch.int32 if mode == "bits" else torch.float32
    out = torch.empty((n,), dtype=dtype, device=device)
    if fake(out):
        report("threefry", 4.0 * n, float(OPS_PER_ELEMENT[mode] * n))
        return out
    if on_cpu(out):
        return threefry_bits_plain(k0, k1, out, mode)
    if n:
        _launch(k0, k1, out, mode)
        threefry_bits.launches += 1
    return out


threefry_bits.launches = 0
