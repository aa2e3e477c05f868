"""Threefry-2x32 random bits on Hopper: the wrapper, the plain version,
the launch count.

  threefry_bits  element i of a draw under a key, from a start counter:
                 `jax.random.bits`' uint32 word (as int32), or
                 `jax.random.uniform`'s f32 in [minval, maxval) from it,
                 or `jax.random.normal`'s f32 from the uniform on
                 (-1, 1).  Replaces no Pallas kernel: it is the
                 counterpart of XLA's lowering of `threefry2x32_p` and of
                 the elementwise ops JAX puts after it.

The kernel lives in `csrc/threefry.cu`.  The wrapper allocates the output
on the device it is asked for; where that tensor lies on the CPU it runs
the plain version below (what the CPU tests use and `chip_smoke.py` holds
the kernel against), on a CUDA tensor it launches the kernel or raises,
on a fake tensor (the dry run's) it reports the launch and returns the
empty output, and on the meta device (shapes only: a module built there
draws nothing) it returns the empty output and reports nothing.  Launches
count in `threefry_bits.launches`.

`threefry2x32` is the hash itself, written with operators that Python
ints and int64 tensors share, so `core.prng` derives keys with it on the
host (no device work, no sync); the plain version runs the same rounds in
place on int64 tensors (`_hash_into`, with no temporary a round).
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import struct
from typing import Optional

import numpy as np
import torch

from repro_torch.hopper.launch import entry, fake, on_cpu, ptr, raise_on_error, report, stream

MASK32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
MODES = {"bits": 0, "uniform": 1, "normal": 2}
# 32-bit operations an element: 2 for the 64-bit counter start + i, 2 adds
# for the counter and key, 20 rounds of add / rotate / xor, 5 injections
# of 2 adds, the final xor; the uniform's shift, or and subtract, then
# its scale's FMA and max on top; the normal's square, two negations,
# log1p, compare, the branch's subtract (or sqrt and subtract, counted as
# the cheaper), 8 Horner steps of a multiply and an add and the two
# products on top of the uniform's
OPS_PER_ELEMENT = {"bits": 75, "uniform": 80, "normal": 104}
# `jax.random.normal`'s uniform on (-1, 1): minval nextafter(-1, 0) and
# maxval 1, whose f32 difference rounds to 2
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2 = float(np.float32(np.sqrt(2.0)))
# XLA's single-precision erf_inv (Giles), Horner from the highest degree:
# on w - 2.5 where w = -log1p(-x^2) < 5, else on sqrt(w) - 3
ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
# the plain version hashes this many counters at a time: (on the card,
# on the CPU)
_CHUNK = (1 << 22, 1 << 16)


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


def _hash_into(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor, t: torch.Tensor) -> None:
    """`threefry2x32` on int64 tensors in place (x0 ends as b1 ^ b2); `t`
    is scratch of their shape."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0.add_(ks[0]).bitwise_and_(MASK32)
    x1.add_(ks[1]).bitwise_and_(MASK32)
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK32)
            torch.bitwise_right_shift(x1, 32 - r, out=t)
            x1.bitwise_left_shift_(r).bitwise_and_(MASK32).bitwise_or_(t).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK32)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(MASK32)
    x0.bitwise_xor_(x1)


def _as_int32(u: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 with the same bits."""
    return (u - ((u >> 31) << 32)).to(torch.int32)


def _f32(x: float) -> float:
    """x rounded to f32 (a host float; no array is made)."""
    return struct.unpack("f", struct.pack("f", x))[0]


def scale_of(minval: float, maxval: float) -> float:
    """The uniform's f32 scale, maxval - minval rounded as JAX takes it
    (the f32 difference: the f64 one of two f32 values rounds to it)."""
    return _f32(_f32(maxval) - _f32(minval))


def erf_inv_plain(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 `erf_inv` (Giles), every product and sum rounded on its
    own: the form `csrc/threefry.cu` computes, for |x| < 1."""
    w = -torch.log1p(-(x * x))
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    f32 = dict(dtype=torch.float32, device=x.device)
    p = torch.where(small, torch.tensor(ERFINV_SMALL[0], **f32),
                    torch.tensor(ERFINV_LARGE[0], **f32))
    for a, b in zip(ERFINV_SMALL[1:], ERFINV_LARGE[1:]):
        p = torch.where(small, torch.tensor(a, **f32), torch.tensor(b, **f32)) + p * w
    return p * x


def _exact_scale(scale: float) -> bool:
    """Whether f * scale is exact in f32 for every f in [0, 1) (a power of
    two: the normal's 2, the [0, 1) and Gumbel uniforms' 1), so that f32
    ops round f * scale + lo once, as an FMA does."""
    return scale > 0 and math.frexp(scale)[0] == 0.5


def fma_plain(f: torch.Tensor, scale: float, lo: float) -> torch.Tensor:
    """f * scale + lo rounded once to f32, as an FMA rounds it: in f32
    where the product is exact, else the product exact in f64, the sum
    taken there with round-to-odd (its exact error by TwoSum nudges an
    inexact even result one ulp toward it), and the f64 result rounded to
    f32 correctly."""
    if _exact_scale(scale):
        return f * scale + lo
    p = f.double() * scale
    s = p + lo
    bb = s - p
    err = (p - (s - bb)) + (lo - bb)
    nudge = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where(nudge, torch.nextafter(s, toward), s).float()


def threefry_bits_plain(k0: int, k1: int, out: torch.Tensor, mode: str = "bits", *,
                        start: int = 0, minval: float = 0.0, maxval: float = 1.0
                        ) -> torch.Tensor:
    """Plain version: fills `out` ((n,) int32 for "bits", f32 for
    "uniform" and "normal") with element i's draw, the hash of the 64-bit
    counter start + i split into (hi, lo) words, hashed in place in int64
    as torch ops on `out`'s device, `_CHUNK` counters at a time.  The
    uniform is max(minval, f * scale + minval) with f in [0, 1) and scale
    `scale_of(minval, maxval)`, one rounding (`fma_plain`: XLA fuses the
    two into an FMA); the normal is SQRT2 * `erf_inv_plain` of the uniform
    on [NORMAL_LO, 1).  On the CPU it runs in one thread: a draw is a few
    hundred small ops, which wait on the intra-op pool when several
    processes share the cores."""
    if mode == "normal":
        minval, maxval = NORMAL_LO, 1.0
    lo, scale = _f32(minval), scale_of(minval, maxval)
    with _one_thread(out.device):
        n, chunk = out.numel(), _CHUNK[out.device.type == "cpu"]
        flat = out.view(-1)
        m = min(n, chunk)
        x0, x1, t = (torch.empty(m, dtype=torch.int64, device=out.device) for _ in range(3))
        for first in range(0, n, chunk):
            c = min(chunk, n - first)
            a, b, s = x0[:c], x1[:c], t[:c]
            counter = start + first
            torch.arange(counter & MASK32, (counter & MASK32) + c, out=b)
            torch.bitwise_right_shift(b, 32, out=a).add_(counter >> 32)
            b.bitwise_and_(MASK32)
            _hash_into(k0, k1, a, b, s)
            if mode == "bits":
                flat[first:first + c] = _as_int32(a)
                continue
            f = _as_int32(a.bitwise_right_shift_(9).bitwise_or_(0x3F800000)).view(
                torch.float32) - 1.0
            u = torch.clamp_min(fma_plain(f, scale, lo), lo)
            flat[first:first + c] = u if mode == "uniform" else SQRT2 * erf_inv_plain(u)
    return out


@contextlib.contextmanager
def _one_thread(device: torch.device):
    """torch's intra-op pool cut to one thread while on the CPU."""
    if device.type != "cpu":
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _launch(k0: int, k1: int, out: torch.Tensor, mode: str, start: int, minval: float,
            scale: float) -> None:
    dev = out.device
    if dev.type != "cuda":
        raise ValueError(f"the Hopper kernel needs a CUDA tensor, got {dev}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    fn = entry("threefry", "threefry_launch",
               [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_ulonglong, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                ctypes.c_void_p])
    raise_on_error("threefry", fn(k0, k1, start, out.numel(), MODES[mode], minval, scale,
                                  ptr(out), stream(dev)))


def threefry_bits(k0: int, k1: int, n: int, device, mode: str = "bits", *, start: int = 0,
                  minval: float = 0.0, maxval: float = 1.0,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Element i in [0, n) of the draw under the key (k0, k1) from the
    counter `start`, on `device`: (n,) int32 bits, (n,) f32 uniforms in
    [minval, maxval) ("uniform"), or (n,) f32 standard normals ("normal",
    which takes no range).  start + n <= 2^64, JAX's own limit.  With
    `out` (a contiguous (n,) tensor of that dtype) the draw is written
    there, on its device, and nothing is allocated."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; options {list(MODES)}")
    if n < 0 or start < 0 or start + n > 1 << 64:
        raise ValueError(f"a draw's counters run from 0 to 2^64: asked start {start}, n {n}")
    if not (0 <= k0 <= MASK32 and 0 <= k1 <= MASK32):
        raise ValueError(f"key words must be uint32, got ({k0}, {k1})")
    dtype = torch.int32 if mode == "bits" else torch.float32
    if out is None:
        out = torch.empty((n,), dtype=dtype, device=device)
    elif out.dtype != dtype or tuple(out.shape) != (n,) or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous ({n},) {dtype} tensor, got "
                         f"{tuple(out.shape)} {out.dtype}")
    if fake(out):
        report("threefry", 4.0 * n, float(OPS_PER_ELEMENT[mode] * n))
        return out
    if out.device.type == "meta":
        return out
    if on_cpu(out):
        return threefry_bits_plain(k0, k1, out, mode, start=start, minval=minval,
                                   maxval=maxval)
    if n:
        if mode == "normal":
            minval, maxval = NORMAL_LO, 1.0
        _launch(k0, k1, out, mode, start, _f32(minval), scale_of(minval, maxval))
        threefry_bits.launches += 1
    return out


threefry_bits.launches = 0
