"""The reference's seeded draws: `jax.random`'s threefry2x32 stream, the
part of it that the reference calls (counterpart of `jax.random` as
`repro` calls it: the MIS priorities, the samplers, the model inits, LM
sampling and the smoke inputs).

A `Key` is the two uint32 words of `jax.random.key_data(key)`, held on the
host as Python ints: deriving keys (`key`, `split`, `fold_in`) hashes on
the host and never touches the device.  A draw (`bits`, `uniform`,
`randint`, `normal`, `gumbel`, `categorical`, `permutation`) hashes its
counters on the device through the Threefry kernel (`hopper.threefry`),
the plain version on the CPU.  Integer and uniform draws give the
reference's numbers bit for bit, on the CPU and on the card alike; those
through `erf_inv` (`normal`) or `log` (`gumbel`) within a few ulp, since
XLA's `log1p` and `log` are not torch's or the card's.

A draw of a shape is the flat draw of its size reshaped row-major: element
j hashes the counter j, as JAX's `iota_2x32_shape` numbers a shape.  Every
draw takes `start`, the counter of its first element, so a block of a
leaf, or one rank's rows of a global draw, is the same numbers drawn
alone.

Only JAX's partitionable mode is implemented (`jax_threefry_partitionable`,
True by default since JAX 0.5), with 64-bit types off (JAX's default):
`key(seed)` takes the seed modulo 2^32 as its low word, as `jax.random.key`
does when the seed converts to int32.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.hopper.threefry import MASK32, threefry2x32, threefry_bits

_INT32_MIN = -(1 << 31)
_INT32_MAX = (1 << 31) - 1
_F32_TINY = float(np.finfo(np.float32).tiny)
# `normal_into` draws this many elements at a time, in f32
FILL_BLOCK = 1 << 26
Shape = Union[int, Sequence[int]]


class Key(NamedTuple):
    """A threefry key: `jax.random.key_data(key)` as (k0, k1)."""
    k0: int
    k1: int


def key(seed: int) -> Key:
    """`jax.random.key(seed)`: the seed converts to int32 (64-bit types
    off), so the high word is 0 and the low word is `seed mod 2^32`."""
    return Key(0, int(seed) & MASK32)


def split(k: Key, num: int = 2) -> List[Key]:
    """`jax.random.split(k, num)`, the partitionable "foldlike" split:
    key i is the hash of the counter (0, i)."""
    return [Key(*threefry2x32(k.k0, k.k1, 0, i)) for i in range(num)]


def fold_in(k: Key, data: int) -> Key:
    """`jax.random.fold_in(k, data)`: the hash of the block (0, data),
    `data` taken modulo 2^32 as JAX's uint32 conversion takes it."""
    return Key(*threefry2x32(k.k0, k.k1, 0, int(data) & MASK32))


def _size(n: Shape) -> Tuple[int, Tuple[int, ...]]:
    """(element count, output shape) of a draw's `n`: an int or a shape."""
    shape = (int(n),) if isinstance(n, (int, np.integer)) else tuple(int(d) for d in n)
    return int(np.prod(shape, dtype=np.int64)) if shape else 1, shape


def _draw(k: Key, n: Shape, device, mode: str, start: int, **kw) -> torch.Tensor:
    count, shape = _size(n)
    return threefry_bits(k.k0, k.k1, count, device, mode, start=start, **kw).view(shape)


def bits(k: Key, n: Shape, device, *, start: int = 0) -> torch.Tensor:
    """`jax.random.bits(k, shape)` (uint32) as int32 of the same bits.  A
    shape's draw is the flat draw of its size, row-major; `start` is the
    first element's counter (the flat draw from `start` on), so a block of
    a larger draw is drawn alone."""
    return _draw(k, n, device, "bits", start)


def uniform(k: Key, n: Shape, device, minval: float = 0.0, maxval: float = 1.0, *,
            start: int = 0) -> torch.Tensor:
    """`jax.random.uniform(k, shape, minval=, maxval=)`: f32 in [minval,
    maxval), the bits' top 23 as the mantissa of a float f in [1, 2),
    minus 1, then max(minval, f * (maxval - minval) + minval) in f32,
    rounded once: XLA fuses the product and the sum into one FMA."""
    return _draw(k, n, device, "uniform", start, minval=minval, maxval=maxval)


def normal(k: Key, n: Shape, device, *, start: int = 0) -> torch.Tensor:
    """`jax.random.normal(k, shape)` (f32): sqrt(2) * erf_inv(u), u the
    uniform on [nextafter(-1, 0), 1), erf_inv XLA's single-precision
    polynomial.  Within a few ulp of the reference (XLA's log1p is not
    the card's or torch's), not bit for bit."""
    return _draw(k, n, device, "normal", start)


def normal_into(k: Key, out: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """`(normal(k, out.shape) * scale).astype(out.dtype)`, the reference's
    init of a leaf (`_dense`, `mlp_init`, the DeepFM tables), drawn into
    `out` FILL_BLOCK elements at a time, each block from its start counter:
    an f32 leaf's blocks are drawn and scaled in place, another dtype's
    in an f32 block that is then cast into it, so a full-width leaf never
    needs its whole f32 copy at once."""
    flat = out.view(-1)
    for lo in range(0, flat.numel(), FILL_BLOCK):
        hi = min(lo + FILL_BLOCK, flat.numel())
        if out.dtype == torch.float32:
            threefry_bits(k.k0, k.k1, hi - lo, out.device, "normal", start=lo,
                          out=flat[lo:hi]).mul_(scale)
        else:
            flat[lo:hi] = normal(k, hi - lo, out.device, start=lo).mul_(scale)
    return out


def gumbel(k: Key, n: Shape, device, *, start: int = 0) -> torch.Tensor:
    """`jax.random.gumbel(k, shape)` in JAX's default mode "low" (f32):
    -log(-log(u)), u the uniform on [tiny, 1)."""
    u = uniform(k, n, device, _F32_TINY, 1.0, start=start)
    return -torch.log(-torch.log(u))


def categorical(k: Key, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(k, logits)` over the last axis (with
    replacement): argmax of logits + `gumbel(k, logits.shape)`, the first
    index among ties, as int32 of the batch shape."""
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical draws f32 Gumbel noise; logits are {logits.dtype}")
    g = gumbel(k, tuple(logits.shape), logits.device)
    return torch.argmax(g + logits, dim=-1).to(torch.int32)


def randint(k: Key, n: Shape, lo: int, hi: int, device, *, start: int = 0) -> torch.Tensor:
    """`jax.random.randint(k, shape, lo, hi, dtype=jnp.int32)`: two bit
    streams from `split(k)`, combined modulo the span with every step
    wrapping at 32 bits as JAX's uint32 arithmetic does (bounds in int32,
    as JAX takes them with 64-bit types off).  When the
    multiplier `(2^16 mod span)^2 mod span` wraps to 0 (Luby's span 2^31 -
    1) the high stream cannot reach the result and is not drawn."""
    if not _INT32_MIN <= lo <= _INT32_MAX or not _INT32_MIN <= hi <= _INT32_MAX:
        raise ValueError(f"randint's bounds must be int32, got [{lo}, {hi})")
    span = (hi - lo) & MASK32 if hi > lo else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & MASK32) % span
    k1, k2 = split(k)
    lower = bits(k2, n, device, start=start).to(torch.int64) & MASK32
    offset = torch.remainder(lower, span)
    if mult:
        high = torch.remainder(bits(k1, n, device, start=start).to(torch.int64) & MASK32, span)
        offset = torch.remainder((((high * mult) & MASK32) + offset) & MASK32, span)
    value = (offset + lo) & MASK32
    return (value - ((value >> 31) << 32)).to(torch.int32)


def permutation_rounds(n: int) -> int:
    """The sort rounds of `jax.random.permutation` over n elements: the
    reference's static stop criterion, ceil(3 ln n / ln(2^32 - 1))."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(k: Key, n: int, device) -> torch.Tensor:
    """`jax.random.permutation(k, jnp.arange(n, dtype=jnp.int32))`: each
    round splits the key, draws 32-bit sort keys under the second half and
    sorts by them, stably (`lax.sort_key_val` is stable), as unsigned
    words: the int32 view with its sign bit flipped orders the same."""
    x = torch.arange(n, dtype=torch.int32, device=device)
    for _ in range(permutation_rounds(n)):
        k, sub = split(k)
        sort_keys = bits(sub, n, device) ^ _INT32_MIN
        x = x[torch.sort(sort_keys, stable=True).indices]
    return x
