"""The reference's seeded draws: `jax.random`'s threefry2x32 stream, the
part of it that the MIS code uses (counterpart of `jax.random` as
`repro.core` calls it).

A `Key` is the two uint32 words of `jax.random.key_data(key)`, held on the
host as Python ints: deriving keys (`key`, `split`, `fold_in`) hashes on
the host and never touches the device.  A draw (`bits`, `uniform`,
`randint`, `permutation`) hashes its counters on the device through the
Threefry kernel (`hopper.threefry`), the plain version on the CPU, and
gives the reference's numbers bit for bit, on the CPU and on the card
alike.

Only JAX's partitionable mode is implemented (`jax_threefry_partitionable`,
True by default since JAX 0.5), with 64-bit types off (JAX's default):
`key(seed)` takes the seed modulo 2^32 as its low word, as `jax.random.key`
does when the seed converts to int32.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from repro_torch.hopper.threefry import MASK32, threefry2x32, threefry_bits

_INT32_MIN = -(1 << 31)
_INT32_MAX = (1 << 31) - 1


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


def bits(k: Key, n: int, device) -> torch.Tensor:
    """`jax.random.bits(k, (n,))` (uint32) as (n,) int32 of the same bits."""
    return threefry_bits(k.k0, k.k1, n, device, "bits")


def uniform(k: Key, n: int, device) -> torch.Tensor:
    """`jax.random.uniform(k, (n,))`: (n,) f32 in [0, 1), the bits' top 23
    as the mantissa of a float in [1, 2), minus 1."""
    return threefry_bits(k.k0, k.k1, n, device, "uniform")


def randint(k: Key, n: int, lo: int, hi: int, device) -> torch.Tensor:
    """`jax.random.randint(k, (n,), lo, hi, dtype=jnp.int32)`: two bit
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
    lower = bits(k2, n, device).to(torch.int64) & MASK32
    offset = torch.remainder(lower, span)
    if mult:
        high = torch.remainder(bits(k1, n, device).to(torch.int64) & MASK32, span)
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
