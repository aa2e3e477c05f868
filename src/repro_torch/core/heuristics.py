"""Priority heuristics H1/H2/H3 and ECL's Eq. (1) (counterpart of
`repro.core.heuristics`).

All heuristics give int32 total orders: the high bits carry the quantised
Eq. 1 structural bias, the low 23 bits a random permutation of vertex ids
(H3 instead resolves ties with a deterministic `resolve` key).  Randomness
comes from a `core.prng` key, split and drawn as the reference splits and
draws its `jax.random` key, so one key gives the reference's priorities
bit for bit.  Eq. 1's d̄ is an f32 mean, exact (so equal whatever the
order of the sum) while the degrees sum below 2^24.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import prng
from repro_torch.core.prng import Key

_LOW_BITS = 23
_INT32_SPAN = 1 << 32


class Priorities(NamedTuple):
    """Total-order priorities plus (for H3) the two-pass resolution key.

    select:  (n,) int32 — used for the phase-① candidate test.
    resolve: optional (n,) int32 — when set, candidate generation runs the
             H3 two-pass: pending by quantised `select`, finalise by strict
             `resolve` order among pending vertices.
    """
    select: torch.Tensor
    resolve: Optional[torch.Tensor] = None


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound (jnp int32 math)."""
    return torch.remainder(x + (1 << 31), _INT32_SPAN).sub(1 << 31).to(torch.int32)


def eq1_quantized(deg: torch.Tensor, key: Key, bits: int) -> torch.Tensor:
    """Paper Eq. (1): P(v) = d̄ / (d̄ + deg(v) − ε(v)), discretised to `bits`."""
    deg_f = deg.to(torch.float32)
    dbar = deg_f.mean()
    eps = prng.uniform(key, deg.shape[0], deg.device)
    p = dbar / (dbar + deg_f - eps)
    levels = (1 << bits) - 1
    return torch.clamp((p * levels).to(torch.int32), 0, levels)


def h1_priorities(key: Key, n: int, deg: torch.Tensor) -> Priorities:
    """H1: random priority — maximal parallelism, no structural bias."""
    return Priorities(select=prng.permutation(key, n, deg.device))


def h2_priorities(key: Key, n: int, deg: torch.Tensor) -> Priorities:
    """H2: coarse 4-bit degree-aware priority, ties broken by chance."""
    kq, kp = prng.split(key)
    q = eq1_quantized(deg, kq, bits=4)
    return Priorities(select=(q << _LOW_BITS) | prng.permutation(kp, n, deg.device))


def h3_priorities(key: Key, n: int, deg: torch.Tensor) -> Priorities:
    """H3: fine 8-bit degree-aware priority + ordered conflict resolution.

    `resolve` is the deterministic key (lower degree wins, then lower id),
    computed as `-deg·n - id` in int32 with the reference's wraparound."""
    kq, _ = prng.split(key)
    q = eq1_quantized(deg, kq, bits=8)
    ids = torch.arange(n, dtype=torch.int64, device=deg.device)
    rank = _wrap_int32(-deg.to(torch.int64) * n - ids)
    return Priorities(select=q << _LOW_BITS, resolve=rank)


def ecl_priorities(key: Key, n: int, deg: torch.Tensor) -> Priorities:
    """ECL-MIS native priority: 8-bit Eq. (1) with random low bits."""
    kq, kp = prng.split(key)
    q = eq1_quantized(deg, kq, bits=8)
    return Priorities(select=(q << _LOW_BITS) | prng.permutation(kp, n, deg.device))


HEURISTICS = {
    "h1": h1_priorities,
    "h2": h2_priorities,
    "h3": h3_priorities,
    "ecl": ecl_priorities,
}


def make_priorities(
    heuristic: str, key: Key, n: int, deg: torch.Tensor
) -> Priorities:
    try:
        fn = HEURISTICS[heuristic]
    except KeyError:
        raise ValueError(f"unknown heuristic {heuristic!r}; options {list(HEURISTICS)}")
    return fn(key, n, deg)
