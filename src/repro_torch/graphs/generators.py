"""Synthetic graph generators (counterpart of `repro.graphs.generators`).

Only the three this slice needs: `grid2d` (the roadNet-PA stand-in the
on-card smoke run solves at full size) and `erdos_renyi` / `random_regular`
for the tests.  Numpy, deterministic in `seed`, bit-identical edge lists to
the reference's generators.
"""
from __future__ import annotations

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.graphs.graph import Graph, from_edges


def grid2d(
    n_rows: int,
    n_cols: int,
    seed: int = 0,
    diag_frac: float = 0.05,
    *,
    device: DeviceLike = "cuda",
) -> Graph:
    """Road-network stand-in: 2-D lattice with a sprinkle of diagonal
    shortcuts (|E|/|V| ≈ 2.7 counting undirected edges once)."""
    n = n_rows * n_cols
    idx = np.arange(n).reshape(n_rows, n_cols)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    edges = [right, down]
    if diag_frac > 0:
        rng = np.random.default_rng(seed)
        n_diag = int(diag_frac * n)
        rr = rng.integers(0, n_rows - 1, n_diag)
        cc = rng.integers(0, n_cols - 1, n_diag)
        edges.append(np.stack([idx[rr, cc], idx[rr + 1, cc + 1]], axis=1))
    e = np.concatenate(edges, axis=0)
    return from_edges(e[:, 0], e[:, 1], n, device=device)


def random_regular(
    n: int, d: int = 6, seed: int = 0, *, device: DeviceLike = "cuda"
) -> Graph:
    """d-regular random graph (uniform-degree control case)."""
    rng = np.random.default_rng(seed)
    stubs = np.repeat(np.arange(n), d)
    rng.shuffle(stubs)
    half = stubs.shape[0] // 2
    return from_edges(stubs[:half], stubs[half : 2 * half], n, device=device)


def erdos_renyi(
    n: int, avg_deg: float = 8.0, seed: int = 0, *, device: DeviceLike = "cuda"
) -> Graph:
    """G(n, m) uniform random graph."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg / 2)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    return from_edges(src, dst, n, device=device)
