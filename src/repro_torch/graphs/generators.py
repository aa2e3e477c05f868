"""Synthetic graph generators (counterpart of `repro.graphs.generators`).

The paper's eight graphs (Table 1) are SuiteSparse matrices; each gets a
generator of its structure class, at any scale:

  G1 amazon0302        co-purchase      -> preferential_attachment (m=4)
  G2 roadNet-PA        road network     -> grid2d
  G3 delaunay_n19      planar mesh      -> delaunay_like
  G4 wiki-Talk         power-law hubs   -> powerlaw
  G5 web-Google        web crawl        -> web_like (m=5)
  G6 web-BerkStan      dense web crawl  -> web_like (m=10)
  G7 soc-LiveJournal1  social           -> preferential_attachment (m=7)
  G8 kron_g500-logn21  Kronecker        -> rmat (Graph500 a, b, c)

`random_regular` and `erdos_renyi` are control cases.  Each generator is
deterministic in `seed` and gives the reference's edge list for the same
arguments (numpy; scipy for the triangulation; `web_like` replays the
Holme–Kim growth with the same `random.Random` draws), and returns a
`Graph` on `device`.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict

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


def rmat(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    *,
    device: DeviceLike = "cuda",
) -> Graph:
    """R-MAT / Kronecker generator with the Graph500 defaults."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    for i in range(scale):
        bit = 1 << i
        r1 = rng.random(m)
        r2 = rng.random(m)
        src_bit = r1 > ab
        dst_bit = np.where(src_bit, r2 > c_norm, r2 > a_norm)
        src |= bit * src_bit
        dst |= bit * dst_bit
    # permute vertex ids so locality is not an artefact of generation order
    perm = rng.permutation(n)
    return from_edges(perm[src], perm[dst], n, device=device)


def powerlaw(
    n: int, avg_deg: float = 4.0, exponent: float = 2.1, seed: int = 0,
    *, device: DeviceLike = "cuda",
) -> Graph:
    """Configuration-model power-law graph (hub-heavy, skewed)."""
    rng = np.random.default_rng(seed)
    # Zipf-like degrees, clipped so the configuration model terminates
    raw = rng.zipf(exponent, n).astype(np.float64)
    raw = np.minimum(raw, np.sqrt(n))
    deg = np.maximum(1, np.round(raw * (avg_deg * n) / raw.sum())).astype(np.int64)
    stubs = np.repeat(np.arange(n), deg)
    rng.shuffle(stubs)
    if stubs.shape[0] % 2:
        stubs = stubs[:-1]
    half = stubs.shape[0] // 2
    return from_edges(stubs[:half], stubs[half:], n, device=device)


def delaunay_like(n: int, seed: int = 0, *, device: DeviceLike = "cuda") -> Graph:
    """Delaunay triangulation of n uniform points in the unit square."""
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    simplices = Delaunay(rng.random((n, 2))).simplices
    e = np.concatenate(
        [simplices[:, [0, 1]], simplices[:, [1, 2]], simplices[:, [2, 0]]], axis=0
    )
    return from_edges(e[:, 0], e[:, 1], n, device=device)


def preferential_attachment(
    n: int, m: int = 4, seed: int = 0, *, device: DeviceLike = "cuda"
) -> Graph:
    """Barabási–Albert growth: each new vertex links to up to m distinct
    earlier ones, drawn from the endpoint history."""
    rng = np.random.default_rng(seed)
    src_all = np.empty((n - m) * m, dtype=np.int64)
    dst_all = np.empty((n - m) * m, dtype=np.int64)
    hist = np.empty(2 * (n - m) * m + m, dtype=np.int64)
    hist[:m] = np.arange(m)
    hlen = m
    k = 0
    for v in range(m, n):
        picks = np.unique(hist[rng.integers(0, hlen, 2 * m)])[:m]
        cnt = picks.shape[0]
        src_all[k : k + cnt] = v
        dst_all[k : k + cnt] = picks
        hist[hlen : hlen + cnt] = picks
        hist[hlen + cnt : hlen + 2 * cnt] = v
        hlen += 2 * cnt
        k += cnt
    return from_edges(src_all[:k], dst_all[:k], n, device=device)


def web_like(
    n: int, m: int = 8, p_triangle: float = 0.5, seed: int = 0,
    *, device: DeviceLike = "cuda",
) -> Graph:
    """Holme–Kim clustered power-law growth: preferential attachment where
    each link after the first closes a triangle with probability
    `p_triangle`.  The draws replay networkx's `powerlaw_cluster_graph`
    (a `random.Random(seed)`, the same choices in the same order), which
    the reference calls, so the edge set is the reference's."""
    if m < 1 or n < m:
        raise ValueError(f"web_like needs 1 <= m <= n, got m={m}, n={n}")
    rnd = random.Random(seed)
    adj: Dict[int, Dict[int, None]] = {v: {} for v in range(m)}
    src, dst = [], []

    def link(u: int, v: int) -> None:
        adj.setdefault(u, {})[v] = None
        adj.setdefault(v, {})[u] = None
        src.append(u)
        dst.append(v)

    repeated = list(range(m))
    for source in range(m, n):
        targets = set()
        while len(targets) < m:
            targets.add(rnd.choice(repeated))
        target = targets.pop()
        link(source, target)
        repeated.append(target)
        count = 1
        while count < m:
            if rnd.random() < p_triangle:
                hood = [u for u in adj[target] if u not in adj[source] and u != source]
                if hood:
                    u = rnd.choice(hood)
                    link(source, u)
                    repeated.append(u)
                    count += 1
                    continue
            target = targets.pop()
            link(source, target)
            repeated.append(target)
            count += 1
        repeated.extend([source] * m)
    return from_edges(np.asarray(src, np.int64), np.asarray(dst, np.int64), n,
                      device=device)


# --------------------------------------------------------------------------
# the paper's suite, as specs
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """One row of the paper's Table 1, and how to synthesise it."""
    name: str
    paper_id: str          # G1..G8
    n_full: int            # |V| at paper scale
    e_full: int            # |E| at paper scale (undirected count)
    n_reduced: int         # the reduced scale the reference's benchmarks run
    make: Callable[..., Graph]  # (n, seed, device) -> Graph at n vertices

    def reduced(self, seed: int = 0, *, device: DeviceLike = "cuda") -> Graph:
        return self.make(self.n_reduced, seed, device)

    @property
    def e_over_v(self) -> float:
        return self.e_full / self.n_full


def _grid_maker(n: int, seed: int, device: DeviceLike) -> Graph:
    side = int(np.sqrt(n))
    return grid2d(side, side, seed=seed, device=device)


GRAPH_SUITE: Dict[str, GraphSpec] = {
    s.paper_id: s
    for s in [
        GraphSpec("amazon0302", "G1", 262_111, 1_234_877, 20_000,
                  lambda n, seed, dev: preferential_attachment(n, m=4, seed=seed, device=dev)),
        GraphSpec("roadNet-PA", "G2", 1_090_920, 1_541_898, 40_000, _grid_maker),
        GraphSpec("delaunay_n19", "G3", 524_288, 1_572_823, 32_768,
                  lambda n, seed, dev: delaunay_like(n, seed=seed, device=dev)),
        GraphSpec("wiki-Talk", "G4", 2_394_385, 4_659_565, 30_000,
                  lambda n, seed, dev: powerlaw(n, avg_deg=4.0, seed=seed, device=dev)),
        GraphSpec("web-Google", "G5", 916_428, 4_322_051, 20_000,
                  lambda n, seed, dev: web_like(n, m=5, seed=seed, device=dev)),
        GraphSpec("web-BerkStan", "G6", 685_230, 6_649_470, 16_000,
                  lambda n, seed, dev: web_like(n, m=10, seed=seed, device=dev)),
        GraphSpec("soc-LiveJournal1", "G7", 4_847_571, 42_851_237, 24_000,
                  lambda n, seed, dev: preferential_attachment(n, m=7, seed=seed, device=dev)),
        GraphSpec("kron_g500-logn21", "G8", 2_097_152, 91_040_932, 16_384,
                  lambda n, seed, dev: rmat(int(np.log2(n)), edge_factor=16, seed=seed,
                                            device=dev)),
    ]
}


def generate(
    paper_id: str, *, scale: str = "reduced", seed: int = 0, device: DeviceLike = "cuda"
) -> Graph:
    """One of the paper's graphs at its reduced scale (`GRAPH_SUITE`); the
    full scale exists only as the spec's counts."""
    spec = GRAPH_SUITE[paper_id]
    if scale != "reduced":
        raise ValueError("full-scale graphs are specs, not arrays")
    return spec.reduced(seed, device=device)
