"""`EdgeDelta` — a canonical, content-hashed batch of edge mutations
(counterpart of `repro.dyngraph.delta`; numpy, the same canonical pairs and
the same `content_key`, byte for byte).

A delta is a set of undirected edges to add and a set to remove,
canonicalised the way `graphs.graph.from_edges` canonicalises a graph: self
loops dropped, duplicates merged, endpoints ordered (lo, hi), pairs sorted.
Two deltas that describe one mutation hash alike, whatever order their
edges arrived in.

Semantics are strict set operations against the graph a delta is applied
to: every `add` edge must be absent and every `remove` edge present
(`retile.apply_graph_delta` raises otherwise).  That is what makes
`inverse()` a real inverse, at the edge-list and at the tile level, and
what keeps the delta-chained plan-cache keys
(`repro_torch.api.plan.delta_cache_key`) naming one graph state.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np

from repro_torch.graphs.graph import Graph


def sorted_unique(a) -> np.ndarray:
    """`np.unique` of a 1-D array, by one sort.  numpy's own `np.unique`
    hashes in recent versions, and that ran about 0.2 µs per element on
    the card's host (40 ms for a 5 % G2 delta's 223,088 endpoints), five to
    ten times a sort."""
    a = np.sort(np.asarray(a).reshape(-1))
    if a.size:
        a = a[np.concatenate(([True], a[1:] != a[:-1]))]
    return a


def _canonical_pairs(src, dst) -> np.ndarray:
    """(k,) + (k,) endpoint arrays → (m, 2) int64 canonical (lo, hi) pairs:
    self loops dropped, deduped, sorted lexicographically."""
    src = np.asarray(src, dtype=np.int64).reshape(-1)
    dst = np.asarray(dst, dtype=np.int64).reshape(-1)
    if src.shape != dst.shape:
        raise ValueError(f"endpoint arrays disagree: {src.shape} vs {dst.shape}")
    keep = src != dst
    lo = np.minimum(src[keep], dst[keep])
    hi = np.maximum(src[keep], dst[keep])
    if not lo.size:
        return np.zeros((0, 2), np.int64)
    # lexicographic order of (lo, hi) is the order of lo·n + hi
    n = np.int64(hi.max()) + 1
    keys = sorted_unique(lo * n + hi)
    return np.stack([keys // n, keys % n], axis=1)


def _pair_keys(pairs: np.ndarray, n: int) -> np.ndarray:
    """Scalar int64 key per (lo, hi) pair: the set-membership currency."""
    return pairs[:, 0] * np.int64(n) + pairs[:, 1]


def undirected_keys(g: Graph) -> np.ndarray:
    """Sorted unique int64 `lo·n + hi` key of every undirected edge of `g`,
    on the host: the reference's `np.unique` of the (lo, hi) pairs, in the
    same order, as a one-dimensional unique over the pairs' keys (a
    symmetric edge list holds each pair once with sender < receiver)."""
    s = g.senders[: g.n_edges].cpu().numpy().astype(np.int64)
    r = g.receivers[: g.n_edges].cpu().numpy().astype(np.int64)
    return sorted_unique(np.minimum(s, r) * np.int64(g.n_nodes) + np.maximum(s, r))


@dataclasses.dataclass(frozen=True)
class EdgeDelta:
    """An immutable edge-mutation batch in canonical form.

    Build through :meth:`make` (which canonicalises); the raw constructor
    trusts its inputs (`inverse`, tests that hold canonical arrays).

    Attributes:
      add:    (n_add, 2) int64 canonical (lo, hi) pairs to insert.
      remove: (n_remove, 2) int64 canonical pairs to delete.
    """
    add: np.ndarray
    remove: np.ndarray

    @classmethod
    def make(cls, add_src=(), add_dst=(), rem_src=(), rem_dst=()) -> "EdgeDelta":
        """Canonicalise raw endpoint arrays into a delta.  An edge in both
        sets is rejected: one atomic batch has no order between them."""
        add = _canonical_pairs(add_src, add_dst)
        rem = _canonical_pairs(rem_src, rem_dst)
        if add.size and rem.size:
            n = int(max(add.max(), rem.max())) + 1
            overlap = np.intersect1d(_pair_keys(add, n), _pair_keys(rem, n))
            if overlap.size:
                raise ValueError(
                    f"{overlap.size} edge(s) appear in both add and remove — "
                    f"a delta is one atomic set mutation, split it instead"
                )
        return cls(add=add, remove=rem)

    @property
    def n_add(self) -> int:
        return int(self.add.shape[0])

    @property
    def n_remove(self) -> int:
        return int(self.remove.shape[0])

    @property
    def is_empty(self) -> bool:
        return self.n_add == 0 and self.n_remove == 0

    @property
    def content_key(self) -> str:
        """sha256 over the canonical pairs (the reference's derivation):
        what the patched plans' cache keys chain over."""
        h = hashlib.sha256()
        h.update(f"tcmis-edgedelta|{self.n_add}|{self.n_remove}".encode())
        h.update(self.add.astype(np.int64).tobytes())
        h.update(self.remove.astype(np.int64).tobytes())
        return h.hexdigest()

    def inverse(self) -> "EdgeDelta":
        """The undo delta: `d` then `d.inverse()` restores the graph and its
        tiling exactly."""
        return EdgeDelta(add=self.remove, remove=self.add)

    def touched(self) -> np.ndarray:
        """Sorted unique vertex ids incident to any delta edge: the seed of
        the dirty frontier the repair resets."""
        if self.is_empty:
            return np.zeros(0, np.int64)
        return sorted_unique(np.concatenate([
            self.add.reshape(-1), self.remove.reshape(-1),
        ])).astype(np.int64)

    def mapped(self, mapping: np.ndarray) -> "EdgeDelta":
        """Relabel endpoints through `mapping[old_id] = new_id` and
        re-canonicalise (how RCM-reordered plans take original-id deltas)."""
        mapping = np.asarray(mapping)
        return EdgeDelta.make(
            mapping[self.add[:, 0]], mapping[self.add[:, 1]],
            mapping[self.remove[:, 0]], mapping[self.remove[:, 1]],
        )

    def check_bounds(self, n_nodes: int) -> None:
        """Deltas never grow the vertex set: a graph's vertex count is its
        identity; growing it is a new graph."""
        hi = -1
        for pairs in (self.add, self.remove):
            if pairs.size:
                hi = max(hi, int(pairs.max()))
        if hi >= n_nodes:
            raise ValueError(
                f"delta references vertex {hi} but the graph has "
                f"{n_nodes} vertices — deltas cannot grow the vertex set"
            )


def random_delta(
    g: Graph,
    n_add: int = 0,
    n_remove: int = 0,
    seed: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> EdgeDelta:
    """A strict-valid delta for `g`: removals drawn from its edges, adds
    from its non-edges (rejection-sampled).  It draws from numpy's
    generator exactly as the reference does, so one graph and seed give
    the reference's delta."""
    rng = np.random.default_rng(seed) if rng is None else rng
    n = g.n_nodes
    keys = undirected_keys(g)
    und = np.stack([keys // n, keys % n], axis=1) if n else np.zeros((0, 2), np.int64)
    existing = set(keys.tolist())

    n_remove = min(int(n_remove), und.shape[0])
    rem = und[rng.choice(und.shape[0], size=n_remove, replace=False)] \
        if n_remove else np.zeros((0, 2), np.int64)

    adds: list = []
    picked = set()
    # rejection sampling; gives up quietly on near-complete graphs
    max_tries = max(int(n_add), 1) * 64
    while len(adds) < int(n_add) and max_tries > 0 and n >= 2:
        max_tries -= 1
        u, v = int(rng.integers(n)), int(rng.integers(n))
        if u == v:
            continue
        lo, hi = min(u, v), max(u, v)
        k = lo * n + hi
        if k in existing or k in picked:
            continue
        picked.add(k)
        adds.append((lo, hi))
    add = np.asarray(adds, np.int64).reshape(-1, 2)
    return EdgeDelta.make(add[:, 0], add[:, 1], rem[:, 0], rem[:, 1])
