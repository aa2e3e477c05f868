"""Core graph container (counterpart of `repro.graphs.graph`).

Both directions of every undirected edge are stored as an edge list
(`senders`/`receivers`, int32), sorted by sender.  Edge arrays may be
padded with the sentinel `sender == receiver == n_nodes`; every consumer
masks on `edge_mask`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, to_torch


@dataclasses.dataclass(frozen=True)
class Graph:
    """A static-shape undirected graph on one device.

    Attributes:
      senders:   (E_pad,) int32 — source of each directed half-edge.
      receivers: (E_pad,) int32 — destination of each directed half-edge.
      n_nodes:   number of real vertices (the sentinel slot excluded).
      n_edges:   number of real directed half-edges (≤ E_pad).
    """
    senders: torch.Tensor
    receivers: torch.Tensor
    n_nodes: int
    n_edges: int

    @property
    def e_pad(self) -> int:
        return int(self.senders.shape[0])

    @property
    def device(self) -> torch.device:
        return self.senders.device

    @functools.cached_property
    def edge_mask(self) -> torch.Tensor:
        """(E_pad,) bool — True for real edges."""
        return torch.arange(self.e_pad, device=self.device) < self.n_edges

    # int64 index copies, made once per graph: scatter_reduce / index_add_
    # want int64 indices, and the segment ops run twice per round.
    @functools.cached_property
    def receivers_long(self) -> torch.Tensor:
        return self.receivers.long()

    @functools.cached_property
    def senders_gather(self) -> torch.Tensor:
        """(E_pad,) int64 senders with sentinel rows pointed at vertex 0, so
        a gather of an (n_nodes,) vector stays in range (the reference's jax
        gather clamps instead); those rows are masked by every consumer."""
        return torch.where(self.edge_mask, self.senders, 0).long()

    def degrees(self) -> torch.Tensor:
        """(n_nodes,) int32 — undirected degree of every vertex."""
        ones = self.edge_mask.to(torch.int32)
        out = torch.zeros(self.n_nodes + 1, dtype=torch.int32, device=self.device)
        return out.index_add_(0, self.receivers_long, ones)[: self.n_nodes]

    def to(self, device: DeviceLike) -> "Graph":
        """This graph on `device` (itself when already there)."""
        dev = resolve_device(device)
        if self.device == dev:
            return self
        return Graph(self.senders.to(dev), self.receivers.to(dev),
                     self.n_nodes, self.n_edges)


def _symmetrize(src: np.ndarray, dst: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Drop self loops, dedupe, and materialise both directions."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    key = lo * n + hi
    _, uniq = np.unique(key, return_index=True)
    lo, hi = lo[uniq], hi[uniq]
    s = np.concatenate([lo, hi])
    r = np.concatenate([hi, lo])
    order = np.lexsort((r, s))
    return s[order].astype(np.int32), r[order].astype(np.int32)


def from_edges(
    src: np.ndarray,
    dst: np.ndarray,
    n_nodes: int,
    *,
    pad_to: Optional[int] = None,
    device: DeviceLike = "cuda",
) -> Graph:
    """Build an undirected :class:`Graph` from a (possibly noisy) edge list.

    Self-loops are dropped, duplicates removed, both directions
    materialised, and half-edges sorted by sender; the result lives on
    `device`.
    """
    dev = resolve_device(device)
    s, r = _symmetrize(src, dst, n_nodes)
    n_edges = int(s.shape[0])
    e_pad = n_edges if pad_to is None else max(pad_to, n_edges)
    if e_pad > n_edges:
        pad = np.full(e_pad - n_edges, n_nodes, dtype=np.int32)
        s = np.concatenate([s, pad])
        r = np.concatenate([r, pad])
    return Graph(
        senders=to_torch(s, dev),
        receivers=to_torch(r, dev),
        n_nodes=int(n_nodes),
        n_edges=n_edges,
    )


def build_csr(g: Graph) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side CSR (indptr int64, indices int32) from the real half-edges,
    ordered by a stable sort on the sender."""
    s = g.senders[: g.n_edges].cpu().numpy()
    r = g.receivers[: g.n_edges].cpu().numpy()
    order = np.argsort(s, kind="stable")
    s, r = s[order], r[order]
    counts = np.bincount(s, minlength=g.n_nodes)
    indptr = np.zeros(g.n_nodes + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, r.astype(np.int32)


def pad_graph(g: Graph, e_pad: int) -> Graph:
    """A copy of `g` with `e_pad` edge rows, on `g`'s device.

    Growing appends sentinel rows (`n_nodes`).  An `e_pad` below the
    current padding but at least `n_edges` shrinks it: every row past
    `n_edges` is a sentinel, so cutting it loses nothing (empty and
    singleton graphs round-trip through `from_edges(pad_to=...)`).  Below
    `n_edges` raises."""
    if e_pad < g.n_edges:
        raise ValueError(f"pad {e_pad} < real edges {g.n_edges}")
    if e_pad == g.e_pad:
        return g
    if e_pad < g.e_pad:
        return Graph(g.senders[:e_pad], g.receivers[:e_pad], g.n_nodes, g.n_edges)
    pad = torch.full((e_pad - g.e_pad,), g.n_nodes, dtype=torch.int32, device=g.device)
    return Graph(
        senders=torch.cat([g.senders, pad]),
        receivers=torch.cat([g.receivers, pad]),
        n_nodes=g.n_nodes,
        n_edges=g.n_edges,
    )


def to_networkx(g: Graph):
    """The graph as an undirected `networkx.Graph` on vertices 0..n-1 (for
    oracle comparisons on small graphs; networkx is imported here only)."""
    import networkx as nx

    s = g.senders[: g.n_edges].cpu().numpy()
    r = g.receivers[: g.n_edges].cpu().numpy()
    out = nx.Graph()
    out.add_nodes_from(range(g.n_nodes))
    out.add_edges_from(zip(s.tolist(), r.tolist()))
    return out
