"""`Plan` — the immutable solve artifact — and its memory cache (counterpart
of `repro.api.plan`).

A plan is a graph's canonical (optionally RCM-permuted) form, its BSR
tiling with its hybrid tile partition where the policy attaches one, and
the permutation that maps results back, keyed by a sha256 over the
canonical edge list and the build parameters — the same key derivation as
the reference, so one graph keys identically in both packages.  The
cache's disk layer and `apply_delta` come later (ROADMAP.md, Queue 1
items 9 and 14).

`plan_from_arrays` builds a plan from a reference plan's arrays (the
reference's npz cache layout), so parity tests run both packages on
identical state.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.tiling import (
    STORAGES as TILE_STORAGES,
    BlockTiledGraph,
    attach_partition,
    build_block_tiles,
    next_pow2,
    rcm_ordering,
    tiling_from_arrays,
)
from repro_torch.device import DeviceLike, resolve_device, to_torch
from repro_torch.graphs.graph import Graph, from_edges

# --------------------------------------------------------------------------
# the auto-T and auto-storage policies (the reference's, verbatim)
# --------------------------------------------------------------------------

DEFAULT_TILE_BUDGET = 512 << 20   # bytes of BSR payload per device
TILE_CANDIDATES = (128, 64, 32, 16)
BITPACK_AUTO_THRESHOLD = 1 << 20  # est. int8 tile payload bytes → bitpack


def worst_case_tile_bytes(n_nodes: int, n_edges: int, tile_size: int) -> float:
    """Worst-case stored int8 BSR payload: `min(E, nb²)·T²`."""
    T = int(tile_size)
    nb = -(-max(int(n_nodes), 1) // T)
    return min(max(int(n_edges), 1), nb * nb) * T * T


def fit_tile_size(
    payload_bytes: Callable[[int], float],
    *,
    budget: int = DEFAULT_TILE_BUDGET,
    candidates: Tuple[int, ...] = TILE_CANDIDATES,
) -> int:
    """Largest candidate T whose estimated payload fits `budget`; the
    smallest candidate when nothing fits."""
    for T in candidates:
        if payload_bytes(T) <= budget:
            return T
    return candidates[-1]


def resolve_storage(
    storage: str,
    n_nodes: int,
    n_edges: int,
    tile_size: int,
    *,
    threshold: int = BITPACK_AUTO_THRESHOLD,
) -> str:
    """Concrete tile storage: 'auto' flips to bitpack once the worst-case
    int8 payload reaches `threshold` bytes; concrete spellings pass."""
    if storage in TILE_STORAGES:
        return storage
    if storage != "auto":
        raise ValueError(
            f"unknown storage {storage!r}; valid: {('auto',) + TILE_STORAGES}"
        )
    est = worst_case_tile_bytes(n_nodes, n_edges, tile_size)
    return "bitpack" if est >= threshold else "int8"


def resolve_hybrid_threshold(
    tile_size: int, storage: str, threshold: Optional[int] = None
) -> int:
    """The nnz cut of a plan's tile partition: the caller's override, or
    the cost model's break-even for this tile size and storage
    (`repro_torch.perf.hybrid_density_threshold`).  Resolved at plan time,
    so the cache key names a number, never a policy."""
    if threshold is not None:
        return int(threshold)
    from repro_torch.perf.roofline import hybrid_density_threshold

    return hybrid_density_threshold(tile_size, storage)


def choose_tile_size(
    n_nodes: int,
    n_edges: int,
    *,
    n_chips: int = 1,
    budget: int = DEFAULT_TILE_BUDGET,
) -> int:
    """Default auto-T: the largest T whose worst-case payload fits the
    budget, never wider than the padded vertex range."""
    cap = next_pow2(max(min(int(n_nodes), TILE_CANDIDATES[0]), TILE_CANDIDATES[-1]))
    candidates = tuple(T for T in TILE_CANDIDATES if T <= cap) or (TILE_CANDIDATES[-1],)

    def per_chip_bytes(T: int) -> float:
        return worst_case_tile_bytes(n_nodes, n_edges, T) / max(int(n_chips), 1)

    return fit_tile_size(per_chip_bytes, budget=budget, candidates=candidates)


# --------------------------------------------------------------------------
# the plan artifact
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plan:
    """One graph's preprocessing artefacts.  `g` and `tiled` index plan ids
    (RCM-permuted when `perm` is set); `to_original` maps results back."""
    g: Graph
    tiled: BlockTiledGraph
    key: str                           # content hash (the cache key)
    perm: Optional[np.ndarray] = None  # perm[plan_id] = original_id
    inv: Optional[np.ndarray] = None   # inv[original_id] = plan_id
    reorder: Optional[str] = None
    hybrid: str = "off"                # the tile-partition policy
    hybrid_threshold: int = 0          # its resolved nnz cut (0 iff off)

    @property
    def n_nodes(self) -> int:
        return self.g.n_nodes

    @property
    def tile_size(self) -> int:
        return self.tiled.tile_size

    @property
    def storage(self) -> str:
        return self.tiled.storage

    @property
    def device(self) -> torch.device:
        return self.tiled.device

    def to_original(self, x: np.ndarray) -> np.ndarray:
        """Map a per-vertex plan-id vector back to original vertex ids."""
        x = np.asarray(x)[: self.g.n_nodes]
        return x if self.inv is None else x[self.inv]

    def to_plan_ids(self, x: np.ndarray) -> np.ndarray:
        """Inverse of :meth:`to_original`."""
        x = np.asarray(x)[: self.g.n_nodes]
        return x if self.perm is None else x[self.perm]

    @classmethod
    def build(
        cls,
        graph: Union[Graph, "Plan"],
        *,
        tile_size: Optional[int] = None,
        reorder: Optional[str] = None,
        storage: str = "int8",
        hybrid: str = "off",
        hybrid_threshold: Optional[int] = None,
        cache: Optional["PlanCache"] = None,
    ) -> "Plan":
        """Plan a graph on its own device, through `cache` when given.
        `tile_size=None` applies auto-T, `storage` may be 'auto'; `hybrid`
        is the tile-partition policy, its `hybrid_threshold=None` the cost
        model's cut (`resolve_hybrid_threshold`).  A `Plan` passes through
        untouched."""
        if isinstance(graph, Plan):
            return graph
        T = tile_size or choose_tile_size(graph.n_nodes, graph.n_edges)
        storage = resolve_storage(storage, graph.n_nodes, graph.n_edges, T)
        if cache is not None:
            return cache.plan(graph, tile_size=T, reorder=reorder, storage=storage,
                              hybrid=hybrid, hybrid_threshold=hybrid_threshold)[0]
        thr = 0 if hybrid == "off" else resolve_hybrid_threshold(T, storage, hybrid_threshold)
        key = plan_cache_key(graph, T, reorder, storage, hybrid, thr)
        return build_plan(graph, T, reorder, key, storage=storage,
                          hybrid=hybrid, hybrid_threshold=thr)


def _edge_bytes(g: Graph) -> Tuple[bytes, bytes]:
    s = g.senders[: g.n_edges].cpu().numpy().astype(np.int32)
    r = g.receivers[: g.n_edges].cpu().numpy().astype(np.int32)
    return s.tobytes(), r.tobytes()


def graph_content_key(g: Graph) -> str:
    """Content hash of the graph alone (the reference's derivation)."""
    h = hashlib.sha256()
    h.update(f"tcmis-graph|{g.n_nodes}".encode())
    for b in _edge_bytes(g):
        h.update(b)
    return h.hexdigest()


def plan_cache_key(
    g: Graph,
    tile_size: int,
    reorder: Optional[str],
    storage: str = "int8",
    hybrid: str = "off",
    hybrid_threshold: int = 0,
) -> str:
    """Content hash of (canonical edges, n_nodes, build params) — equal to
    the reference's key for the same graph and parameters."""
    h = hashlib.sha256()
    tail = "" if hybrid == "off" else f"|h{hybrid}:{int(hybrid_threshold)}"
    h.update(
        f"tcmis-plan|{g.n_nodes}|{tile_size}|{reorder or ''}|{storage}"
        f"{tail}".encode()
    )
    for b in _edge_bytes(g):
        h.update(b)
    return h.hexdigest()


def build_plan(
    g: Graph,
    tile_size: int,
    reorder: Optional[str],
    key: str,
    storage: str = "int8",
    hybrid: str = "off",
    hybrid_threshold: int = 0,
) -> Plan:
    """The cache-miss path: (optional) RCM + BSR tiling + (optional) tile
    partition, on `g`'s device.  `hybrid_threshold` arrives resolved."""
    perm = inv = None
    if reorder == "rcm":
        perm = np.asarray(rcm_ordering(g))
        inv = np.empty_like(perm)
        inv[perm] = np.arange(g.n_nodes)
        s = g.senders[: g.n_edges].cpu().numpy()
        r = g.receivers[: g.n_edges].cpu().numpy()
        g = from_edges(inv[s], inv[r], g.n_nodes, device=g.device)
    elif reorder is not None:
        raise ValueError(f"unknown reorder {reorder!r} (None or 'rcm')")
    tiled = build_block_tiles(g, tile_size=tile_size, storage=storage)
    if hybrid != "off":
        tiled = attach_partition(tiled, mode=hybrid, threshold=int(hybrid_threshold))
    return Plan(g=g, tiled=tiled, key=key, perm=perm, inv=inv, reorder=reorder,
                hybrid=hybrid, hybrid_threshold=int(hybrid_threshold))


# the reference's npz `meta` record: n_nodes, n_edges, n_tiles, tile_size,
# nbr, nbc, version, storage index, hybrid mode index, hybrid threshold
_META_FIELDS = 8
HYBRID_MODES = ("off", "auto", "forced")   # by the meta record's mode index


def _check_tiling_arrays(arrays, n_tiles: int, nbr: int, nbc: int) -> None:
    """The index arrays the kernels trust: a monotone `row_starts` over the
    real tiles and in-range tile coordinates."""
    rs = np.asarray(arrays["row_starts"])
    rows = np.asarray(arrays["tile_rows"])
    cols = np.asarray(arrays["tile_cols"])
    nt = np.asarray(arrays["tiles"]).shape[0]
    ok = (
        rs.shape == (nbr + 1,) and rs[0] == 0 and rs[-1] == n_tiles
        and n_tiles <= nt and rows.shape == cols.shape == (nt,)
        and bool(np.all(np.diff(rs) >= 0))
        and bool(np.all((cols >= 0) & (cols < nbc)))
        and bool(np.all((rows >= 0) & (rows < max(nbr, 1))))
    )
    if not ok:
        raise ValueError("inconsistent tiling arrays (row_starts/tile_rows/tile_cols)")


def plan_from_arrays(
    arrays: Dict[str, np.ndarray], *, device: DeviceLike = "cuda", key: str = ""
) -> Plan:
    """A port `Plan` from a reference plan's arrays, in the reference's npz
    cache layout: senders, receivers (real half-edges only), tiles as
    stored (int8 or uint32 words), tile_rows, tile_cols, row_starts, the
    optional perm, and the int `meta` record (n_nodes, n_edges, n_tiles,
    tile_size, n_block_rows, n_block_cols, version, storage index, hybrid
    mode index, hybrid threshold).  A meta record that names a hybrid mode
    re-attaches the partition from the tiles, as the reference's loader
    does: it is policy, not payload."""
    dev = resolve_device(device)
    meta = [int(v) for v in np.asarray(arrays["meta"])]
    if len(meta) < _META_FIELDS:
        raise ValueError(f"meta record has {len(meta)} fields, need ≥ {_META_FIELDS}")
    n_nodes, n_edges, n_tiles, tile_size, nbr, nbc = meta[:6]
    storage = TILE_STORAGES[meta[7]]
    hybrid = HYBRID_MODES[meta[8]] if len(meta) > 9 else "off"
    hybrid_threshold = meta[9] if hybrid != "off" else 0
    g = Graph(
        senders=to_torch(np.asarray(arrays["senders"], np.int32), dev),
        receivers=to_torch(np.asarray(arrays["receivers"], np.int32), dev),
        n_nodes=n_nodes,
        n_edges=n_edges,
    )
    _check_tiling_arrays(arrays, n_tiles, nbr, nbc)
    tiled = tiling_from_arrays(
        arrays, n_tiles=n_tiles, n_nodes=n_nodes, tile_size=tile_size,
        n_block_rows=nbr, n_block_cols=nbc, storage=storage, device=dev,
    )
    if hybrid != "off":
        tiled = attach_partition(tiled, mode=hybrid, threshold=hybrid_threshold)
    perm = inv = None
    if arrays.get("perm") is not None:
        perm = np.asarray(arrays["perm"])
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n_nodes)
    return Plan(g=g, tiled=tiled, key=key, perm=perm, inv=inv,
                reorder="rcm" if perm is not None else None,
                hybrid=hybrid, hybrid_threshold=hybrid_threshold)


class PlanCache:
    """Content-addressed plan store: the reference's bounded-LRU memory
    layer (the disk layer is not ported yet)."""

    def __init__(
        self,
        tile_size: int = 32,
        reorder: Optional[str] = None,
        max_mem_entries: int = 256,
        storage: str = "int8",
    ):
        self.tile_size = int(tile_size)
        self.reorder = reorder
        self.storage = storage
        self.max_mem_entries = max(int(max_mem_entries), 1)
        self._mem: "OrderedDict[str, Plan]" = OrderedDict()
        self.stats = {"mem_hits": 0, "misses": 0}

    def plan(
        self,
        g: Graph,
        *,
        tile_size: Optional[int] = None,
        reorder: Optional[str] = None,
        storage: Optional[str] = None,
        hybrid: str = "off",
        hybrid_threshold: Optional[int] = None,
    ) -> Tuple[Plan, str]:
        """Return (plan, status) with status ∈ {'mem', 'built'}.  Plans are
        keyed by content, device and hybrid policy: one graph planned on
        two devices is two entries."""
        T = self.tile_size if tile_size is None else int(tile_size)
        ro = self.reorder if reorder is None else reorder
        st = resolve_storage(
            self.storage if storage is None else storage,
            g.n_nodes, g.n_edges, T,
        )
        thr = 0 if hybrid == "off" else resolve_hybrid_threshold(T, st, hybrid_threshold)
        key = plan_cache_key(g, T, ro, st, hybrid, thr)
        slot = f"{key}@{g.device}"
        hit = self._mem.get(slot)
        if hit is not None:
            self.stats["mem_hits"] += 1
            self._mem.move_to_end(slot)
            return hit, "mem"
        self.stats["misses"] += 1
        plan = build_plan(g, T, ro, key, storage=st, hybrid=hybrid, hybrid_threshold=thr)
        self._mem[slot] = plan
        while len(self._mem) > self.max_mem_entries:
            self._mem.popitem(last=False)
        return plan, "built"
