"""`Plan` — the immutable solve artifact — and its content-addressed cache
(counterpart of `repro.api.plan`).

A plan is a graph's canonical (optionally RCM-permuted) form, its BSR
tiling with its hybrid tile partition where the policy attaches one, and
the permutation that maps results back, keyed by a sha256 over the
canonical edge list and the build parameters: the reference's key
derivation, so one graph keys alike in both packages.

`PlanCache` has the reference's two layers: a bounded LRU in memory and,
with `cache_dir`, content-addressed `.npz` files in the reference's v3
layout (tiles as stored, a 10-int `meta` record, optional `perm` and
`epoch`), so a file either package writes loads in the other.  A loaded
plan lives on the cache's device; the partition is re-attached from the
stored policy, as the reference's loader does.

Dynamic graphs: `Plan.apply_delta` / `PlanCache.apply_delta` patch a plan
tile by tile (`patch_plan`, `repro_torch.dyngraph.retile`) under a
delta-chained key (`delta_cache_key`) at `epoch + 1`; the cache retires
the superseded parent's disk entry.

`plan_from_arrays` builds a plan from arrays in that npz layout (what the
disk layer reads, and how parity tests hand a reference plan over).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import uuid
import warnings
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
from repro_torch.device import DeviceLike, resolve_device, to_torch, words_to_numpy
from repro_torch.graphs.graph import Graph, from_edges
from repro_torch.obs.metrics import MetricsRegistry

# the legacy stats spelling of the cache, a view over its metrics registry
_PLAN_STAT_KEYS = ("mem_hits", "disk_hits", "misses", "evicted_stale")
# the reference's npz format version (v3: the hybrid policy in the meta
# record and, when not "off", in the key); not part of the key, so a format
# bump lands on the same path, where `_load` finds and evicts the old file
_PLAN_VERSION = 3
# n_nodes, n_edges, n_tiles, tile_size, nbr, nbc, version, storage index,
# hybrid mode index, hybrid threshold
_META_LEN = 10

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
    (RCM-permuted when `perm` is set); `to_original` maps results back.

    `epoch` counts the `EdgeDelta`s applied along this plan's lineage: 0 is
    a build from scratch, and each `apply_delta` gives epoch + 1 under a
    delta-chained key."""
    g: Graph
    tiled: BlockTiledGraph
    key: str                           # content hash (the cache key)
    perm: Optional[np.ndarray] = None  # perm[plan_id] = original_id
    inv: Optional[np.ndarray] = None   # inv[original_id] = plan_id
    reorder: Optional[str] = None
    epoch: int = 0                     # deltas applied since the epoch-0 build
    hybrid: str = "off"                # the tile-partition policy
    hybrid_threshold: int = 0          # its resolved nnz cut (0 iff off)
    occupancy0: float = 0.0            # stored-tile density at the epoch-0
    #                                    build, the drift baseline; 0.0 =
    #                                    unknown (a plan built by hand)

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
    def n_blocks(self) -> int:
        return self.tiled.n_block_rows

    @property
    def device(self) -> torch.device:
        return self.tiled.device

    @functools.cached_property
    def graph_key(self) -> str:
        """The content hash of the graph alone, without build parameters:
        batched members draw their priorities from it
        (`serve_mis.batcher.request_key`), so one graph draws the same
        priorities whatever its tile size or storage."""
        return graph_content_key(self.g)

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

    def apply_delta(self, delta, *, cache: Optional["PlanCache"] = None) -> "Plan":
        """Patch this plan with an `EdgeDelta` (original vertex ids), tile
        by tile, never rebuilt: the same tile size, storage, reorder choice
        and permutation (the RCM order is not recomputed), `epoch + 1`, the
        delta-chained key.  An empty delta returns `self`.  With `cache`,
        through `PlanCache.apply_delta`."""
        if cache is not None:
            return cache.apply_delta(self, delta)[0]
        return patch_plan(self, delta)


# the reference's compatibility spelling (`serve_mis.planner.TilePlan`)
TilePlan = Plan


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


def _legacy_v1_cache_key(g: Graph, tile_size: int, reorder: Optional[str]) -> str:
    """The v1 key derivation (before storage joined the key), kept only so
    the cache can find and evict v1 files, which sit at other paths."""
    h = hashlib.sha256()
    h.update(f"tcmis-plan-v1|{g.n_nodes}|{tile_size}|{reorder or ''}".encode())
    for b in _edge_bytes(g):
        h.update(b)
    return h.hexdigest()


def delta_cache_key(parent_key: str, delta_content_key: str) -> str:
    """A patched plan's cache key: sha256 chained over the parent's key and
    the delta's `content_key` (the reference's derivation).  It names the
    lineage: one graph state reached through two delta histories keys
    twice."""
    h = hashlib.sha256()
    h.update(f"tcmis-plan-delta|{parent_key}|{delta_content_key}".encode())
    return h.hexdigest()


def patch_plan(plan: Plan, delta) -> Plan:
    """The uncached patch path: map the delta through `inv`, patch the
    edge list (whose strict checks run first) and the tiling, re-key.

    The drift gauges record here, the one funnel every applied delta
    passes through.  An "auto" plan re-runs the partition gate over the
    patched tiling, since a delta can carry the graph across it either
    way; "forced" and "off" plans keep their partition state (the
    retiling rebuilds a partition at its threshold)."""
    from repro_torch.dyngraph import drift
    from repro_torch.dyngraph.retile import apply_delta as apply_tiled_delta
    from repro_torch.dyngraph.retile import apply_graph_delta

    if delta.is_empty:
        return plan
    mapped = delta if plan.inv is None else delta.mapped(plan.inv)
    g2 = apply_graph_delta(plan.g, mapped)
    if plan.hybrid == "auto":
        tiled2 = apply_tiled_delta(dataclasses.replace(plan.tiled, partition=None), mapped)
        tiled2 = attach_partition(tiled2, mode="auto", threshold=plan.hybrid_threshold)
    else:
        tiled2 = apply_tiled_delta(plan.tiled, mapped)
    drift.note_drift(
        epoch=plan.epoch + 1,
        touched_tiles=drift.touched_tile_count(
            mapped, plan.tiled.tile_size, plan.tiled.n_block_cols),
        n_tiles=tiled2.n_tiles,
        dirty_frac=drift.dirty_vertex_frac(mapped, plan.g.n_nodes),
        occupancy=drift.tile_occupancy(g2.n_edges, tiled2.n_tiles, tiled2.tile_size),
        occupancy0=plan.occupancy0,
    )
    return dataclasses.replace(
        plan, g=g2, tiled=tiled2,
        key=delta_cache_key(plan.key, delta.content_key),
        epoch=plan.epoch + 1,
    )


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
    from repro_torch.dyngraph.drift import tile_occupancy

    return Plan(g=g, tiled=tiled, key=key, perm=perm, inv=inv, reorder=reorder,
                hybrid=hybrid, hybrid_threshold=int(hybrid_threshold),
                occupancy0=tile_occupancy(g.n_edges, tiled.n_tiles, tile_size))


# plan_from_arrays takes the first eight meta fields at least (the v2
# layout); the hybrid mode and threshold follow in v3
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
    arrays: Dict[str, np.ndarray], *, device: DeviceLike = "cuda", key: str = "",
    reorder: Optional[str] = None,
) -> Plan:
    """A port `Plan` from arrays in the reference's npz cache layout:
    senders, receivers (real half-edges only), tiles as stored (int8, or
    uint32 words), tile_rows, tile_cols, row_starts, the optional perm and
    epoch, and the int `meta` record (n_nodes, n_edges, n_tiles, tile_size,
    n_block_rows, n_block_cols, version, storage index, hybrid mode index,
    hybrid threshold).  A meta record that names a hybrid mode re-attaches
    the partition from the tiles, as the reference's loader does: it is
    policy, not payload.  `reorder` defaults to "rcm" when a perm is
    present.  `occupancy0` restarts at the loaded state, as the
    reference's loader sets it."""
    from repro_torch.dyngraph.drift import tile_occupancy

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
        reorder = reorder or "rcm"
    epoch = int(np.asarray(arrays["epoch"])[0]) if arrays.get("epoch") is not None else 0
    return Plan(g=g, tiled=tiled, key=key, perm=perm, inv=inv, reorder=reorder,
                epoch=epoch, hybrid=hybrid, hybrid_threshold=hybrid_threshold,
                occupancy0=tile_occupancy(n_edges, n_tiles, tile_size))


def plan_arrays(plan: Plan) -> Dict[str, np.ndarray]:
    """A plan's arrays in the reference's npz layout (`plan_from_arrays`'s
    inverse): what `PlanCache` writes.  Packed tiles go out as uint32,
    the reference's dtype."""
    g, t = plan.g, plan.tiled
    tiles = words_to_numpy(t.tiles) if t.storage == "bitpack" else t.tiles.cpu().numpy()
    arrays = dict(
        senders=g.senders[: g.n_edges].cpu().numpy().astype(np.int32),
        receivers=g.receivers[: g.n_edges].cpu().numpy().astype(np.int32),
        tiles=tiles,
        tile_rows=t.tile_rows.cpu().numpy(),
        tile_cols=t.tile_cols.cpu().numpy(),
        row_starts=t.row_starts.cpu().numpy(),
        meta=np.asarray(
            [g.n_nodes, g.n_edges, t.n_tiles, t.tile_size, t.n_block_rows,
             t.n_block_cols, _PLAN_VERSION, TILE_STORAGES.index(t.storage),
             HYBRID_MODES.index(plan.hybrid), plan.hybrid_threshold],
            dtype=np.int64,
        ),
    )
    if plan.perm is not None:
        arrays["perm"] = plan.perm
    if plan.epoch:
        # an optional tail record, like `perm`: readers without it take 0
        arrays["epoch"] = np.asarray([plan.epoch], dtype=np.int64)
    return arrays


class PlanCache:
    """Two-layer content-addressed plan store (the reference's): a bounded
    LRU in memory and, with `cache_dir`, `.npz` files on disk, unbounded
    and shared between processes.

    Plans live on the cache's `device`, the CUDA device unless the caller
    asks for the CPU: a graph on another device is moved there before it
    is planned, and disk entries load there.  `tile_size`, `reorder`,
    `storage`, `hybrid` and `hybrid_threshold` are the defaults of `plan`
    (a `Solver` builds its cache with its options' values, so a bare
    `plans.plan(g)` plans as the Solver does); its per-call values (the
    Solver's auto policies) join the key.  A disk
    entry of another format version is evicted with a warning and rebuilt,
    as is a v1 entry at its legacy path; `apply_delta` retires a patched
    plan's parent the same way, so a mutating graph keeps one live file.
    `stats` counts mem_hits, disk_hits, misses (built or patched) and
    evicted_stale."""

    def __init__(
        self,
        tile_size: int = 32,
        reorder: Optional[str] = None,
        cache_dir: Optional[str] = None,
        max_mem_entries: int = 256,
        storage: str = "int8",
        hybrid: str = "off",
        hybrid_threshold: Optional[int] = None,
        *,
        device: DeviceLike = "cuda",
    ):
        self.tile_size = int(tile_size)
        self.reorder = reorder
        self.storage = storage
        self.hybrid = hybrid
        self.hybrid_threshold = hybrid_threshold
        self.cache_dir = cache_dir
        self.device = resolve_device(device)
        self.max_mem_entries = max(int(max_mem_entries), 1)
        self._mem: "OrderedDict[str, Plan]" = OrderedDict()
        self.metrics = MetricsRegistry("plan_cache")
        for k in _PLAN_STAT_KEYS:
            self.metrics.counter(f"plan_cache.{k}")
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    @property
    def stats(self) -> dict:
        """Read-only `{mem_hits, disk_hits, misses, evicted_stale}` view of
        the metrics registry, in the reference's spelling."""
        return {k: self.metrics.counter(f"plan_cache.{k}").value for k in _PLAN_STAT_KEYS}

    def _count(self, key: str) -> None:
        self.metrics.counter(f"plan_cache.{key}").inc()

    def _remember(self, key: str, plan: Plan) -> None:
        self._mem[key] = plan
        self._mem.move_to_end(key)
        while len(self._mem) > self.max_mem_entries:
            self._mem.popitem(last=False)

    def _hit(self, key: str) -> Optional[Plan]:
        hit = self._mem.get(key)
        if hit is not None:
            self._count("mem_hits")
            self._mem.move_to_end(key)
        return hit

    def plan(
        self,
        g: Graph,
        *,
        tile_size: Optional[int] = None,
        reorder: Optional[str] = None,
        storage: Optional[str] = None,
        hybrid: Optional[str] = None,
        hybrid_threshold: Optional[int] = None,
    ) -> Tuple[Plan, str]:
        """Return (plan, status) with status ∈ {'mem', 'disk', 'built'}."""
        g = g.to(self.device)
        T = self.tile_size if tile_size is None else int(tile_size)
        ro = self.reorder if reorder is None else reorder
        st = resolve_storage(
            self.storage if storage is None else storage,
            g.n_nodes, g.n_edges, T,
        )
        hybrid = self.hybrid if hybrid is None else hybrid
        thr = 0 if hybrid == "off" else resolve_hybrid_threshold(
            T, st, self.hybrid_threshold if hybrid_threshold is None else hybrid_threshold)
        key = plan_cache_key(g, T, ro, st, hybrid, thr)
        hit = self._hit(key)
        if hit is not None:
            return hit, "mem"
        if self.cache_dir:
            loaded = self._load(key, ro)
            if loaded is not None:
                self._count("disk_hits")
                self._remember(key, loaded)
                return loaded, "disk"
            # a v1 entry for this graph sits at its legacy key: evict it
            legacy = self._path(_legacy_v1_cache_key(g, T, ro))
            if os.path.exists(legacy):
                self._evict_stale(legacy, "pre-storage-axis entry (v1 key)")
            if hybrid != "off":
                # a pre-hybrid entry sits at the hybrid-free key, which is
                # also the live path of hybrid="off" plans: evict only an
                # old format
                self._evict_legacy_version(self._path(plan_cache_key(g, T, ro, st)))
        self._count("misses")
        plan = build_plan(g, T, ro, key, storage=st, hybrid=hybrid, hybrid_threshold=thr)
        self._remember(key, plan)
        if self.cache_dir:
            self._store(plan)
        return plan, "built"

    def apply_delta(self, plan: Plan, delta) -> Tuple[Plan, str]:
        """Patch a plan through the cache: (patched, status) with status ∈
        {'mem', 'disk', 'built'}, 'built' meaning patched tile by tile
        (`patch_plan`), never rebuilt.  The patched plan is stored under
        its delta-chained key and the parent's now stale entry retired
        (evicted with a warning, counted in `evicted_stale`)."""
        if delta.is_empty:
            return plan, "mem"
        key = delta_cache_key(plan.key, delta.content_key)
        hit = self._hit(key)
        if hit is not None:
            return hit, "mem"
        if self.cache_dir:
            loaded = self._load(key, plan.reorder)
            if loaded is not None:
                self._count("disk_hits")
                self._remember(key, loaded)
                self._retire_parent(plan)
                return loaded, "disk"
        self._count("misses")
        patched = patch_plan(plan, delta)
        self._remember(patched.key, patched)
        if self.cache_dir:
            self._store(patched)
            self._retire_parent(plan)
        return patched, "built"

    def _retire_parent(self, parent: Plan) -> None:
        """Unlink the superseded parent's disk entry, drop its memory copy."""
        path = self._path(parent.key)
        if os.path.exists(path):
            self._evict_stale(path, f"pre-delta entry (epoch {parent.epoch} superseded)")
        self._mem.pop(parent.key, None)

    # -- disk layer --------------------------------------------------------

    def _path(self, key: str) -> str:
        return os.path.join(self.cache_dir, f"{key}.npz")

    def _store(self, plan: Plan) -> None:
        """Write under a per-writer temporary name, then rename: two
        processes that miss on one key each write their own file and the
        last rename wins with the same content."""
        tmp = self._path(plan.key) + f".tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **plan_arrays(plan))
            os.replace(tmp, self._path(plan.key))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def _evict_stale(self, path: str, found: str) -> None:
        """An old-format or superseded entry: warn once, delete, and let the
        caller rebuild; a stale layout is never read as current."""
        self._count("evicted_stale")
        warnings.warn(
            f"evicting stale plan-cache entry {os.path.basename(path)}: "
            f"{found}, current format v{_PLAN_VERSION} — rebuilding",
            stacklevel=3,
        )
        try:
            os.unlink(path)
        except OSError:
            pass

    def _evict_legacy_version(self, path: str) -> None:
        """Evict the entry at `path` only if it predates the current format
        (the path may hold a live current entry)."""
        if not os.path.exists(path):
            return
        try:
            with np.load(path) as z:
                meta = z["meta"]
                version = int(meta[6]) if meta.shape[0] > 6 else 1
        except Exception:  # noqa: BLE001 — torn or unreadable: stale
            version = 0
        if version != _PLAN_VERSION:
            self._evict_stale(path, f"pre-hybrid entry (format v{version})")

    def _load(self, key: str, reorder: Optional[str]) -> Optional[Plan]:
        path = self._path(key)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path) as z:
                meta = z["meta"]
                if meta.shape[0] < _META_LEN:
                    self._evict_stale(path, "pre-versioned entry (v1 layout)")
                    return None
                if int(meta[6]) != _PLAN_VERSION:
                    self._evict_stale(path, f"format v{int(meta[6])}")
                    return None
                arrays = {name: z[name] for name in z.files}
        except Exception:  # noqa: BLE001 — a torn file: rebuild
            return None
        return plan_from_arrays(arrays, device=self.device, key=key, reorder=reorder)
