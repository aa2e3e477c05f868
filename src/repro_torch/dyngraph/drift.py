"""Drift observability for long mutation streams (counterpart of
`repro.dyngraph.drift`; the same gauges, under the same names).

A patched plan keeps its epoch-0 permutation and tile grid, so tile
locality decays under sustained churn.  These gauges are the signal a
re-anchoring policy would gate on, recorded once per applied delta at the
one funnel every patch passes through (`api.plan.patch_plan`; plan-cache
hits replay a patch and record nothing):

* ``dyngraph.touched_tiles`` (histogram) and ``dyngraph.touched_frac``:
  the distinct tiles a delta's half-edges land in.
* ``dyngraph.locality_decay``: 1 − occupancy / occupancy₀, with occupancy
  the stored-tile density ``2·E / (n_tiles · T²)`` and occupancy₀ the same
  at the epoch-0 build.
* ``dyngraph.dirty_frac``: the share of vertices a delta dirties.

Numpy and the metrics registry only: `api.plan` calls in here.
"""
from __future__ import annotations

import numpy as np

from repro_torch.dyngraph.delta import sorted_unique
from repro_torch.obs import metrics as obs_metrics


def tile_occupancy(n_edges: int, n_tiles: int, tile_size: int) -> float:
    """Mean stored-tile density: half-edge cells over the real tiles'
    cells (each undirected edge fills two cells, hence 2·E)."""
    cap = max(int(n_tiles), 1) * int(tile_size) * int(tile_size)
    return 2.0 * max(int(n_edges), 0) / cap


def touched_tile_count(delta, tile_size: int, n_block_cols: int) -> int:
    """Distinct tiles the delta's half-edges land in (adds and removes
    both count)."""
    T = int(tile_size)
    nbc = np.int64(max(int(n_block_cols), 1))
    keys = []
    for pairs in (delta.add, delta.remove):
        p = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        if not p.shape[0]:
            continue
        u = np.concatenate([p[:, 0], p[:, 1]])
        v = np.concatenate([p[:, 1], p[:, 0]])
        keys.append((u // T) * nbc + (v // T))
    if not keys:
        return 0
    return int(sorted_unique(np.concatenate(keys)).shape[0])


def dirty_vertex_frac(delta, n_nodes: int) -> float:
    """Share of vertices that are an endpoint of some delta edge."""
    both = np.concatenate([
        np.asarray(delta.add, dtype=np.int64).reshape(-1),
        np.asarray(delta.remove, dtype=np.int64).reshape(-1),
    ])
    if not both.shape[0]:
        return 0.0
    return float(sorted_unique(both).shape[0]) / max(int(n_nodes), 1)


def note_drift(
    *,
    epoch: int,
    touched_tiles: int,
    n_tiles: int,
    dirty_frac: float,
    occupancy: float,
    occupancy0: float,
) -> None:
    """Record one patch event's drift metrics into the process registry."""
    reg = obs_metrics.REGISTRY
    reg.counter("dyngraph.epochs").inc()
    reg.gauge("dyngraph.epoch").set(epoch)
    reg.histogram("dyngraph.touched_tiles").observe(touched_tiles)
    reg.gauge("dyngraph.touched_frac").set(
        touched_tiles / max(int(n_tiles), 1)
    )
    reg.gauge("dyngraph.dirty_frac").set(dirty_frac)
    reg.gauge("dyngraph.occupancy").set(occupancy)
    decay = 1.0 - occupancy / occupancy0 if occupancy0 > 0 else 0.0
    reg.gauge("dyngraph.locality_decay").set(decay)
