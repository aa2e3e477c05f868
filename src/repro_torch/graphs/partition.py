"""Host-side partitioning for the distributed runtime (counterpart of
`repro.graphs.partition`; host numpy, the port's own copy).

* ``partition_rows``  — contiguous vertex (block-row) ranges per shard: the
  row split of the sharded TC-MIS route (`core.distributed`), where each
  rank owns a slab of block-rows and the matching slice of the state.
* ``partition_edges`` — half-edges dealt by receiver's owner, for a
  full-graph GNN path (segment-reduce locally, all-reduce nodes).

Every shard is padded to a rectangle (sentinel edges / zero tiles) so the
result stacks into one array with a leading shard axis.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def pad_to_multiple(x: np.ndarray, multiple: int, fill, axis: int = 0) -> np.ndarray:
    """Pad ``x`` along ``axis`` with ``fill`` up to the next multiple."""
    size = x.shape[axis]
    target = ((size + multiple - 1) // multiple) * multiple
    if target == size:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - size)
    return np.pad(x, widths, constant_values=fill)


def partition_rows(n_nodes: int, n_shards: int) -> np.ndarray:
    """(n_shards+1,) vertex-range boundaries, balanced to within one."""
    return np.linspace(0, n_nodes, n_shards + 1).round().astype(np.int64)


def partition_edges(
    senders: np.ndarray,
    receivers: np.ndarray,
    n_nodes: int,
    n_shards: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Shard half-edges by receiver's owner; pad shards to a rectangle.

    Returns (senders_sh, receivers_sh, mask_sh), each (n_shards, E_shard_pad),
    E_shard_pad a multiple of 128 (128 when no shard has an edge); padding
    rows hold the sentinel `n_nodes` and mask False."""
    bounds = partition_rows(n_nodes, n_shards)
    owner = np.searchsorted(bounds, receivers, side="right") - 1
    owner = np.clip(owner, 0, n_shards - 1)
    per_shard = [(senders[owner == sh], receivers[owner == sh]) for sh in range(n_shards)]
    max_e = max((s.shape[0] for s, _ in per_shard), default=0)
    e_pad = ((max_e + 127) // 128) * 128 if max_e else 128
    s_out = np.full((n_shards, e_pad), n_nodes, dtype=np.int32)
    r_out = np.full((n_shards, e_pad), n_nodes, dtype=np.int32)
    m_out = np.zeros((n_shards, e_pad), dtype=bool)
    for sh, (s, r) in enumerate(per_shard):
        k = s.shape[0]
        s_out[sh, :k] = s
        r_out[sh, :k] = r
        m_out[sh, :k] = True
    return s_out, r_out, m_out
