"""MIS solution validators (counterpart of `repro.core.validate`).

The serving layer checks every response with `is_valid_mis_checks`: both
invariants from one pass over the graph on its device and one host
transfer for the two verdicts.  `is_valid_mis` rides on it.  The
single-invariant forms compute only their own invariant.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.spmv import _segment_max, neighbor_any_segment
from repro_torch.graphs.graph import Graph


def is_valid_mis_checks(g: Graph, in_mis) -> Tuple[bool, bool]:
    """`(independent, maximal)` as Python bools: the serving layer's
    per-response post-condition (the reference's `is_valid_mis_jit`).

    `in_mis` (a tensor or numpy array, at least `n_nodes` long) is moved
    to the graph's device; the sender gather serves both invariants, and
    the two verdicts come back in one `.tolist()`.  The reference pads its
    inputs to power-of-two buckets to bound XLA's compile cache; the port
    compiles nothing per shape, so it runs on the exact shapes."""
    n = g.n_nodes
    sel = torch.zeros(n + 1, dtype=torch.bool, device=g.device)   # slot n: the sentinel
    sel[:n] = torch.as_tensor(in_mis, device=g.device)[:n].to(torch.bool)
    from_sel = g.edge_mask & sel[g.senders_gather]
    independent = ~(from_sel & sel[g.receivers_long]).any()
    nbr = _segment_max(g.receivers_long, from_sel.to(torch.int32), n + 1)[:n] > 0
    maximal = (sel[:n] | nbr).all()
    independent, maximal = torch.stack([independent, maximal]).tolist()
    return independent, maximal


def is_independent(g: Graph, in_mis: torch.Tensor) -> bool:
    """No edge has both endpoints selected."""
    sel = in_mis.to(torch.bool)
    s = g.senders_gather
    r = torch.where(g.edge_mask, g.receivers, 0).long()
    if sel.shape[0] == 0:
        return True
    return not bool((g.edge_mask & sel[s] & sel[r]).any())


def is_maximal(g: Graph, in_mis: torch.Tensor) -> bool:
    """Every unselected vertex has a selected neighbour."""
    sel = in_mis.to(torch.bool)
    return bool((sel | neighbor_any_segment(g, sel)).all())


def is_valid_mis(g: Graph, in_mis: torch.Tensor) -> bool:
    return all(is_valid_mis_checks(g, in_mis))


def cardinality(in_mis: torch.Tensor) -> int:
    return int(in_mis.to(torch.int64).sum())
