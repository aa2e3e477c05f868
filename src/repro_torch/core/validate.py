"""MIS solution validators (counterpart of `repro.core.validate`)."""
from __future__ import annotations

import torch

from repro_torch.core.spmv import neighbor_any_segment
from repro_torch.graphs.graph import Graph


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
    return is_independent(g, in_mis) and is_maximal(g, in_mis)


def cardinality(in_mis: torch.Tensor) -> int:
    return int(in_mis.to(torch.int64).sum())
