"""ECL-MIS baseline (Burtscher et al., TOPC'18), the paper's comparison
point, on the edge-list segment ops (counterpart of `repro.core.ecl_mis`).

Luby with a static order: degree-aware priorities (Eq. 1, quantised, with
random low bits) are drawn once and reused every round.  This emulates the
algorithm's rounds; it is not Burtscher's asynchronous CUDA code.  With
one fixed order the run is deterministic, and TC-MIS on the same
priorities computes the same candidate sets: `run_tc_mis` with
`heuristic="ecl"` gives the same MIS.
"""
from __future__ import annotations

import torch

from repro_torch.core.heuristics import Priorities, make_priorities
from repro_torch.core.prng import Key
from repro_torch.core.luby import MISResult, luby_round, retire
from repro_torch.core.spmv import neighbor_max_segment
from repro_torch.graphs.graph import Graph


def ecl_rounds(g: Graph, pri: Priorities, *, max_rounds: int = 1024) -> MISResult:
    """The ECL-MIS loop under fixed priorities (H3's two-pass resolve when
    `pri.resolve` is set); one host sync per round on `alive.any()`."""
    n = g.n_nodes
    dev = g.senders.device
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    in_mis = torch.zeros((n,), dtype=torch.bool, device=dev)
    rounds = 0
    while rounds < max_rounds and bool(alive.any()):
        if pri.resolve is None:
            alive, in_mis = luby_round(g, pri.select, alive, in_mis)
        else:
            pending = alive & (pri.select >= neighbor_max_segment(g, pri.select, alive))
            cand = pending & (pri.resolve > neighbor_max_segment(g, pri.resolve, pending))
            alive, in_mis = retire(g, cand, alive, in_mis)
        rounds += 1
    return MISResult(in_mis=in_mis, rounds=torch.tensor(rounds, dtype=torch.int32),
                     converged=~alive.any())


def ecl_mis(
    g: Graph, key: Key, *, heuristic: str = "ecl", max_rounds: int = 1024
) -> MISResult:
    """ECL-MIS on `g`'s device with priorities drawn once under `key`."""
    pri = make_priorities(heuristic, key, g.n_nodes, g.degrees())
    return ecl_rounds(g, pri, max_rounds=max_rounds)
