"""Luby's randomized parallel MIS (paper Algorithm 1), the classical
baseline, and the MIS result record (counterpart of `repro.core.luby`).

Fresh uniform priorities every round, then the paper's three phases on the
edge list.  The reference runs the loop as one `lax.while_loop`; here it is
a Python loop that syncs once per round on `alive.any()`, so it runs the
rounds the reference runs.  Round r draws under `fold_in(key, r)` with
`core.prng`, the reference's draw bit for bit, so one key gives the
reference's MIS.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core import prng
from repro_torch.core.prng import Key
from repro_torch.core.spmv import neighbor_any_segment, neighbor_max_segment
from repro_torch.graphs.graph import Graph

_INT32_MAX = (1 << 31) - 1


class MISResult(NamedTuple):
    in_mis: torch.Tensor     # (n,) bool
    rounds: torch.Tensor     # int32 — () global, or (n,) per-vertex
    converged: torch.Tensor  # bool — False iff max_rounds hit


def luby_round(
    g: Graph, p: torch.Tensor, alive: torch.Tensor, in_mis: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One round under the priorities `p` (n,) int32: a live vertex above
    all its live neighbours joins the MIS, and it and its neighbours die.
    Returns (alive, in_mis)."""
    return retire(g, alive & (p > neighbor_max_segment(g, p, alive)), alive, in_mis)


def retire(
    g: Graph, cand: torch.Tensor, alive: torch.Tensor, in_mis: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phases ② and ③ on the edge list: the candidates join the MIS, and
    they and their neighbours die.  Returns (alive, in_mis)."""
    hit = neighbor_any_segment(g, cand)
    return alive & ~cand & ~hit, in_mis | cand


def luby_mis(g: Graph, key: Key, *, max_rounds: int = 1024) -> MISResult:
    """Luby's MIS on `g`'s device: round r draws fresh int32 priorities
    uniform in [0, 2^31 - 1) under `fold_in(key, r)` (a tie delays both
    vertices a round, never breaks independence)."""
    n = g.n_nodes
    dev = g.senders.device
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    in_mis = torch.zeros((n,), dtype=torch.bool, device=dev)
    rounds = 0
    while rounds < max_rounds and bool(alive.any()):
        p = prng.randint(prng.fold_in(key, rounds), n, 0, _INT32_MAX, dev)
        alive, in_mis = luby_round(g, p, alive, in_mis)
        rounds += 1
    return MISResult(in_mis=in_mis, rounds=torch.tensor(rounds, dtype=torch.int32),
                     converged=~alive.any())
