"""TC-MIS (paper Algorithm 2): the convergence loop (counterpart of
`repro.core.tc_mis`).

Per round: ① priority max over live neighbours → candidates C; ② N_c = A×C
as a block-tiled SpMV; ③ candidates join the MIS and their neighbours die.
How a round runs is the engine's business (`core.engine`); this module
owns the set-up, the loop and the epilogue.

The reference runs the loop inside one `lax.while_loop`.  Here it is a
Python loop that syncs once per round on `alive.any()`; it runs exactly
the rounds the reference runs, so `rounds` is equal.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import (
    EngineContext,
    MISRoundState,
    get_engine,
    resolve_frontier,
)
from repro_torch.core.heuristics import Priorities, make_priorities
from repro_torch.core.luby import MISResult
from repro_torch.core.spmv import _NEG
from repro_torch.core.tiling import BlockTiledGraph, pack_vertex_vector
from repro_torch.graphs.graph import Graph


def _pad_priorities(pri: Priorities, tiled: BlockTiledGraph) -> Priorities:
    def pad(x):
        n_pad = tiled.n_padded - x.shape[0]
        return torch.nn.functional.pad(x, (0, n_pad), value=_NEG) if n_pad else x

    return Priorities(
        select=pad(pri.select),
        resolve=None if pri.resolve is None else pad(pri.resolve),
    )


def _setup(
    g: Graph,
    tiled: BlockTiledGraph,
    generator: torch.Generator | None,
    config,
    priorities: Priorities | None = None,
    alive0: torch.Tensor | None = None,
    col_gate: torch.Tensor | None = None,
    member_rounds: bool = False,
    in_mis0: torch.Tensor | None = None,
):
    """Run prologue: engine, context, padded priorities, state₀.

    The seams are the reference's: `priorities` replaces the heuristic's
    draw (then `generator` is unused), `alive0` starts some vertices dead,
    `col_gate` pins block-columns off, `member_rounds` counts rounds per
    vertex, and `in_mis0` warm-starts the MIS set (callers guarantee it is
    independent and disjoint from `alive0`).  Vectors may be `n_nodes`- or
    `n_padded`-long."""
    engine = get_engine(config.engine)
    if priorities is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or explicit priorities")
        priorities = make_priorities(config.heuristic, generator, g.n_nodes, g.degrees())
    pri = _pad_priorities(priorities, tiled)
    frontier = resolve_frontier(
        config, engine, storage=tiled.storage, member_rounds=member_rounds
    )
    ctx = EngineContext(g=g, tiled=tiled, cfg=config, col_gate=col_gate,
                        frontier=frontier)
    dev = tiled.device
    if alive0 is None:
        alive0 = torch.ones((g.n_nodes,), dtype=torch.bool, device=dev)
    if in_mis0 is None:
        in_mis0 = torch.zeros((g.n_nodes,), dtype=torch.bool, device=dev)
    rnd0 = torch.zeros((tiled.n_padded,) if member_rounds else (),
                       dtype=torch.int32, device=dev)
    state0 = MISRoundState(
        alive=pack_vertex_vector(alive0.to(torch.bool), tiled),
        in_mis=pack_vertex_vector(in_mis0.to(torch.bool), tiled),
        rnd=rnd0,
    )
    return engine, ctx, pri, state0


def _result(final: MISRoundState, g: Graph) -> MISResult:
    rounds = final.rnd[: g.n_nodes] if final.rnd.ndim else final.rnd
    return MISResult(
        in_mis=final.in_mis[: g.n_nodes],
        rounds=rounds,
        converged=~final.alive.any(),
    )


def run_tc_mis(
    g: Graph,
    tiled: BlockTiledGraph,
    generator: torch.Generator | None,
    config,
    *,
    priorities: Priorities | None = None,
    alive0: torch.Tensor | None = None,
    col_gate: torch.Tensor | None = None,
    member_rounds: bool = False,
    in_mis0: torch.Tensor | None = None,
) -> MISResult:
    """Run TC-MIS to convergence or `config.max_rounds`.

    The loop behind `repro_torch.api.Solver.solve`.  One host sync per
    round (`alive.any()`); the round counter stays on the device.  With
    `member_rounds`, `MISResult.rounds` is the per-vertex settle-round
    vector (sliced to real vertices)."""
    if getattr(config, "telemetry", False):
        raise NotImplementedError(
            "telemetry=True is not ported yet (ROADMAP.md, Queue 1 item 15)"
        )
    engine, ctx, pri, state = _setup(
        g, tiled, generator, config, priorities, alive0, col_gate,
        member_rounds, in_mis0,
    )
    # max(rnd) equals the rounds run so far in both counting modes while
    # anything is alive, so the host count bounds the loop exactly like the
    # reference's `max(rnd) < max_rounds`
    rounds = 0
    while rounds < config.max_rounds and bool(state.alive.any()):
        state = engine.step(ctx, pri, state)
        rounds += 1
    return _result(state, g)
