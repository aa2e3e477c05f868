"""TC-MIS (paper Algorithm 2): the convergence loop (counterpart of
`repro.core.tc_mis`).

Per round: ① priority max over live neighbours → candidates C; ② N_c = A×C
as a block-tiled SpMV; ③ candidates join the MIS and their neighbours die.
How a round runs is the engine's business (`core.engine`); this module
owns the set-up, the loop and the epilogue.

The reference runs the loop inside one `lax.while_loop`.  Here it is a
Python loop that syncs once per round on `alive.any()`; it runs exactly
the rounds the reference runs, so `rounds` is equal.  On the bitwise
frontier the state rides as packed words through the whole loop and
`in_mis` unpacks once, in `_result`.

`run_phases` is the profiler twin (the reference's `_run_phases_impl`):
the same round body, stepped phase by phase with a device sync and a
host clock after each.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Tuple

import torch

from repro_torch.core.engine import (
    EngineContext,
    MISRoundState,
    get_engine,
    make_bitwise_context,
    phase3_update,
    phase3_update_bits,
    resolve_frontier,
    round_increment,
)
from repro_torch.core.heuristics import Priorities, make_priorities
from repro_torch.core.luby import MISResult
from repro_torch.core.spmv import _NEG
from repro_torch.core.tiling import (
    BlockTiledGraph,
    pack_frontier_words,
    pack_vertex_vector,
    unpack_frontier_words,
)
from repro_torch.graphs.graph import Graph
from repro_torch.obs.rounds import TELEMETRY_COLS, TELEMETRY_FILL
from repro_torch.obs.trace import Trace, trace_span


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
    `n_padded`-long; on the bitwise frontier `alive0` / `in_mis0` may also
    arrive packed, as (n_blocks, W) int32 words, and pass through.

    The Hopper engines get the priority bit planes their plane-scan kernel
    reads, on any device (the reference builds them on a TPU only); the
    other tile engines get the sorted tiles of the clz form.  Under a tile
    partition these are built over its dense half."""
    engine = get_engine(config.engine)
    if priorities is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or explicit priorities")
        priorities = make_priorities(config.heuristic, generator, g.n_nodes, g.degrees())
    pri = _pad_priorities(priorities, tiled)
    frontier = resolve_frontier(
        config, engine, storage=tiled.storage, member_rounds=member_rounds
    )
    bits = None
    if frontier == "bitwise":
        # hybrid runs walk only the compacted dense partition with the tile
        # machinery: the packed structures are built over it
        bits_tiled = tiled
        if engine.supports_hybrid and tiled.partition is not None:
            bits_tiled = tiled.partition.dense
        bits = make_bitwise_context(bits_tiled, pri, planes=engine.plane_kernel_nbr_max)
    ctx = EngineContext(g=g, tiled=tiled, cfg=config, col_gate=col_gate,
                        frontier=frontier, bits=bits)
    dev = tiled.device
    if alive0 is None:
        alive0 = torch.ones((g.n_nodes,), dtype=torch.bool, device=dev)
    if in_mis0 is None:
        in_mis0 = torch.zeros((g.n_nodes,), dtype=torch.bool, device=dev)

    def as_state_vec(x: torch.Tensor) -> torch.Tensor:
        """Vertex mask -> this run's state form: (n_padded,) bool, or
        packed words on the bitwise frontier (packed input passes)."""
        if x.ndim == 2 and x.dtype == torch.int32:
            return x
        padded = pack_vertex_vector(x.to(torch.bool), tiled)
        if frontier == "bitwise":
            return pack_frontier_words(padded, tiled.tile_size)
        return padded

    rnd0 = torch.zeros((tiled.n_padded,) if member_rounds else (),
                       dtype=torch.int32, device=dev)
    state0 = MISRoundState(alive=as_state_vec(alive0), in_mis=as_state_vec(in_mis0),
                           rnd=rnd0)
    return engine, ctx, pri, state0


def _result(final: MISRoundState, g: Graph, tiled: BlockTiledGraph) -> MISResult:
    """Run epilogue; on the bitwise frontier the one place `in_mis`
    unpacks, after the loop."""
    in_mis = final.in_mis
    if in_mis.ndim == 2 and in_mis.dtype == torch.int32:
        in_mis = unpack_frontier_words(in_mis, tiled.tile_size)
    rounds = final.rnd[: g.n_nodes] if final.rnd.ndim else final.rnd
    return MISResult(
        in_mis=in_mis[: g.n_nodes],
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
):
    """Run TC-MIS to convergence or `config.max_rounds`.

    The loop behind `repro_torch.api.Solver.solve`.  One host sync per
    round (`alive.any()`); the round counter stays on the device.  With
    `member_rounds`, `MISResult.rounds` is the per-vertex settle-round
    vector (sliced to real vertices).

    With `config.telemetry` the loop also carries a (max_rounds,
    TELEMETRY_COLS) int32 buffer on the device, filled with
    TELEMETRY_FILL; round r writes row r (`engine.step_with_stats`) at a
    device index, with no host read, and the return becomes
    `(result, buffer)`, as the reference's `_tc_mis_impl` returns it."""
    engine, ctx, pri, state = _setup(
        g, tiled, generator, config, priorities, alive0, col_gate,
        member_rounds, in_mis0,
    )
    if not getattr(config, "telemetry", False):
        return _result(_converge(engine, ctx, pri, state, config), g, tiled)
    buf = torch.full((int(config.max_rounds), TELEMETRY_COLS), TELEMETRY_FILL,
                     dtype=torch.int32, device=tiled.device)
    return _result(_converge(engine, ctx, pri, state, config, buf), g, tiled), buf


def _converge(engine, ctx: EngineContext, pri: Priorities, state: MISRoundState,
              config, buf: torch.Tensor | None = None) -> MISRoundState:
    """The convergence loop alone (the hot-path lint's seed; its set-up
    and epilogue run once a solve, in `run_tc_mis`): rounds until nothing
    is alive or `config.max_rounds`, each one engine step, with telemetry
    (`buf` given) the instrumented step writing its row of `buf`."""
    # max(rnd) equals the rounds run so far in both counting modes while
    # anything is alive, so the host count bounds the loop exactly like the
    # reference's `max(rnd) < max_rounds`
    rounds = 0
    if buf is None:
        while rounds < config.max_rounds and bool(state.alive.any()):  # repro-lint: disable=RPT010 the one sanctioned sync a round: the loop's exit test reads alive.any()
            state = engine.step(ctx, pri, state)
            rounds += 1
        return state
    while rounds < config.max_rounds and bool(state.alive.any()):  # repro-lint: disable=RPT010 the one sanctioned sync a round: the loop's exit test reads alive.any()
        new, row = engine.step_with_stats(ctx, pri, state)
        # the current round's index: rnd, or max(rnd) when it counts per
        # vertex (a vertex alive now has counted every round so far)
        at = state.rnd.max() if state.rnd.ndim else state.rnd
        buf.index_copy_(0, at.reshape(1).long(), row[None])
        state = new
        rounds += 1
    return state


def run_phases(  # repro-lint: disable=RPT005,RPT010,RPT011 host-stepped profiler twin: per-phase wall timing requires sync
    g: Graph,
    tiled: BlockTiledGraph,
    generator: torch.Generator | None,
    config,
    *,
    priorities: Priorities | None = None,
    trace: Trace | None = None,
) -> Tuple[MISResult, Dict[str, float]]:
    """The profiler twin: the engine's round body stepped from Python,
    with a clock around each phase.

    What `repro_torch.api.Solver.profile` runs; `run_tc_mis` is the
    production loop.  Returns (result, {"phase1": s, "phase2": s,
    "phase3": s, "rounds": k}).  Phase ① is the candidate selection with
    its neighbour maxes; phase ② the SpMV with the column flags it reads
    (for fused engines the ②+③ kernel pass); phase ③ the own-state update
    (for fused engines the residual state merge).  On the card each phase
    ends with `torch.cuda.synchronize`, so its time includes the device
    work it queued; on the CPU every op is synchronous already.  One
    warm-up round, from the first state and thrown away, runs outside the
    timers (it loads the kernels).  `trace` records each timed phase of
    each round as a span, `rounds.phase1` / `rounds.phase2` /
    `rounds.phase3`, sync included.  Under a tile partition the round is
    the hybrid one, ② split even on the fused engine, as `step` runs it:
    phase ② is the dense half's SpMV and the tail's, merged."""
    engine, ctx, pri, state0 = _setup(g, tiled, generator, config, priorities)
    dev = tiled.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    hybrid = engine.supports_hybrid and tiled.partition is not None
    fused = engine.fused and not hybrid
    if hybrid:
        dctx = dataclasses.replace(ctx, tiled=tiled.partition.dense)
    if hybrid and ctx.frontier == "bitwise":
        def p1(alive):
            return engine._hybrid_candidates_bits(ctx, dctx, pri, alive)

        def p2(cand, alive):
            flags = engine.col_flags_bits(ctx, cand)
            return engine._dense_hits_bits(dctx, cand, alive, flags) | \
                engine._sparse_hits_bits(ctx, cand)
        p3 = phase3_update_bits
    elif hybrid:
        def p1(alive):
            return engine._hybrid_candidates(ctx, dctx, pri, alive)

        def p2(cand, alive):
            flags = engine.col_flags(dctx, cand)
            return engine._dense_phase2(dctx, cand, alive, flags) + \
                engine._sparse_counts(ctx, cand)
        p3 = phase3_update
    elif ctx.frontier == "bitwise":
        def p1(alive):
            return engine.phase1_candidates_bits(ctx, pri, alive)

        if fused:
            def p2(cand, alive):
                return engine.fused_step_bits(ctx, cand, alive, engine.col_flags_bits(ctx, cand))
        else:
            def p2(cand, alive):
                return engine.phase2_hits(ctx, cand, alive, engine.col_flags_bits(ctx, cand))
        p3 = phase3_update_bits
    else:
        def p1(alive):
            return engine.phase1_candidates(ctx, pri, alive)

        if fused:
            def p2(cand, alive):
                return engine.fused_step(ctx, cand, alive, engine.col_flags(ctx, cand))
        else:
            def p2(cand, alive):
                return engine.phase2_counts(ctx, cand, alive, engine.col_flags(ctx, cand))
        p3 = phase3_update

    def advance(state, cand, out):
        inc = round_increment(state)
        if fused:
            new_alive, mis_add = out
            return MISRoundState(alive=new_alive, in_mis=state.in_mis | mis_add,
                                 rnd=state.rnd + inc)
        return p3(state, cand, out, inc)

    c = p1(state0.alive)
    advance(state0, c, p2(c, state0.alive))
    sync()

    state = state0
    times = {"phase1": 0.0, "phase2": 0.0, "phase3": 0.0}
    rounds = 0
    while bool(state.alive.any()) and rounds < config.max_rounds:
        t0 = time.perf_counter()
        with trace_span(trace, "rounds.phase1"):
            cand = p1(state.alive)
            sync()
        t1 = time.perf_counter()
        with trace_span(trace, "rounds.phase2"):
            out = p2(cand, state.alive)
            sync()
        t2 = time.perf_counter()
        with trace_span(trace, "rounds.phase3"):
            state = advance(state, cand, out)
            sync()
        t3 = time.perf_counter()
        times["phase1"] += t1 - t0
        times["phase2"] += t2 - t1
        times["phase3"] += t3 - t2
        rounds += 1
    times["rounds"] = rounds
    return _result(state, g, tiled), times
