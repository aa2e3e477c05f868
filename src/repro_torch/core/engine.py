"""The round-engine layer (counterpart of `repro.core.engine`).

Every execution path is an engine that runs one MIS round; `core.tc_mis`
owns only the convergence loop.  Registered engines, under
the reference's names:

  segment       gather/segment ops over the edge list (ECL-MIS analogue).
  tiled_ref     plain-torch BSR tile schedule — what the kernels are held
                against.
  tiled_pallas  phase ② on the Hopper split SpMV kernels
                (`hopper.tc_spmv.tc_spmv` / `tc_spmv_bits`).
  fused_pallas  phases ②+③ in one Hopper kernel pass
                (`hopper.tc_spmv.tc_spmv_fused` / `tc_spmv_fused_bits`);
                the default engine.

The two Hopper engines keep the reference's names so `SolveOptions` reads
the same in both packages; on CPU tensors their wrappers run the plain
versions (only the CPU tests ask for that).  With `phase1="tiled"` they
run phase ① on the Hopper neighbour-max kernels
(`hopper.tc_neighbor_max`): the masked max on the dense frontier, the
priority-plane scan on the packed one.

Frontiers (`resolve_frontier`, the reference's rule): the tile engines
declare `supports_bitwise`, so `phase1="tiled"` on bitpack storage runs
the packed-word round body (`step_bits`): alive / in_mis / candidate sets
ride as (n_blocks, W) int32 words, phase ② is a word AND, and phase ① is
the plane scan (Hopper engines) or its collapsed clz form over
priority-sorted slots (`tiled_ref`).

Hybrid routing: the tile engines declare `supports_hybrid`, so a tiling
that carries a `TilePartition` runs `step_hybrid` / `step_bits_hybrid`.
Phases ① and ② each run twice, the engine's own tile machinery over the
compacted dense partition and segment ops over the COO tail, and the
halves merge exactly (max for Max_Np, + or | for ②) before phase ③, so
the MIS is the one the unpartitioned tiling gives.  The dense half masks
block-rows that own no dense tile (`_covered_vertices`).  The fused
engine runs the split ② under a partition: its in-kernel ③ cannot see
the tail's hits.

Per-round metadata: tiled engines gate block-columns with no candidate off
(`block_col_flags`, ANDed with the static `col_gate`); a gated column
contributes nothing on any lane, in the kernels and in `tile_spmv` alike.

Telemetry runs step `step_with_stats` instead of `step`: the same round
body, the same kernel launches and the same column flags, plus six
reductions into one `obs.rounds` row.  `step` itself carries no telemetry.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.spmv import INT32_MIN, _NEG, _segment_max
from repro_torch.core.tiling import (
    BlockTiledGraph,
    byte_popcounts,
    dense_tile_mask,
    gather_frontier_bits,
    pack_frontier_bits,
    pack_frontier_words,
    pack_priority_planes,
    pack_vertex_vector,
    sort_block_priorities,
    sorted_frontier_words,
    sorted_tile_bits,
    tiles_as_words,
    unpack_frontier_words,
)
from repro_torch.graphs.graph import Graph
from repro_torch.obs.rounds import (
    COL_ALIVE,
    COL_FRONTIER,
    COL_SELECTED,
    COL_TILES_DENSE,
    COL_TILES_SKIPPED,
    COL_TILES_SPARSE,
    TELEMETRY_COLS,
)


# --------------------------------------------------------------------------
# plain-torch tile operators (the kernels' plain versions build on these)
# --------------------------------------------------------------------------

def tile_spmv(
    tiles: torch.Tensor,          # (nt, T, T) int8 | (nt, T, W) int32 words
    tile_rows: torch.Tensor,      # (nt,) int32, non-decreasing
    tile_cols: torch.Tensor,      # (nt,) int32
    rhs: torch.Tensor,            # (nbc*T, L) float
    n_block_rows: int,
    tile_size: int,
    *,
    col_flags: torch.Tensor | None = None,   # (nbc,) int32; None = all active
) -> torch.Tensor:
    """N = A @ rhs over BSR tiles.  Gated RHS slabs are zeroed before the
    contraction, so a skipped tile contributes nothing on any lane.
    Returns (n_block_rows*T, L) float32; rows no tile maps to are 0."""
    T = tile_size
    L = rhs.shape[-1]
    mask = dense_tile_mask(tiles, T).to(torch.float32)       # (nt, T, T)
    # int32 indices: subscripts and index_add_ take them as they are
    gathered = rhs.reshape(-1, T, L)[tile_cols].to(torch.float32)  # (nt, T, L)
    if col_flags is not None:
        gathered = gathered * col_flags[tile_cols][:, None, None].to(torch.float32)
    prod = torch.bmm(mask, gathered)
    out = torch.zeros((n_block_rows, T, L), dtype=torch.float32, device=rhs.device)
    out.index_add_(0, tile_rows, prod)
    return out.reshape(n_block_rows * T, L)


def tile_neighbor_max(
    tiles: torch.Tensor,
    tile_rows: torch.Tensor,
    tile_cols: torch.Tensor,
    pm: torch.Tensor,             # (nbc*T,) pre-masked priorities (_NEG = dead)
    n_block_rows: int,
    tile_size: int,
) -> torch.Tensor:
    """Max_Np over the BSR schedule; rows no tile maps to get int32 min."""
    T = tile_size
    mask = dense_tile_mask(tiles, T)
    gathered = pm.reshape(-1, T)[tile_cols.long()]           # (nt, T)
    vals = torch.where(mask, gathered[:, None, :], _NEG)      # (nt, T, T)
    tile_max = vals.amax(dim=2).to(torch.int32)               # (nt, T)
    out = torch.full((n_block_rows, T), INT32_MIN, dtype=torch.int32,
                     device=pm.device)
    out.scatter_reduce_(0, tile_rows.long()[:, None].expand(-1, T), tile_max, "amax")
    return out.reshape(n_block_rows * T)


def block_col_flags(x: torch.Tensor, tile_size: int) -> torch.Tensor:
    """(nbc*T,) vector -> (nbc,) int32 0/1: is any vertex of the column set?"""
    return x.reshape(-1, tile_size).to(torch.bool).any(dim=1).to(torch.int32)


# --------------------------------------------------------------------------
# plain-torch packed-word tile operators (the bitwise round body's substrate)
# --------------------------------------------------------------------------

def live_bits(tile_size: int) -> int:
    """The bits of a packed word that carry vertices: the low T when T < 32,
    all 32 otherwise (as an int32 value)."""
    return (1 << int(tile_size)) - 1 if tile_size < 32 else -1


def _as_int32(v: int) -> int:
    return v - (1 << 32) if v >= (1 << 31) else v


# (shift, mask of the top `shift` bits) for the five-step leading-zero count
_CLZ_STEPS = tuple((s, _as_int32(((1 << s) - 1) << (32 - s))) for s in (16, 8, 4, 2, 1))


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of the uint32 words `x` holds as int32, by a binary
    search on masked shifts (integer ops only; float log2 rounds wrongly
    near powers of two).  A zero word gives 31: callers mask it."""
    n = torch.zeros_like(x)
    for shift, top in _CLZ_STEPS:
        empty = (x & top) == 0
        n = n + empty.to(x.dtype) * shift
        x = torch.where(empty, x << shift, x)
    return n


def tile_spmv_bits(
    tiles_bits: torch.Tensor,     # (nt, T, W) int32 words, standard layout
    tile_rows: torch.Tensor,      # (nt,) int32, non-decreasing
    tile_cols: torch.Tensor,      # (nt,) int32
    rhs_words: torch.Tensor,      # (nbc, W) int32 packed candidate vector
    n_block_rows: int,
    tile_size: int,
    *,
    col_flags: torch.Tensor | None = None,   # (nbc,) int32; None = all active
) -> torch.Tensor:
    """② on words: row v is hit iff `tile_word & cand_word != 0` for some
    tile and word.  Gated candidate words are zeroed first, so a skipped
    column hits nothing.  Returns (n_block_rows, W) hit words; rows no tile
    maps to are 0."""
    T = int(tile_size)
    gathered = rhs_words[tile_cols]                               # (nt, W)
    if col_flags is not None:
        gathered = gathered * col_flags[tile_cols][:, None].to(torch.int32)
    hit = ((tiles_bits & gathered[:, None, :]) != 0).any(dim=2)   # (nt, T)
    acc = torch.zeros((n_block_rows, T), dtype=torch.int32, device=rhs_words.device)
    acc.scatter_reduce_(0, tile_rows.long()[:, None].expand(-1, T), hit.to(torch.int32),
                        "amax")
    return pack_frontier_bits(acc, T)


def tile_neighbor_max_bits(
    tiles_sorted: torch.Tensor,       # (nt, T, W) int32, MSB-first slot order
    tile_rows: torch.Tensor,
    tile_cols: torch.Tensor,
    p_sorted: torch.Tensor,           # (nbc, T) int32, descending per block
    mask_sorted_words: torch.Tensor,  # (nbc, W) int32, sorted-slot layout
    n_block_rows: int,
    tile_size: int,
) -> torch.Tensor:
    """① Max_Np on words, the plane scan collapsed to one pass: with each
    block-column's slots sorted by descending priority, the max over a tile
    row's live neighbours is the priority of the first set slot of
    `tile_row & mask` (leading-zero count per word).  Exact for any int32
    priorities.  Returns (n_block_rows·T,) int32: `_NEG` where a tile row
    has no live neighbour, int32 min where no tile maps."""
    T = int(tile_size)
    m = tiles_sorted & mask_sorted_words[tile_cols][:, None, :]   # (nt, T, W)
    first = torch.full(m.shape[:2], T, dtype=torch.int32, device=m.device)
    for w in range(m.shape[-1]):
        word = m[..., w]
        at = torch.where(word != 0, w * 32 + clz32(word), T)
        first = torch.minimum(first, at)
    val = torch.gather(p_sorted[tile_cols], 1, first.clamp(max=T - 1).long())
    tile_max = torch.where(first < T, val, _NEG).to(torch.int32)
    out = torch.full((n_block_rows, T), INT32_MIN, dtype=torch.int32, device=m.device)
    out.scatter_reduce_(0, tile_rows.long()[:, None].expand(-1, T), tile_max, "amax")
    return out.reshape(n_block_rows * T)


class SortedPriorityTiles(NamedTuple):
    """One priority key's clz-form set-up: the static block-column sort
    and the adjacency re-packed in that slot order."""
    order: torch.Tensor      # (nbc, T) int32 — descending-priority column order
    p_sorted: torch.Tensor   # (nbc, T) int32 — priorities in slot order
    tiles: torch.Tensor      # (nt, T, W) int32 — MSB-first sorted-slot layout


class BitwiseContext(NamedTuple):
    """What the packed-frontier round body precomputes per solve.

    `tiles_bits` is the adjacency as standard-layout words (phase ②, and
    the plane scan).  Phase ① takes one of two forms: the clz form reads
    `select`/`resolve` (sorted tiles, built when `planes=False`), the
    plane-scan kernel reads `*_planes` ((n_bits, nbc, W) stacks, built
    when `planes=True`).  Only the form a run uses is built; the other
    fields are None."""
    tiles_bits: torch.Tensor
    select: Optional[SortedPriorityTiles]
    resolve: Optional[SortedPriorityTiles]
    select_planes: Optional[torch.Tensor]
    resolve_planes: Optional[torch.Tensor]


# H3 select keys are (q << 23) ≥ 0 with q ≤ 255, and the other heuristics'
# keys are non-negative too → 31 unsigned planes; resolve keys are negative
# (-deg·n - id) → 32 sign-biased planes.
SELECT_PLANE_BITS = 31
RESOLVE_PLANE_BITS = 32


def make_bitwise_context(tiled: BlockTiledGraph, pri, *, planes: bool = False) -> BitwiseContext:
    """Build the per-solve packed structures from the (padded) priorities,
    which stay fixed for the whole solve."""
    T = tiled.tile_size
    tiles_bits = tiles_as_words(tiled.tiles, T)
    if planes:
        sel = pack_priority_planes(pri.select, T, SELECT_PLANE_BITS, signed=False)
        res = None if pri.resolve is None else pack_priority_planes(
            pri.resolve, T, RESOLVE_PLANE_BITS, signed=True)
        return BitwiseContext(tiles_bits, None, None, sel, res)

    def _sorted_for(p):
        order, p_sorted = sort_block_priorities(p, T)
        tiles_sorted = sorted_tile_bits(tiled.tiles, tiled.tile_cols, order, T)
        return SortedPriorityTiles(order, p_sorted, tiles_sorted)

    select = _sorted_for(pri.select)
    resolve = _sorted_for(pri.resolve) if pri.resolve is not None else None
    return BitwiseContext(tiles_bits, select, resolve, None, None)


# --------------------------------------------------------------------------
# state + context
# --------------------------------------------------------------------------

def resolve_frontier(config, engine, *, storage: str, member_rounds: bool = False) -> str:
    """Resolve `SolveOptions.frontier` to the concrete mode a run uses —
    the reference's rule verbatim.  "auto" picks "bitwise" for a tile
    engine with the tiled phase ① on bitpack storage and a scalar round
    counter; an explicit "bitwise" the engine cannot honour runs dense."""
    mode = getattr(config, "frontier", "auto") or "auto"
    if mode == "auto":
        if (
            engine.supports_bitwise
            and not member_rounds
            and getattr(config, "phase1", "tiled") == "tiled"
            and storage == "bitpack"
        ):
            return "bitwise"
        return "dense"
    if mode == "bitwise" and (not engine.supports_bitwise or member_rounds):
        return "dense"
    return mode


class MISRoundState(NamedTuple):
    """Per-round state; `alive`/`in_mis` are (n_padded,) bool, or
    (n_blocks, W) int32 words when the frontier is bitwise.  `rnd` is a
    0-dim int32 round counter, or an (n_padded,) int32 per-vertex counter
    that advances only while its vertex is alive (`member_rounds`)."""
    alive: torch.Tensor
    in_mis: torch.Tensor
    rnd: torch.Tensor


@dataclasses.dataclass(frozen=True)
class EngineContext:
    """What an engine closes over for one run: the graph in both
    representations, the options, the static (n_block_cols,) 0/1 column
    gate (None = every column may carry candidates), the resolved
    frontier mode ("dense" | "bitwise") and, when bitwise, the per-solve
    packed structures."""
    g: Graph
    tiled: BlockTiledGraph
    cfg: Any   # anything with engine/heuristic/lanes/phase1/skip_dma/max_rounds
    col_gate: Optional[torch.Tensor] = None
    frontier: str = "dense"
    bits: Optional[BitwiseContext] = None


def round_increment(state: MISRoundState):
    """Scalar `rnd` ⇒ +1; vector `rnd` ⇒ +alive."""
    if state.rnd.ndim:
        return state.alive.to(torch.int32)
    return 1


def phase3_update(
    state: MISRoundState,
    cand: torch.Tensor,
    n_c: torch.Tensor,
    rnd_inc=None,
) -> MISRoundState:
    """③ own-state update (the paper's three rules)."""
    return MISRoundState(
        alive=state.alive & ~cand & ~(n_c > 0),
        in_mis=state.in_mis | cand,
        rnd=state.rnd + (round_increment(state) if rnd_inc is None else rnd_inc),
    )


def phase3_update_bits(
    state: MISRoundState,
    cand_words: torch.Tensor,
    hit_words: torch.Tensor,
    rnd_inc=None,
) -> MISRoundState:
    """③ on packed words: the same three rules, 32 vertices per op."""
    return MISRoundState(
        alive=state.alive & ~cand_words & ~hit_words,
        in_mis=state.in_mis | cand_words,
        rnd=state.rnd + (round_increment(state) if rnd_inc is None else rnd_inc),
    )


# --------------------------------------------------------------------------
# round telemetry reductions: folds over state the round body already
# holds; used only by `step_with_stats`, never by `step`.  Each op is a
# host dispatch, so a round's four set sizes are taken in one stacked pass.
# --------------------------------------------------------------------------

def _set_sizes(sets: torch.Tensor) -> torch.Tensor:
    """Sizes of k stacked vertex sets: (k, n) bool vectors, or (k, nbc, W)
    packed int32 words (the bits of uint32 words) → (k,) int32; the
    reference's `_count` and `_popcount_words`, k sets at a time.  torch
    has no popcount: a word counts as the sum of its four bytes' counts,
    read from a 256-entry table through a uint8 view."""
    k = sets.shape[0]
    if sets.dtype == torch.bool:
        return sets.reshape(k, -1).sum(dim=1, dtype=torch.int32)
    table = byte_popcounts(sets.device)
    return table[sets.reshape(k, -1).view(torch.uint8).long()].sum(dim=1, dtype=torch.int32)


def _tiles_skipped(ctx: EngineContext, flags: Optional[torch.Tensor]) -> torch.Tensor:
    """Tiles gated off this round by the empty-C column skip: every tile,
    padding included (`n_tiles_pad`, as the reference counts
    `tile_cols.shape[0]`), whose block column has flag 0.  An engine
    without flags (segment) skips nothing: 0."""
    if flags is None:
        return torch.zeros((), dtype=torch.int32, device=ctx.tiled.device)
    kept = torch.index_select(flags, 0, ctx.tiled.tile_cols).sum(dtype=torch.int32)
    return ctx.tiled.n_tiles_pad - kept


def _tiles_routed_dense(
    ctx: EngineContext, skipped: torch.Tensor, flags: Optional[torch.Tensor]
) -> torch.Tensor:
    """Tiles dispatched on the dense path this round: the stored list
    minus the gated ones.  An engine with no tile schedule routes none."""
    if flags is None:
        return torch.zeros((), dtype=torch.int32, device=ctx.tiled.device)
    return ctx.tiled.n_tiles_pad - skipped


def _telemetry_row(alive, frontier, selected, skipped, tiles_dense, tiles_sparse) -> torch.Tensor:
    """(TELEMETRY_COLS,) int32 row in the `obs.rounds` column layout,
    built on the device from 0-dim int32 tensors."""
    vals = [None] * TELEMETRY_COLS
    vals[COL_ALIVE] = alive
    vals[COL_FRONTIER] = frontier
    vals[COL_SELECTED] = selected
    vals[COL_TILES_SKIPPED] = skipped
    vals[COL_TILES_DENSE] = tiles_dense
    vals[COL_TILES_SPARSE] = tiles_sparse
    return torch.stack(vals)


def _round_row(ctx: EngineContext, state, cand, new, flags, tiles_sparse: int = 0) -> torch.Tensor:
    """One round's telemetry row, on either frontier: the sizes of alive
    at entry, of C, and of in_mis after minus before; the tiles the
    round's own column flags skipped and kept on `ctx.tiled` (the dense
    partition under hybrid routing); the tiles routed to the COO tail."""
    alive, frontier, mis_new, mis_old = _set_sizes(
        torch.stack((state.alive, cand, new.in_mis, state.in_mis))).unbind()
    skipped = _tiles_skipped(ctx, flags)
    return _telemetry_row(
        alive, frontier, mis_new - mis_old, skipped,
        _tiles_routed_dense(ctx, skipped, flags),
        torch.full((), tiles_sparse, dtype=torch.int32, device=alive.device),
    )


def _covered_rows(tiled: BlockTiledGraph) -> torch.Tensor:
    """(n_block_rows,) bool: block-rows that own at least one stored tile.
    A full tiling covers every row that has an edge; the compacted dense
    partition of a hybrid plan routinely leaves rows whose every tile
    went to the tail, and their dense-half lanes are masked out."""
    return tiled.row_starts[1:] > tiled.row_starts[:-1]


def _covered_vertices(tiled: BlockTiledGraph) -> torch.Tensor:
    """`_covered_rows` on the (n_padded,) vertex axis."""
    return _covered_rows(tiled).repeat_interleave(tiled.tile_size)


# --------------------------------------------------------------------------
# the engine interface
# --------------------------------------------------------------------------

class TorchRoundEngine:
    """One MIS round as pluggable pieces: `_nbr_max` (phase ①), and
    `phase2_counts` (split engines) or `fused_step` (fused engines).
    `step` is the one round body every loop uses; it dispatches to
    `step_bits` when the resolved frontier is bitwise."""

    name: str = "abstract"
    fused: bool = False
    supports_bitwise: bool = False
    supports_hybrid: bool = False
    # wants the (n_bits, nbc, W) plane stacks built at set-up: the Hopper
    # engines, whose bitwise phase ① runs the plane-scan kernel
    plane_kernel_nbr_max: bool = False

    def _nbr_max(self, ctx: EngineContext, p: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def phase1_candidates(self, ctx: EngineContext, pri, alive: torch.Tensor) -> torch.Tensor:
        """① Max_Np + candidate test (+ H3 pending-set resolution)."""
        max_np = self._nbr_max(ctx, pri.select, alive)
        if pri.resolve is None:
            return alive & (pri.select > max_np)
        pending = alive & (pri.select >= max_np)
        max_res = self._nbr_max(ctx, pri.resolve, pending)
        return pending & (pri.resolve > max_res)

    def col_flags(self, ctx: EngineContext, cand: torch.Tensor) -> Optional[torch.Tensor]:
        """Active block-column flags for the empty-C tile skip."""
        flags = block_col_flags(cand, ctx.tiled.tile_size)
        if ctx.col_gate is not None:
            flags = flags * ctx.col_gate.to(flags.dtype)
        return flags

    def _pack_rhs(self, ctx: EngineContext, cand: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
        """Lane-packed RHS: lane 0 = C, lane 1 = alive, `lanes` wide."""
        rhs = torch.zeros((ctx.tiled.n_padded, ctx.cfg.lanes), dtype=torch.float32,
                          device=cand.device)
        rhs[:, 0] = cand.to(torch.float32)
        rhs[:, 1] = alive.to(torch.float32)
        return rhs

    def phase2_counts(self, ctx, cand, alive, col_flags=None) -> torch.Tensor:
        """② N_c = A × C.  Returns (n_padded,) float32."""
        raise NotImplementedError(f"{self.name} is a fused engine")

    def fused_step(self, ctx, cand, alive, col_flags=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """②+③ in one pass.  Returns (new_alive, mis_add) bool vectors."""
        raise NotImplementedError(f"{self.name} is a split engine")

    def step_bits(self, ctx: EngineContext, pri, state: MISRoundState) -> MISRoundState:
        raise NotImplementedError(
            f"{self.name} has no packed-frontier round body "
            f"(supports_bitwise={self.supports_bitwise})"
        )

    def step(self, ctx: EngineContext, pri, state: MISRoundState) -> MISRoundState:
        if self.supports_hybrid and ctx.tiled.partition is not None:
            if ctx.frontier == "bitwise":
                return self.step_bits_hybrid(ctx, pri, state)
            return self.step_hybrid(ctx, pri, state)
        if ctx.frontier == "bitwise":
            return self.step_bits(ctx, pri, state)
        cand = self.phase1_candidates(ctx, pri, state.alive)
        flags = self.col_flags(ctx, cand)
        inc = round_increment(state)
        if self.fused:
            new_alive, mis_add = self.fused_step(ctx, cand, state.alive, flags)
            return MISRoundState(
                alive=new_alive,
                in_mis=state.in_mis | mis_add,
                rnd=state.rnd + inc,
            )
        n_c = self.phase2_counts(ctx, cand, state.alive, flags)
        return phase3_update(state, cand, n_c, inc)

    # -- the instrumented round body (telemetry runs only) -----------------
    def _step_bits_with_stats(self, ctx, pri, state: MISRoundState):
        raise NotImplementedError(
            f"{self.name} has no packed-frontier round body "
            f"(supports_bitwise={self.supports_bitwise})"
        )

    def step_with_stats(
        self, ctx: EngineContext, pri, state: MISRoundState
    ) -> Tuple[MISRoundState, torch.Tensor]:
        """`step` plus a (TELEMETRY_COLS,) int32 row on the device: the
        same round body, kernel launches and column flags, plus six
        reductions (no extra SpMV, no host read)."""
        if self.supports_hybrid and ctx.tiled.partition is not None:
            if ctx.frontier == "bitwise":
                return self._step_bits_hybrid_with_stats(ctx, pri, state)
            return self._step_hybrid_with_stats(ctx, pri, state)
        if ctx.frontier == "bitwise":
            return self._step_bits_with_stats(ctx, pri, state)
        cand = self.phase1_candidates(ctx, pri, state.alive)
        flags = self.col_flags(ctx, cand)
        inc = round_increment(state)
        if self.fused:
            new_alive, mis_add = self.fused_step(ctx, cand, state.alive, flags)
            new = MISRoundState(
                alive=new_alive,
                in_mis=state.in_mis | mis_add,
                rnd=state.rnd + inc,
            )
        else:
            n_c = self.phase2_counts(ctx, cand, state.alive, flags)
            new = phase3_update(state, cand, n_c, inc)
        return new, _round_row(ctx, state, cand, new, flags)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

ENGINES: Dict[str, TorchRoundEngine] = {}

_ALIASES = {"ref": "tiled_ref", "pallas": "tiled_pallas", "fused": "fused_pallas"}
_DEPRECATED_SPELLINGS = ("ref", "pallas")


def register_engine(engine: TorchRoundEngine) -> TorchRoundEngine:
    ENGINES[engine.name] = engine
    return engine


def get_engine(name: str) -> TorchRoundEngine:
    resolved = _ALIASES.get(name, name)
    if name in _DEPRECATED_SPELLINGS:
        warnings.warn(
            f"engine spelling {name!r} is deprecated; use {resolved!r} "
            f"(SolveOptions(engine={resolved!r}))",
            DeprecationWarning,
            stacklevel=2,
        )
    if resolved not in ENGINES:
        raise ValueError(
            f"unknown engine {name!r}; registered: {sorted(ENGINES)} "
            f"(aliases: {_ALIASES})"
        )
    return ENGINES[resolved]


def engine_names() -> Tuple[str, ...]:
    return tuple(ENGINES)


# --------------------------------------------------------------------------
# the four engines
# --------------------------------------------------------------------------

def _segment_nbr_max(ctx: EngineContext, p, mask) -> torch.Tensor:
    from repro_torch.core.spmv import neighbor_max_segment

    n = ctx.g.n_nodes
    out = neighbor_max_segment(ctx.g, p[:n], mask[:n])
    return pack_vertex_vector(out, ctx.tiled)


def _segment_nbr_max_bits_oracle(ctx: EngineContext, p, mask_words) -> torch.Tensor:
    """Phase ① for bitwise runs that pin `phase1="segment"`: the edge list
    has no word form, so the mask words unpack here."""
    mask = unpack_frontier_words(mask_words, ctx.tiled.tile_size)
    return _segment_nbr_max(ctx, p, mask)


class TorchSegmentEngine(TorchRoundEngine):
    """Paper-faithful CC baseline: every phase on the edge-list substrate."""

    name = "segment"

    def _nbr_max(self, ctx, p, mask):
        return _segment_nbr_max(ctx, p, mask)

    def col_flags(self, ctx, cand):
        return None   # no tiles, nothing to skip

    def phase2_counts(self, ctx, cand, alive, col_flags=None):
        from repro_torch.core.spmv import neighbor_sum_segment

        n = ctx.g.n_nodes
        n_c = neighbor_sum_segment(ctx.g, cand[:n].to(torch.float32))
        return pack_vertex_vector(n_c, ctx.tiled)


class TorchTiledEngine(TorchRoundEngine):
    """Shared phase-① policy for tile-schedule engines: `cfg.phase1` picks
    the segment max or the tiled max.  Also owns the packed-frontier round
    body (`step_bits`) and the hybrid round bodies (`step_hybrid`,
    `step_bits_hybrid`)."""

    supports_bitwise = True
    supports_hybrid = True

    def _tiled_nbr_max(self, ctx, p, mask) -> torch.Tensor:
        t = ctx.tiled
        return tile_neighbor_max(
            t.tiles, t.tile_rows, t.tile_cols, torch.where(mask, p, _NEG),
            t.n_block_rows, t.tile_size,
        )

    def _nbr_max(self, ctx, p, mask):
        if ctx.cfg.phase1 != "tiled":
            return _segment_nbr_max(ctx, p, mask)
        return self._tiled_nbr_max(ctx, p, mask)

    # -- packed-frontier round body ----------------------------------------
    def _nbr_max_bits(self, ctx, st: SortedPriorityTiles, planes, mask_words) -> torch.Tensor:
        """Bitwise Max_Np, clz form: remap the mask words into `st`'s
        sorted-slot layout, then find the first set slot.  `planes` is
        ignored here; the Hopper engines run the plane scan on it."""
        t = ctx.tiled
        mask_sorted = sorted_frontier_words(mask_words, st.order, t.tile_size)
        return tile_neighbor_max_bits(
            st.tiles, t.tile_rows, t.tile_cols, st.p_sorted, mask_sorted,
            t.n_block_rows, t.tile_size,
        )

    def phase1_candidates_bits(self, ctx, pri, alive_words) -> torch.Tensor:
        """① on packed frontiers.  Priorities stay dense (they are values);
        the alive / pending / candidate sets stay packed.  Padded alive
        bits are 0, so the `& alive_words` / `& pending` guards erase the
        fills where the substrates differ."""
        T = ctx.tiled.tile_size
        b = ctx.bits
        if ctx.cfg.phase1 != "tiled":
            max_np = _segment_nbr_max_bits_oracle(ctx, pri.select, alive_words)
        else:
            max_np = self._nbr_max_bits(ctx, b.select, b.select_planes, alive_words)
        if pri.resolve is None:
            return pack_frontier_words(pri.select > max_np, T) & alive_words
        # H3: conflicts resolved on the pending set before C is finalised
        pending = pack_frontier_words(pri.select >= max_np, T) & alive_words
        if ctx.cfg.phase1 != "tiled":
            max_res = _segment_nbr_max_bits_oracle(ctx, pri.resolve, pending)
        else:
            max_res = self._nbr_max_bits(ctx, b.resolve, b.resolve_planes, pending)
        return pack_frontier_words(pri.resolve > max_res, T) & pending

    def col_flags_bits(self, ctx, cand_words) -> torch.Tensor:
        """Active block-column flags straight from the words."""
        flags = (cand_words != 0).any(dim=1).to(torch.int32)
        if ctx.col_gate is not None:
            flags = flags * ctx.col_gate.to(flags.dtype)
        return flags

    def phase2_hits(self, ctx, cand_words, alive_words, col_flags) -> torch.Tensor:
        """② on words → (nbc, W) hit words."""
        raise NotImplementedError(f"{self.name} is a fused engine")

    def fused_step_bits(self, ctx, cand_words, alive_words, col_flags):
        """②+③ on words → (new_alive_words, mis_add_words)."""
        raise NotImplementedError(f"{self.name} is a split engine")

    def step_bits(self, ctx, pri, state: MISRoundState) -> MISRoundState:
        cand_w = self.phase1_candidates_bits(ctx, pri, state.alive)
        flags = self.col_flags_bits(ctx, cand_w)
        inc = round_increment(state)   # scalar: bitwise excludes member_rounds
        if self.fused:
            new_alive, mis_add = self.fused_step_bits(ctx, cand_w, state.alive, flags)
            return MISRoundState(
                alive=new_alive,
                in_mis=state.in_mis | mis_add,
                rnd=state.rnd + inc,
            )
        hit_w = self.phase2_hits(ctx, cand_w, state.alive, flags)
        return phase3_update_bits(state, cand_w, hit_w, inc)

    def _step_bits_with_stats(self, ctx, pri, state: MISRoundState):
        """`step_bits` plus the telemetry row; the counts are word
        popcounts, so the frontier never unpacks."""
        cand_w = self.phase1_candidates_bits(ctx, pri, state.alive)
        flags = self.col_flags_bits(ctx, cand_w)
        inc = round_increment(state)
        if self.fused:
            new_alive, mis_add = self.fused_step_bits(ctx, cand_w, state.alive, flags)
            new = MISRoundState(
                alive=new_alive,
                in_mis=state.in_mis | mis_add,
                rnd=state.rnd + inc,
            )
        else:
            hit_w = self.phase2_hits(ctx, cand_w, state.alive, flags)
            new = phase3_update_bits(state, cand_w, hit_w, inc)
        return new, _round_row(ctx, state, cand_w, new, flags)

    # -- hybrid round bodies -----------------------------------------------
    #
    # The dense half reuses the engine's own machinery on a sub-context
    # whose `tiled` is the compacted dense partition; the tail is segment
    # gather/scatter in global padded ids over its real entries (the
    # reference scatters its sentinel padding into a slot it drops).

    def _dense_phase2(self, dctx, cand, alive, col_flags) -> torch.Tensor:
        """Split ② over the dense partition, masked to covered rows
        (`dctx` is the dense sub-context)."""
        counts = self._dense_phase2_counts(dctx, cand, alive, col_flags)
        return torch.where(_covered_vertices(dctx.tiled), counts, 0.0)

    def _dense_phase2_counts(self, dctx, cand, alive, col_flags) -> torch.Tensor:
        """The hybrid split ②'s kernel seam: the fused engine overrides it
        to reach the split kernel."""
        return self.phase2_counts(dctx, cand, alive, col_flags)

    def _sparse_nbr_max(self, ctx, p, mask) -> torch.Tensor:
        """① over the tail: masked priorities gathered at the columns,
        max-reduced at the rows.  Empty segments read int32 min, below
        `_NEG`, so the max with the dense half is exact."""
        part = ctx.tiled.partition
        pm = torch.where(mask, p, _NEG)[part.tail_cols]
        return _segment_max(part.tail_rows, pm, ctx.tiled.n_padded)

    def _sparse_counts(self, ctx, cand) -> torch.Tensor:
        """② over the tail: candidate gather and sum at the rows, the
        slice of N_c the dense partition does not cover (0/1 sums in f32
        are exact in any order)."""
        part = ctx.tiled.partition
        out = torch.zeros(ctx.tiled.n_padded, dtype=torch.float32, device=cand.device)
        return out.index_add_(0, part.tail_rows, cand.to(torch.float32)[part.tail_cols])

    def _hybrid_nbr_max(self, ctx, dctx, p, mask) -> torch.Tensor:
        if ctx.cfg.phase1 != "tiled":
            # the segment phase ① covers the whole graph: nothing to merge
            return _segment_nbr_max(ctx, p, mask)
        dense_mx = torch.where(_covered_vertices(dctx.tiled),
                               self._tiled_nbr_max(dctx, p, mask), _NEG)
        return torch.maximum(dense_mx, self._sparse_nbr_max(ctx, p, mask))

    def _hybrid_candidates(self, ctx, dctx, pri, alive) -> torch.Tensor:
        max_np = self._hybrid_nbr_max(ctx, dctx, pri.select, alive)
        if pri.resolve is None:
            return alive & (pri.select > max_np)
        pending = alive & (pri.select >= max_np)
        max_res = self._hybrid_nbr_max(ctx, dctx, pri.resolve, pending)
        return pending & (pri.resolve > max_res)

    def _hybrid_round(self, ctx, pri, state: MISRoundState):
        """(new state, C, the dense partition's column flags, dense ctx)."""
        dctx = dataclasses.replace(ctx, tiled=ctx.tiled.partition.dense)
        cand = self._hybrid_candidates(ctx, dctx, pri, state.alive)
        flags = self.col_flags(dctx, cand)
        n_c = self._dense_phase2(dctx, cand, state.alive, flags)
        n_c = n_c + self._sparse_counts(ctx, cand)
        return phase3_update(state, cand, n_c, round_increment(state)), cand, flags, dctx

    def step_hybrid(self, ctx, pri, state: MISRoundState) -> MISRoundState:
        return self._hybrid_round(ctx, pri, state)[0]

    def _step_hybrid_with_stats(self, ctx, pri, state: MISRoundState):
        new, cand, flags, dctx = self._hybrid_round(ctx, pri, state)
        return new, _round_row(dctx, state, cand, new, flags,
                               ctx.tiled.partition.n_sparse_tiles)

    # -- hybrid, packed frontiers ------------------------------------------

    def _sparse_nbr_max_bits(self, ctx, p, mask_words) -> torch.Tensor:
        """① tail on packed frontiers: one bit gathered per nnz
        (`gather_frontier_bits`), then the masked segment max."""
        part = ctx.tiled.partition
        bit = gather_frontier_bits(mask_words, part.tail_bits)
        pm = torch.where(bit, p[part.tail_cols], _NEG)
        return _segment_max(part.tail_rows, pm, ctx.tiled.n_padded)

    def _sparse_hits_bits(self, ctx, cand_words) -> torch.Tensor:
        """② tail on packed frontiers: candidate bits gathered, any-hit at
        the rows, packed to (nbc, W) words for the `|` merge."""
        part = ctx.tiled.partition
        bit = gather_frontier_bits(cand_words, part.tail_bits).to(torch.int32)
        hit = _segment_max(part.tail_rows, bit, ctx.tiled.n_padded, fill=0)
        return pack_frontier_words(hit, ctx.tiled.tile_size)

    def _dense_hits_bits(self, dctx, cand_words, alive_words, flags) -> torch.Tensor:
        """② hit words over the dense partition, masked to covered rows."""
        hit_w = self.phase2_hits(dctx, cand_words, alive_words, flags)
        return torch.where(_covered_rows(dctx.tiled)[:, None], hit_w, 0)

    def _hybrid_nbr_max_bits(self, ctx, dctx, st, planes, p, mask_words) -> torch.Tensor:
        dense_mx = torch.where(_covered_vertices(dctx.tiled),
                               self._nbr_max_bits(dctx, st, planes, mask_words), _NEG)
        return torch.maximum(dense_mx, self._sparse_nbr_max_bits(ctx, p, mask_words))

    def _hybrid_candidates_bits(self, ctx, dctx, pri, alive_words) -> torch.Tensor:
        """`phase1_candidates_bits` with the merged Max_Np; `ctx.bits` was
        built over the dense partition (`core.tc_mis._setup`)."""
        T = ctx.tiled.tile_size
        b = ctx.bits
        if ctx.cfg.phase1 != "tiled":
            max_np = _segment_nbr_max_bits_oracle(ctx, pri.select, alive_words)
        else:
            max_np = self._hybrid_nbr_max_bits(ctx, dctx, b.select, b.select_planes,
                                               pri.select, alive_words)
        if pri.resolve is None:
            return pack_frontier_words(pri.select > max_np, T) & alive_words
        pending = pack_frontier_words(pri.select >= max_np, T) & alive_words
        if ctx.cfg.phase1 != "tiled":
            max_res = _segment_nbr_max_bits_oracle(ctx, pri.resolve, pending)
        else:
            max_res = self._hybrid_nbr_max_bits(ctx, dctx, b.resolve, b.resolve_planes,
                                                pri.resolve, pending)
        return pack_frontier_words(pri.resolve > max_res, T) & pending

    def _hybrid_round_bits(self, ctx, pri, state: MISRoundState):
        dctx = dataclasses.replace(ctx, tiled=ctx.tiled.partition.dense)
        cand_w = self._hybrid_candidates_bits(ctx, dctx, pri, state.alive)
        flags = self.col_flags_bits(ctx, cand_w)
        hit_w = self._dense_hits_bits(dctx, cand_w, state.alive, flags)
        hit_w = hit_w | self._sparse_hits_bits(ctx, cand_w)
        return phase3_update_bits(state, cand_w, hit_w, round_increment(state)), cand_w, flags, dctx

    def step_bits_hybrid(self, ctx, pri, state: MISRoundState) -> MISRoundState:
        return self._hybrid_round_bits(ctx, pri, state)[0]

    def _step_bits_hybrid_with_stats(self, ctx, pri, state: MISRoundState):
        new, cand_w, flags, dctx = self._hybrid_round_bits(ctx, pri, state)
        return new, _round_row(dctx, state, cand_w, new, flags,
                               ctx.tiled.partition.n_sparse_tiles)


class TorchTiledRefEngine(TorchTiledEngine):
    """Plain torch on the BSR schedule — what the kernels are held against."""

    name = "tiled_ref"

    def phase2_counts(self, ctx, cand, alive, col_flags=None):
        t = ctx.tiled
        out = tile_spmv(
            t.tiles, t.tile_rows, t.tile_cols,
            self._pack_rhs(ctx, cand, alive),
            t.n_block_rows, t.tile_size, col_flags=col_flags,
        )
        return out[:, 0]

    def phase2_hits(self, ctx, cand_words, alive_words, col_flags):
        t = ctx.tiled
        return tile_spmv_bits(
            ctx.bits.tiles_bits, t.tile_rows, t.tile_cols, cand_words,
            t.n_block_rows, t.tile_size, col_flags=col_flags,
        )


class HopperSpmvEngine(TorchTiledEngine):
    """Phase ② on the Hopper split SpMV kernels, phase ① (`phase1="tiled"`)
    on the Hopper neighbour-max kernels (counterpart of the reference's
    `tiled_pallas`)."""

    name = "tiled_pallas"
    plane_kernel_nbr_max = True

    def _tiled_nbr_max(self, ctx, p, mask):
        from repro_torch.hopper.tc_neighbor_max import tc_neighbor_max

        return tc_neighbor_max(ctx.tiled, p, mask)

    def _nbr_max_bits(self, ctx, st, planes, mask_words):
        if planes is None:
            raise ValueError(
                f"{self.name} runs the plane-scan kernel and needs the priority "
                "planes: build the BitwiseContext with planes=True"
            )
        from repro_torch.hopper.tc_neighbor_max import tc_neighbor_max_bits

        return tc_neighbor_max_bits(
            ctx.tiled, planes, mask_words, tiles_words=ctx.bits.tiles_bits,
            signed=planes.shape[0] == RESOLVE_PLANE_BITS,
        )

    def phase2_hits(self, ctx, cand_words, alive_words, col_flags):
        from repro_torch.hopper.tc_spmv import tc_spmv_bits

        return tc_spmv_bits(
            ctx.tiled, cand_words, tiles_words=ctx.bits.tiles_bits,
            col_flags=col_flags, skip_dma=ctx.cfg.skip_dma,
        )

    def phase2_counts(self, ctx, cand, alive, col_flags=None):
        from repro_torch.hopper.tc_spmv import tc_spmv

        out = tc_spmv(
            ctx.tiled, self._pack_rhs(ctx, cand, alive),
            col_flags=col_flags, skip_dma=ctx.cfg.skip_dma,
        )
        return out[:, 0]


class HopperFusedEngine(HopperSpmvEngine):
    """The default path: phases ②+③ in one Hopper kernel pass — the state
    update runs in the SpMV epilogue (counterpart of `fused_pallas`)."""

    name = "fused_pallas"
    fused = True

    def phase2_counts(self, ctx, cand, alive, col_flags=None):
        raise NotImplementedError("fused_pallas runs ②+③ as one fused_step")

    def _dense_phase2_counts(self, dctx, cand, alive, col_flags):
        # under a partition ② runs split (the in-kernel ③ cannot merge the
        # tail's hits): the parent's split kernel, past the raise above;
        # the packed twin `phase2_hits` is inherited as it is
        return super().phase2_counts(dctx, cand, alive, col_flags)

    def fused_step(self, ctx, cand, alive, col_flags=None):
        from repro_torch.hopper.tc_spmv import tc_spmv_fused

        _, new_alive, mis_add = tc_spmv_fused(
            ctx.tiled, self._pack_rhs(ctx, cand, alive), cand, alive,
            col_flags=col_flags, skip_dma=ctx.cfg.skip_dma,
        )
        return new_alive, mis_add

    def fused_step_bits(self, ctx, cand_words, alive_words, col_flags):
        from repro_torch.hopper.tc_spmv import tc_spmv_fused_bits

        _, new_alive, mis_add = tc_spmv_fused_bits(
            ctx.tiled, cand_words, alive_words, tiles_words=ctx.bits.tiles_bits,
            col_flags=col_flags, skip_dma=ctx.cfg.skip_dma,
        )
        return new_alive, mis_add


register_engine(TorchSegmentEngine())
register_engine(TorchTiledRefEngine())
register_engine(HopperSpmvEngine())
register_engine(HopperFusedEngine())
