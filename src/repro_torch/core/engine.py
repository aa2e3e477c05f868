"""The round-engine layer (counterpart of `repro.core.engine`, dense
frontier only).

Every execution path is an engine that runs one MIS round; `core.tc_mis`
owns only the convergence loop.  Registered engines, under
the reference's names:

  segment       gather/segment ops over the edge list (ECL-MIS analogue).
  tiled_ref     plain-torch BSR tile schedule — what the kernels are held
                against.
  tiled_pallas  phase ② on the Hopper split SpMV kernel
                (`hopper.tc_spmv.tc_spmv`).
  fused_pallas  phases ②+③ in one Hopper kernel pass
                (`hopper.tc_spmv.tc_spmv_fused`); the default engine.

The two Hopper engines keep the reference's names so `SolveOptions` reads
the same in both packages; on CPU tensors their wrappers run the plain
versions (only the CPU tests ask for that).

Every engine here declares `supports_bitwise = False` and
`supports_hybrid = False`, so the reference's own rules resolve
`frontier` to "dense" (`resolve_frontier`) and the Solver plans
`hybrid="off"` for them.  Phase ① with `phase1="tiled"` runs in plain
torch on `tiled_ref`; the Hopper engines raise until `_nbr_max_kernel` is
ported (ROADMAP.md, Queue 2 item 3).

Per-round metadata: tiled engines gate block-columns with no candidate off
(`block_col_flags`, ANDed with the static `col_gate`); a gated column
contributes nothing on any lane, in the kernels and in `tile_spmv` alike.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.spmv import INT32_MIN, _NEG
from repro_torch.core.tiling import BlockTiledGraph, dense_tile_mask, pack_vertex_vector
from repro_torch.graphs.graph import Graph


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
    cols = tile_cols.long()
    gathered = rhs.reshape(-1, T, L)[cols].to(torch.float32)  # (nt, T, L)
    if col_flags is not None:
        gathered = gathered * col_flags[cols][:, None, None].to(torch.float32)
    prod = torch.bmm(mask, gathered)
    out = torch.zeros((n_block_rows, T, L), dtype=torch.float32, device=rhs.device)
    out.index_add_(0, tile_rows.long(), prod)
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
    index = tile_rows.long()[:, None].expand(-1, T)
    out.scatter_reduce_(0, index, tile_max, "amax")
    return out.reshape(n_block_rows * T)


def block_col_flags(x: torch.Tensor, tile_size: int) -> torch.Tensor:
    """(nbc*T,) vector -> (nbc,) int32 0/1: is any vertex of the column set?"""
    return x.reshape(-1, tile_size).to(torch.bool).any(dim=1).to(torch.int32)


# --------------------------------------------------------------------------
# state + context
# --------------------------------------------------------------------------

def resolve_frontier(config, engine, *, storage: str, member_rounds: bool = False) -> str:
    """Resolve `SolveOptions.frontier` to the concrete mode a run uses —
    the reference's rule verbatim.  No engine of this package supports the
    packed-word frontier yet, so every run resolves to "dense"."""
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
    """Per-round state; `alive`/`in_mis` are (n_padded,) bool.  `rnd` is a
    0-dim int32 round counter, or an (n_padded,) int32 per-vertex counter
    that advances only while its vertex is alive (`member_rounds`)."""
    alive: torch.Tensor
    in_mis: torch.Tensor
    rnd: torch.Tensor


@dataclasses.dataclass(frozen=True)
class EngineContext:
    """What an engine closes over for one run: the graph in both
    representations, the options, the static (n_block_cols,) 0/1 column
    gate (None = every column may carry candidates) and the resolved
    frontier mode."""
    g: Graph
    tiled: BlockTiledGraph
    cfg: Any   # anything with engine/heuristic/lanes/phase1/skip_dma/max_rounds
    col_gate: Optional[torch.Tensor] = None
    frontier: str = "dense"


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


# --------------------------------------------------------------------------
# the engine interface
# --------------------------------------------------------------------------

class TorchRoundEngine:
    """One MIS round as pluggable pieces: `_nbr_max` (phase ①), and
    `phase2_counts` (split engines) or `fused_step` (fused engines).
    `step` is the one round body every loop uses."""

    name: str = "abstract"
    fused: bool = False
    supports_bitwise: bool = False
    supports_hybrid: bool = False

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

    def step(self, ctx: EngineContext, pri, state: MISRoundState) -> MISRoundState:
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
    the segment max or the tiled max."""

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


class HopperSpmvEngine(TorchTiledEngine):
    """Phase ② on the Hopper split SpMV kernel (counterpart of the
    reference's `tiled_pallas`)."""

    name = "tiled_pallas"

    def _tiled_nbr_max(self, ctx, p, mask):
        raise NotImplementedError(
            f"{self.name}: phase1='tiled' needs the Hopper port of "
            "_nbr_max_kernel (ROADMAP.md, Queue 2 item 3); use "
            "phase1='segment', or engine='tiled_ref' for the plain-torch "
            "tiled phase ①"
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

    def fused_step(self, ctx, cand, alive, col_flags=None):
        from repro_torch.hopper.tc_spmv import tc_spmv_fused

        _, new_alive, mis_add = tc_spmv_fused(
            ctx.tiled, self._pack_rhs(ctx, cand, alive), cand, alive,
            col_flags=col_flags, skip_dma=ctx.cfg.skip_dma,
        )
        return new_alive, mis_add


register_engine(TorchSegmentEngine())
register_engine(TorchTiledRefEngine())
register_engine(HopperSpmvEngine())
register_engine(HopperFusedEngine())
