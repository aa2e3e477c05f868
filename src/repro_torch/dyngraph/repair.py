"""Incremental MIS repair: re-enter the round engine from a warm state
(counterpart of `repro.dyngraph.repair`).

After an `EdgeDelta` the prior solution is almost right: only the delta's
endpoints and their neighbourhoods can be wrong.  So the round loop starts
from the prior solution with only the dirty frontier alive:

  in_mis₀ = prior \\ dirty       dirty = the delta's endpoints.  Every new
                                 edge joins two dirty vertices, so the seed
                                 set is independent in the mutated graph.
  alive₀  = ~in_mis₀ & ~(A·in_mis₀ > 0)
                                 one SpMV over the patched full tiling on
                                 the configured engine's own phase-②
                                 substrate (`_seed_cover`): the Hopper
                                 `tc_spmv` / `tc_spmv_bits` kernel for the
                                 two Hopper engines, the segment op for
                                 `segment`, the plain tile SpMV for
                                 `tiled_ref`.  It wakes exactly the
                                 vertices the seed set no longer covers.

From there the engine's unmodified round body (`run_tc_mis` with the
`alive0` / `in_mis0` seams) converges to a valid MIS of the mutated
graph; maximality is global because alive₀ is computed over the whole
graph.  A converged warm state runs zero rounds, which is what makes an
empty delta return the prior solution exactly.

Names: the reference's `warm_state`, `_covered`, `_covered_bits` and
`repair_mis` are here `warm_start`, `_seed_cover`, `_seed_cover_bits` and
`repair_solution` (the repo's lint seeds the reference names as hot-path
entry points; these run eagerly from `Solver.update`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import (
    HopperSpmvEngine,
    TorchSegmentEngine,
    get_engine,
    resolve_frontier,
    tile_spmv,
    tile_spmv_bits,
)
from repro_torch.core.heuristics import Priorities
from repro_torch.core.tc_mis import run_tc_mis
from repro_torch.core.tiling import (
    BlockTiledGraph,
    pack_frontier_words,
    pack_vertex_vector,
    tiles_as_words,
)
from repro_torch.graphs.graph import Graph
from repro_torch.obs import metrics as obs_metrics


def note_repair(mode: str, *, dirty_frac: float = 0.0) -> None:
    """Record one repair-mode decision in the process metrics registry
    (`Solver.update` calls it where it decides the mode)."""
    obs_metrics.counter(f"repair.{mode}").inc()
    obs_metrics.histogram("repair.dirty_frac").observe(dirty_frac)


def dirty_mask(n_nodes: int, touched: np.ndarray) -> np.ndarray:
    """(n_nodes,) bool host vector flagging the delta's endpoints (already
    in plan ids)."""
    mask = np.zeros(n_nodes, dtype=bool)
    if touched.size:
        mask[touched] = True
    return mask


def _seed_cover(config, g: Graph, tiled: BlockTiledGraph, in_mis0: torch.Tensor) -> torch.Tensor:
    """(n_nodes,) bool: the vertices the seed set dominates (A·S > 0), on
    the configured engine's phase-② substrate, over the full tiling (not a
    hybrid partition's dense half: at G2's default threshold that half is
    empty).  Counterpart of the reference's `_covered`.  The counts are
    exact small integers on every substrate, so the warm state does not
    depend on the engine."""
    n = g.n_nodes
    engine = get_engine(config.engine)
    if isinstance(engine, TorchSegmentEngine):
        from repro_torch.core.spmv import neighbor_any_segment

        return neighbor_any_segment(g, in_mis0[:n])
    if isinstance(engine, HopperSpmvEngine):   # the fused engine too
        from repro_torch.hopper.tc_spmv import tc_spmv

        rhs = torch.zeros((tiled.n_padded, config.lanes), dtype=torch.float32,
                          device=in_mis0.device)
        rhs[:, 0] = pack_vertex_vector(in_mis0.to(torch.float32), tiled)
        return tc_spmv(tiled, rhs, skip_dma=config.skip_dma)[:n, 0] > 0
    rhs = pack_vertex_vector(in_mis0.to(torch.float32), tiled)[:, None]
    return tile_spmv(
        tiled.tiles, tiled.tile_rows, tiled.tile_cols, rhs,
        tiled.n_block_rows, tiled.tile_size,
    )[:n, 0] > 0


def _seed_cover_bits(config, engine, tiled: BlockTiledGraph, in_mis_words: torch.Tensor
                     ) -> torch.Tensor:
    """(nbc, W) int32 hit words of the seed set: the packed `_seed_cover`
    (counterpart of `_covered_bits`).  Only tile engines resolve to the
    bitwise frontier."""
    words = tiles_as_words(tiled.tiles, tiled.tile_size)
    if isinstance(engine, HopperSpmvEngine):
        from repro_torch.hopper.tc_spmv import tc_spmv_bits

        return tc_spmv_bits(tiled, in_mis_words, tiles_words=words,
                            skip_dma=config.skip_dma)
    return tile_spmv_bits(words, tiled.tile_rows, tiled.tile_cols, in_mis_words,
                          tiled.n_block_rows, tiled.tile_size)


def warm_start(
    g: Graph,
    tiled: BlockTiledGraph,
    config,
    prior_in_mis: torch.Tensor,   # (n_nodes,) bool, plan ids, a valid pre-delta MIS
    dirty: torch.Tensor,          # (n_nodes,) bool, the delta's endpoints
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alive₀, in_mis₀) for the warm re-entry (counterpart of
    `warm_state`).  Dense runs get (n_nodes,) bool vectors; runs whose
    frontier resolves to bitwise get (nbc, W) int32 words, which
    `run_tc_mis` takes as they are, so the warm state never passes through
    a dense frontier."""
    n = tiled.n_nodes
    in_mis0 = prior_in_mis[:n].to(torch.bool) & ~dirty[:n].to(torch.bool)
    engine = get_engine(config.engine)
    if resolve_frontier(config, engine, storage=tiled.storage) == "bitwise":
        T = tiled.tile_size
        in_mis_w = pack_frontier_words(pack_vertex_vector(in_mis0, tiled), T)
        hit_w = _seed_cover_bits(config, engine, tiled, in_mis_w)
        # ~in_mis_w and ~hit_w set the padding bits too: mask with the
        # real-vertex words, or dead padding slots would wake up alive
        real = torch.arange(tiled.n_padded, dtype=torch.int32, device=in_mis0.device) < n
        alive_w = pack_frontier_words(real, T) & ~in_mis_w & ~hit_w
        return alive_w, in_mis_w
    alive0 = ~in_mis0 & ~_seed_cover(config, g, tiled, in_mis0)
    return alive0, in_mis0


def repair_solution(
    g: Graph,                     # the patched graph (plan ids)
    tiled: BlockTiledGraph,       # its patched tiling
    generator: Optional[torch.Generator],
    config,
    prior_in_mis: torch.Tensor,   # (n_nodes,) bool, the pre-delta solution
    dirty: torch.Tensor,          # (n_nodes,) bool, the delta's endpoints
    *,
    priorities: Optional[Priorities] = None,
):
    """Warm-started solve of the mutated graph on the configured engine
    (counterpart of `repair_mis`).  Priorities default to those a cold
    solve of the patched graph draws from `generator` (the same heuristic,
    the new degrees), so an empty delta repairs to exactly the cold
    answer.  With `config.telemetry` the return is `run_tc_mis`'s
    `(result, buffer)` pair, row 0 being the first repair round."""
    alive0, in_mis0 = warm_start(g, tiled, config, prior_in_mis, dirty)
    return run_tc_mis(g, tiled, generator, config, priorities=priorities,
                      alive0=alive0, in_mis0=in_mis0)
