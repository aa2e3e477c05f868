"""repro_torch.dyngraph — dynamic graphs: streaming ingestion, deltas,
tile-local retiling, MIS repair, drift gauges (counterpart of
`repro.dyngraph`):

  stream    chunked edge readers over SNAP / .mtx / DIMACS (`iter_edges`,
            `load_graph_stream`) and the `+/- u v` delta file format
  delta     `EdgeDelta`: canonical, content-hashed add / remove batches
            with a true `inverse()`
  retile    `apply_delta` / `apply_graph_delta`: tile-local edits on the
            device (word edits on packed tiles, byte edits on int8), equal
            to a rebuild of the mutated graph
  repair    the warm-started round loop: seed the prior solution, wake
            only the dirty frontier
  drift     per-epoch churn gauges (touched tiles, dirty share, tile
            locality against the epoch-0 build)

Front door: `Plan.apply_delta`, `PlanCache.apply_delta`,
`SolveOptions.repair`, `Solver.update`.
"""
from repro_torch.dyngraph.delta import EdgeDelta, random_delta
from repro_torch.dyngraph.drift import (
    dirty_vertex_frac,
    note_drift,
    tile_occupancy,
    touched_tile_count,
)
from repro_torch.dyngraph.repair import dirty_mask, repair_solution, warm_start
from repro_torch.dyngraph.retile import apply_delta, apply_graph_delta
from repro_torch.dyngraph.stream import (
    iter_edges,
    load_delta,
    load_graph_stream,
    parse_delta,
)

__all__ = [
    "EdgeDelta", "random_delta",
    "apply_delta", "apply_graph_delta",
    "dirty_mask", "repair_solution", "warm_start",
    "dirty_vertex_frac", "note_drift", "tile_occupancy", "touched_tile_count",
    "iter_edges", "load_delta", "load_graph_stream", "parse_delta",
]
