"""repro_torch.serve_mis — the serving layer's ported parts (counterpart of
`repro.serve_mis`):

  io        file ingestion (SNAP edge lists, MatrixMarket, DIMACS)
  planner   the plan cache's compatibility re-exports (`TilePlan`)
  batcher   block-diagonal multi-graph packing into shape buckets

The request queue and its CLI (`service`, `__main__`) are not ported yet
(ROADMAP.md, Queue 1 item 13); `repro_torch.api.Solver.solve_many` is the
batched entry point.
"""
from repro_torch.serve_mis.io import GraphParseError, detect_format, load_graph
from repro_torch.serve_mis.planner import PlanCache, TilePlan, build_plan, plan_cache_key
from repro_torch.serve_mis.batcher import (
    Bucket,
    PackedBatch,
    bucket_for,
    member_priorities,
    pack_batch,
    request_generator,
)

__all__ = [
    "GraphParseError", "detect_format", "load_graph",
    "PlanCache", "TilePlan", "build_plan", "plan_cache_key",
    "Bucket", "PackedBatch", "bucket_for", "member_priorities", "pack_batch",
    "request_generator",
]
