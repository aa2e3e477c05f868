"""repro_torch.serve_mis — the serving layer over the round engines
(counterpart of `repro.serve_mis`):

  io        file ingestion (SNAP edge lists, MatrixMarket, DIMACS)
  planner   the plan cache's compatibility re-exports (`TilePlan`)
  batcher   block-diagonal multi-graph packing into shape buckets
  service   request queue → one `repro_torch.api.Solver.solve_many` call
            per worker step → validated per-graph responses with serving
            stats; `submit_update` patches a served graph with an
            `EdgeDelta` and repairs its solution

CLI: ``python -m repro_torch.serve_mis --once graph1.mtx graph2.edges``
     (``update <id> <delta_file>`` lines / ``--update ID:FILE`` mutate
     served graphs; ``--stream-ingest`` uses the chunked readers;
     ``--device cpu`` runs on the CPU)
"""
from repro_torch.serve_mis.io import GraphParseError, detect_format, load_graph
from repro_torch.serve_mis.planner import PlanCache, TilePlan, build_plan, plan_cache_key
from repro_torch.serve_mis.batcher import (
    Bucket,
    PackedBatch,
    bucket_for,
    member_priorities,
    pack_batch,
    request_key,
)
from repro_torch.serve_mis.service import (
    MISService,
    Request,
    Response,
    ServeConfig,
    UpdateRequest,
)

__all__ = [
    "GraphParseError", "detect_format", "load_graph",
    "PlanCache", "TilePlan", "build_plan", "plan_cache_key",
    "Bucket", "PackedBatch", "bucket_for", "member_priorities", "pack_batch",
    "request_key",
    "MISService", "Request", "Response", "ServeConfig", "UpdateRequest",
]
