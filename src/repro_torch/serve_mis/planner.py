"""Tile-plan caching, absorbed into `repro_torch.api.plan` (counterpart of
`repro.serve_mis.planner`): the reference's compatibility re-exports, so
`TilePlan` and `PlanCache` import from here in both packages.  `TilePlan`
is `repro_torch.api.plan.Plan`."""
from repro_torch.api.plan import (  # noqa: F401 — compatibility re-exports
    Plan,
    PlanCache,
    TilePlan,
    build_plan,
    delta_cache_key,
    graph_content_key,
    patch_plan,
    plan_cache_key,
    resolve_storage,
)

__all__ = [
    "Plan", "PlanCache", "TilePlan", "build_plan", "delta_cache_key",
    "graph_content_key", "patch_plan", "plan_cache_key", "resolve_storage",
]
