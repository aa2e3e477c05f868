"""repro_torch.api — the public front door: `Plan` / `SolveOptions` /
`Solver` (counterpart of `repro.api`; the local, batched and dynamic
routes)."""
from repro_torch.api.options import REPAIRS, STORAGES, SolveOptions
from repro_torch.api.plan import (
    BITPACK_AUTO_THRESHOLD,
    DEFAULT_TILE_BUDGET,
    Plan,
    PlanCache,
    build_plan,
    choose_tile_size,
    delta_cache_key,
    fit_tile_size,
    graph_content_key,
    patch_plan,
    plan_cache_key,
    plan_from_arrays,
    resolve_storage,
    worst_case_tile_bytes,
)
from repro_torch.api.solver import SolveResult, Solver

__all__ = [
    "SolveOptions", "STORAGES", "REPAIRS", "BITPACK_AUTO_THRESHOLD",
    "DEFAULT_TILE_BUDGET", "Plan", "PlanCache", "build_plan", "choose_tile_size",
    "delta_cache_key", "fit_tile_size", "graph_content_key", "patch_plan",
    "plan_cache_key", "plan_from_arrays", "resolve_storage", "worst_case_tile_bytes",
    "Solver", "SolveResult",
]
