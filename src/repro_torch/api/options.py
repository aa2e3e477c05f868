"""`SolveOptions` — every knob of a MIS solve (counterpart of
`repro.api.options`, same fields, defaults and validation).

`hybrid` plans the tile partition as the reference plans it (the tile
engines route by it, `segment` plans it "off"), at a threshold from the
port's H100 cost model unless `hybrid_threshold` names one; `frontier`
resolves as the reference resolves it (the packed words for a tile engine
with `phase1="tiled"` on bitpack storage).  `repair` and
`repair_threshold` pick `Solver.update`'s mode; `cache_dir` gives the
Solver's plan cache its disk layer.  `placement`, `shard_threshold` and
`bitpack` steer the sharded route (`core.distributed` over
`torch.distributed`) as the reference's steer its shard_map route.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

PLACEMENTS = ("auto", "local", "sharded")
STORAGES = ("auto", "int8", "bitpack")
REPAIRS = ("auto", "cold", "incremental")
FRONTIERS = ("auto", "dense", "bitwise")
HYBRIDS = ("auto", "off", "forced")


@dataclasses.dataclass(frozen=True)
class SolveOptions:
    """How to solve: algorithm, engine, preprocessing, and placement.

    Algorithm / engine:
      heuristic:  h1 | h2 | h3 | ecl
      engine:     segment | tiled_ref | tiled_pallas | fused_pallas
                  (`repro_torch.core.engine` registry; the last two run the
                  Hopper kernels)
      phase1:     segment (paper-faithful) | tiled (beyond-paper)
      lanes:      RHS lane count (≥ 2: lane 0 = candidates, lane 1 = alive)
      skip_dma:   accepted for parity; the Hopper kernels never load a
                  gated slab, so it changes nothing
      max_rounds: convergence-loop bound
      frontier:   auto | dense | bitwise (`core.engine.resolve_frontier`)

    Preprocessing (the `Plan` build policy):
      tile_size:  BSR tile edge T, power of two ≥ 8; None = auto-T
                  (`repro_torch.api.plan.choose_tile_size`)
      reorder:    None | 'rcm'
      storage:    'int8' | 'bitpack' | 'auto' (bitpack once the worst-case
                  int8 payload reaches `BITPACK_AUTO_THRESHOLD` bytes)
      hybrid:     auto | off | forced, the tile-partition policy
                  (`core.tiling.attach_partition`)
      hybrid_threshold: nnz cut for the hybrid classifier; None = the
                  cost model's break-even (`repro_torch.perf`)

    Placement: placement (auto | local | sharded; auto picks sharded when
    the padded vertex count reaches shard_threshold and the default
    `torch.distributed` group has more than one rank), bitpack (the
    sharded route gathers its frontiers as packed words, else as bytes).
    Dynamic graphs (`Solver.update`): repair (auto | incremental | cold),
    repair_threshold (auto's largest touched-vertex share for
    incremental).  Observability: telemetry
    (a per-round `obs.RoundTrace` in `SolveResult.telemetry`).
    Reproducibility / caching: seed (`core.prng.key(seed)`, the reference's
    `jax.random.key(seed)`: the key of `Solver.solve`, from which batched
    members' `request_key`s fold), cache_dir
    (the plan cache's `.npz` directory), plan_cache_entries.
    """

    heuristic: str = "h3"
    engine: str = "fused_pallas"
    phase1: str = "segment"
    lanes: int = 8
    skip_dma: bool = False
    max_rounds: int = 1024
    frontier: str = "auto"

    tile_size: Optional[int] = None
    reorder: Optional[str] = None
    storage: str = "auto"
    hybrid: str = "auto"
    hybrid_threshold: Optional[int] = None

    placement: str = "auto"
    shard_threshold: int = 1 << 15
    bitpack: bool = True

    repair: str = "auto"
    repair_threshold: float = 0.25

    telemetry: bool = False

    seed: int = 0
    cache_dir: Optional[str] = None
    plan_cache_entries: int = 256

    def __post_init__(self):
        if self.placement not in PLACEMENTS:
            raise ValueError(
                f"unknown placement {self.placement!r}; options {PLACEMENTS}"
            )
        if self.storage not in STORAGES:
            raise ValueError(
                f"unknown storage {self.storage!r}; valid: {STORAGES}"
            )
        if self.repair not in REPAIRS:
            raise ValueError(
                f"unknown repair {self.repair!r}; valid: {REPAIRS}"
            )
        if self.frontier not in FRONTIERS:
            raise ValueError(
                f"unknown frontier {self.frontier!r}; valid: {FRONTIERS}"
            )
        if self.hybrid not in HYBRIDS:
            raise ValueError(
                f"unknown hybrid {self.hybrid!r}; valid: {HYBRIDS}"
            )
        if self.hybrid_threshold is not None and self.hybrid_threshold < 1:
            raise ValueError(
                f"hybrid_threshold must be >= 1, got {self.hybrid_threshold}"
            )

    @property
    def backend(self) -> str:
        """The reference's engine-layer spelling of `engine`."""
        return self.engine
