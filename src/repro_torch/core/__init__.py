from repro_torch.core.distributed import (
    DistConfig,
    DistMISResult,
    ShardedTiledGraph,
    build_distributed_mis,
    shard_tiled,
)
from repro_torch.core.ecl_mis import ecl_mis, ecl_rounds
from repro_torch.core.engine import ENGINES, engine_names, get_engine
from repro_torch.core.heuristics import Priorities, make_priorities
from repro_torch.core.luby import MISResult, luby_mis, luby_round
from repro_torch.core.tc_mis import run_tc_mis
from repro_torch.core.tiling import BlockTiledGraph, build_block_tiles
from repro_torch.core.validate import cardinality, is_independent, is_maximal, is_valid_mis

__all__ = [
    "ENGINES", "engine_names", "get_engine", "Priorities", "make_priorities",
    "MISResult", "luby_mis", "luby_round", "ecl_mis", "ecl_rounds", "run_tc_mis",
    "BlockTiledGraph", "build_block_tiles",
    "DistConfig", "DistMISResult", "ShardedTiledGraph", "build_distributed_mis", "shard_tiled",
    "cardinality", "is_independent", "is_maximal", "is_valid_mis",
]
