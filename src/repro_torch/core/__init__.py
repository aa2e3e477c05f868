from repro_torch.core.engine import ENGINES, engine_names, get_engine
from repro_torch.core.heuristics import Priorities, make_priorities
from repro_torch.core.luby import MISResult
from repro_torch.core.tc_mis import run_tc_mis
from repro_torch.core.tiling import BlockTiledGraph, build_block_tiles
from repro_torch.core.validate import cardinality, is_independent, is_maximal, is_valid_mis

__all__ = [
    "ENGINES", "engine_names", "get_engine", "Priorities", "make_priorities",
    "MISResult", "run_tc_mis", "BlockTiledGraph", "build_block_tiles",
    "cardinality", "is_independent", "is_maximal", "is_valid_mis",
]
