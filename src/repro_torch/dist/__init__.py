"""The distribution layer on `torch.distributed` (counterpart of
`repro.dist`): partition-spec policies and their DTensor placements
(`sharding`), the collectives of the data-, tensor- and expert-parallel
steps (`collectives`), elastic restore (`elastic`), a full graph's
vertices and edges split over a mesh's ranks (`graph`) and tables split by
rows over them, with an exact row lookup (`lookup`)."""
from repro_torch.dist.sharding import (
    MeshShape,
    P,
    Sharding,
    batch_spec,
    cache_specs,
    data_axes,
    deepfm_specs,
    distribute,
    lm_param_specs,
    placements,
    shardings,
)
from repro_torch.dist.elastic import reshard_checkpoint
from repro_torch.dist.graph import GraphSplit, split_graph
from repro_torch.dist.lookup import TableSplit

__all__ = [
    "MeshShape", "P", "Sharding", "batch_spec", "cache_specs", "data_axes",
    "deepfm_specs", "distribute", "lm_param_specs", "placements", "shardings",
    "reshard_checkpoint", "GraphSplit", "split_graph", "TableSplit",
]
