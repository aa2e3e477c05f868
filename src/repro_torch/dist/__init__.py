"""The distribution layer on `torch.distributed` (counterpart of
`repro.dist`): partition-spec policies and their DTensor placements
(`sharding`), the collectives of the data-, tensor- and expert-parallel
steps (`collectives`) and elastic restore (`elastic`)."""
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

__all__ = [
    "MeshShape", "P", "Sharding", "batch_spec", "cache_specs", "data_axes",
    "deepfm_specs", "distribute", "lm_param_specs", "placements", "shardings",
    "reshard_checkpoint",
]
