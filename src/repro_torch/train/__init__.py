"""The training substrate (counterpart of `repro.train`): AdamW, the
fault-tolerant loop, checkpoints and gradient compression, over trees of
tensors (`train.tree`).  `zero1_specs` waits for the distributed port."""
from repro_torch.train.optimizer import (
    AdamWState,
    OptConfig,
    adamw_init,
    adamw_update,
    global_norm,
    schedule,
)
from repro_torch.train.train_loop import LoopConfig, TrainLoop
from repro_torch.train import checkpoint
from repro_torch.train.compression import (
    compress_tree,
    decompress_tree,
    compress_with_error_feedback,
    ef_init,
)

__all__ = [
    "AdamWState", "OptConfig", "adamw_init", "adamw_update", "global_norm",
    "schedule", "LoopConfig", "TrainLoop", "checkpoint",
    "compress_tree", "decompress_tree", "compress_with_error_feedback", "ef_init",
]
