"""The training substrate (counterpart of `repro.train`): AdamW, the
fault-tolerant loop, checkpoints and gradient compression, over trees of
tensors (`train.tree`); over placed trees (DTensor leaves), ZeRO-1's
`zero1_specs` and `adamw_init_placed` / `adamw_update_placed`."""
from repro_torch.train.optimizer import (
    AdamWState,
    OptConfig,
    adamw_init,
    adamw_init_placed,
    adamw_update,
    adamw_update_placed,
    global_norm,
    schedule,
    zero1_specs,
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
    "AdamWState", "OptConfig", "adamw_init", "adamw_init_placed", "adamw_update",
    "adamw_update_placed", "global_norm", "schedule", "zero1_specs", "LoopConfig", "TrainLoop", "checkpoint",
    "compress_tree", "decompress_tree", "compress_with_error_feedback", "ef_init",
]
