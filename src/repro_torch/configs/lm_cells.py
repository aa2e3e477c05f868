"""The LM family's cells (counterpart of the LM part of
`repro.configs.common`): the assigned shapes, the analytic FLOP counts,
and the two serve steps the reference's prefill and decode cells lower.

Left out, as `gnn_cells` leaves them out: the `Cell` / `ArchDef` registry
and the mesh, sharding and dry-run machinery (`_dryrun_cfg`,
`_with_stack_layers`, `_needs_fsdp`, the cost passes' unrolled
variants).  The train cell's step (`make_lm_train_step`) waits for the
LM's training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.lm_config import LMConfig

LM_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def lm_train_flops(cfg: LMConfig, batch: int, seq: int) -> float:
    """MODEL_FLOPS = 6·N_active·D tokens (fwd 2ND + bwd 4ND)."""
    return 6.0 * cfg.active_param_count() * batch * seq


def lm_decode_flops(cfg: LMConfig, batch: int, cache: int) -> float:
    """Per decode step: 2·N_active per token + attention reads over cache."""
    n = cfg.active_param_count()
    if cfg.mla is not None:
        attn = cfg.n_layers * cfg.n_heads * cache * 2 * (
            cfg.mla.kv_lora_rank + cfg.mla.d_rope + cfg.mla.kv_lora_rank
        )
    else:
        attn = cfg.n_layers * cfg.n_heads * cache * 2 * 2 * cfg.d_head
    return batch * (2.0 * n + attn)


def prefill_step(params, cfg: LMConfig, tokens: torch.Tensor,
                 max_len: Optional[int] = None):
    """The prefill cell's step: (last logits, cache).  The cell sizes the
    cache to the prompt (`max_len` None); a server prefilling ahead of
    decode passes its cache length."""
    return tf.prefill(params, cfg, tokens, max_len=max_len or tokens.shape[1])


def serve_step(params, cfg: LMConfig, cache: tf.DecodeCache, tokens: torch.Tensor):
    """The decode cell's step: one token per sequence against the cache,
    which it consumes (`transformer.decode_step`)."""
    return tf.decode_step(params, cfg, cache, tokens)
