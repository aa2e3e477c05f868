"""The LM training launcher's config reduction (counterpart of
`repro.launch.train`): `small_variant`, which the serve launcher runs.

The launcher's `main` (the fault-tolerant TrainLoop over `TokenStream`
with `make_lm_train_step`) waits for the LM's training slice: the port has
no `lm_loss` yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.lm_config import LMConfig, MLAConfig, MoEConfig


def small_variant(cfg: LMConfig, vocab: int = 2048) -> LMConfig:
    """Shrink an LMConfig to a CPU-trainable size, keeping its structure."""
    moe = None
    if cfg.moe:
        moe = MoEConfig(
            n_experts=min(cfg.moe.n_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            d_expert=128,
            n_shared=min(cfg.moe.n_shared, 1),
            router=cfg.moe.router,
        )
    mla = None
    if cfg.mla:
        mla = MLAConfig(q_lora_rank=64, kv_lora_rank=32, d_nope=32, d_rope=16, d_v=32)
    return dataclasses.replace(
        cfg,
        n_layers=min(cfg.n_layers, 4),
        d_model=256,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=64,
        d_ff=512,
        vocab=vocab,
        moe=moe,
        mla=mla,
        window=min(cfg.window, 128) if cfg.window else None,
        dtype=torch.float32,
        attn_chunk=64,
        loss_chunk=64,
        mtp=cfg.mtp,
    )
