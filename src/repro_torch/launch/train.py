"""End-to-end LM training driver (counterpart of `repro.launch.train`, the
same flags and output lines, plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --preset cpu-small --steps 200 --ckpt-dir build/train_lm [--device cpu]

Presets:
  cpu-small   `small_variant` of the arch (d 256, 4 layers, vocab 2,048,
              f32), the reference's ~10M-parameter reduction.
  production  the arch's full CONFIG (bf16, per-layer remat); it must fit
              one card with its AdamW state (qwen3-0.6b and qwen1.5-0.5b
              do; the 140 B-671 B archs wait for sharded state).

The loop is the fault-tolerant TrainLoop over `TokenStream` (checkpoint
and restart, retries, straggler deadlines); each step is
`lm_cells.make_lm_train_step`.  Weights come from `init_lm(prng.key(0))`
on the device, the reference's.  The default checkpoint directory lies under the temporary
directory; a directory that holds a checkpoint resumes from it.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

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


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    p.add_argument("--arch", default="qwen1.5-0.5b")
    p.add_argument("--preset", default="cpu-small", choices=["cpu-small", "production"])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--log", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where weights, optimizer state and steps live (default: the CUDA "
                        "device)")
    args = p.parse_args(argv)

    from repro_torch.configs import LM_ARCHS
    from repro_torch.configs.lm_cells import make_lm_train_step
    from repro_torch.core import prng
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as tf
    from repro_torch.train import LoopConfig, OptConfig, TrainLoop, adamw_init
    from repro_torch.train import tree as T

    dev = resolve_device(args.device)
    full = LM_ARCHS[args.arch].CONFIG
    cfg = full if args.preset == "production" else small_variant(full)

    params = tf.init_lm(prng.key(0), cfg, device=dev)
    opt = adamw_init(params)
    n_params = sum(x.numel() for x in T.leaves(params))
    print(f"{args.arch} [{args.preset}]: {n_params/1e6:.1f}M params")

    opt_cfg = OptConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    raw_step = make_lm_train_step(cfg, opt_cfg)

    def step_fn(state, batch):
        params, opt = state
        tokens, targets = batch
        params, opt, loss, xent = raw_step(params, opt, tokens, targets)
        return (params, opt), {"loss": loss, "xent": xent}

    loop = TrainLoop(
        step_fn=step_fn,
        init_state=(params, opt),
        stream=TokenStream(cfg.vocab, args.batch, args.seq, seed=17),
        cfg=LoopConfig(
            ckpt_dir=args.ckpt_dir,
            checkpoint_every=args.checkpoint_every,
            log_path=args.log,
        ),
        device=dev,
    )
    print(f"starting at step {loop.start_step}")
    result = loop.run(args.steps)
    print(f"done: {result}")
    return result


if __name__ == "__main__":
    main()
