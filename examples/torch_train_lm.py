"""End-to-end training on the port: train a small LM for a few hundred
steps with the fault-tolerant loop (checkpoint/restart exercised mid-run),
on the CUDA card by default.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200 [--device cpu]
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.configs import LM_ARCHS
from repro_torch.configs.lm_cells import make_lm_train_step
from repro_torch.core import prng
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch.train import small_variant
from repro_torch.models import transformer as tf
from repro_torch.train import LoopConfig, OptConfig, TrainLoop, adamw_init
from repro_torch.train import tree as T


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_example_lm"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    cfg = small_variant(LM_ARCHS[args.arch].CONFIG)
    params = tf.init_lm(prng.key(0), cfg, device=dev)
    n = sum(x.numel() for x in T.leaves(params))
    print(f"{args.arch} (reduced): {n/1e6:.1f}M params")

    raw = make_lm_train_step(
        cfg, OptConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps))

    def step_fn(state, batch):
        p, o = state
        tokens, targets = batch
        p, o, loss, xent = raw(p, o, tokens, targets)
        return (p, o), {"loss": loss, "xent": xent}

    loop = TrainLoop(
        step_fn=step_fn,
        init_state=(params, adamw_init(params)),
        stream=TokenStream(cfg.vocab, batch=8, seq=128, seed=11),
        cfg=LoopConfig(ckpt_dir=args.ckpt, checkpoint_every=50),
        device=dev,
    )
    print(f"resuming from step {loop.start_step}" if loop.start_step
          else "fresh run")
    result = loop.run(args.steps)
    print(f"final: {result['metrics']}  "
          f"(uniform={float(np.log(cfg.vocab)):.3f} nats)")
    print(f"stragglers={result['stragglers']} recoveries={result['recoveries']}")
    return result


if __name__ == "__main__":
    main()
