"""Batched LM serving driver (counterpart of `repro.launch.serve`, the same
flags and output lines, plus ``--device``): prefill a batch of prompts,
then decode with a KV cache (ring-buffered for SWA archs, latent for MLA),
on `small_variant` of the arch's config with random weights.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --batch 4 --prompt-len 32 --gen 16

Weights come from `init_lm(prng.key(0))` and prompts from
`randint(key(1), (batch, prompt_len), 0, vocab)`, as the reference's, on
the device.  Decoding is greedy (argmax); ``--temperature T`` samples step
i with `categorical(key(100 + i), logits / T)`, the reference's draw.
"""
from __future__ import annotations

import argparse
import time

import torch


def generate(params, cfg, prompts: torch.Tensor, n_new: int, *,
             temperature: float = 0.0, key_base: int = 100):
    """Prefill `prompts` (B, P) into a cache of P + n_new slots, then
    decode `n_new` tokens, each fed back: greedy, or with `temperature` >
    0 step i samples `categorical(key(key_base + i), logits /
    temperature)`.  Returns (the new tokens (B, n_new) int32, the last
    cache, prefill seconds, decode seconds); the clock stops after a
    device sync."""
    from repro_torch.core import prng
    from repro_torch.models import transformer as tf

    dev = prompts.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    max_len = prompts.shape[1] + n_new

    def pick(logits, i):
        if temperature > 0:
            return prng.categorical(prng.key(key_base + i), logits / temperature)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    t0 = time.perf_counter()
    logits, cache = tf.prefill(params, cfg, prompts, max_len=max_len)
    sync()
    t_prefill = time.perf_counter() - t0
    out = []
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    t0 = time.perf_counter()
    for i in range(n_new):
        out.append(tok)
        logits, cache = tf.decode_step(params, cfg, cache, tok)
        tok = pick(logits, i)
    sync()
    t_decode = time.perf_counter() - t0
    return torch.stack(out, dim=1), cache, t_prefill, t_decode


def prompts(cfg, batch: int, prompt_len: int, device) -> torch.Tensor:
    """The launcher's prompts: `randint(key(1), (batch, prompt_len), 0,
    vocab)`, int32."""
    from repro_torch.core import prng

    return prng.randint(prng.key(1), (batch, prompt_len), 0, cfg.vocab, device)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    p.add_argument("--arch", default="qwen3-0.6b")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where weights, cache and decoding live (default: the CUDA device)")
    args = p.parse_args(argv)

    from repro_torch.configs import LM_ARCHS
    from repro_torch.core import prng
    from repro_torch.device import resolve_device
    from repro_torch.launch.train import small_variant
    from repro_torch.models import transformer as tf

    dev = resolve_device(args.device)
    cfg = small_variant(LM_ARCHS[args.arch].CONFIG)
    params = tf.init_lm(prng.key(0), cfg, device=dev)
    tokens = prompts(cfg, args.batch, args.prompt_len, dev)
    gen, cache, t_prefill, t_decode = generate(params, cfg, tokens, args.gen,
                                               temperature=args.temperature)
    print(f"arch={args.arch} batch={args.batch}")
    print(f"prefill {args.prompt_len} tok: {t_prefill*1e3:.1f} ms")
    print(
        f"decode  {args.gen} steps: {t_decode*1e3:.1f} ms "
        f"({t_decode/args.gen*1e3:.2f} ms/tok, ring={cache.length})"
    )
    print("sample token ids:", gen[0, :8].tolist())


if __name__ == "__main__":
    main()
