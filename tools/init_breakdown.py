#!/usr/bin/env python3
"""Where a full-width init's time goes, on one CUDA card.

    PYTHONPATH=src python3 tools/init_breakdown.py

Builds the Threefry kernel, then:

  builds   qwen3-0.6b's `init_lm(prng.key(0), CONFIG)` and
           `DeepFM(CONFIG, seed=0)` on the card, three times each, each
           after `torch.cuda.empty_cache()` (what `chip_smoke.py`'s phase
           (d) does between its inits: the allocator holds nothing, so
           every tensor is a fresh `cudaMalloc`), then DeepFM three times
           with the blocks of the build before still cached
  alloc    DeepFM's (V, d) f32 table alone, `torch.empty`, on an emptied
           cache and on a warm one
  parts    one DeepFM build on an emptied cache taken apart, each part
           synced: the table's allocation, each `prng.FILL_BLOCK` block of
           its draw (in place, as `normal_into` draws an f32 leaf, then
           again through a separate f32 block copied in, as it drew one
           before), the linear table, each MLP layer as it was built
           before (`nn.utils.skip_init`, its draw, a transposed copy), then
           the port's `MLP`
  profile  one DeepFM build on an emptied cache under `torch.profiler`:
           the ten ops with the most host time

Other modes, each alone in a fresh process (a cost paid once a process
lands on the step that pays it):

  --first            qwen3-0.6b's init, then DeepFM taken apart as in
                     `parts` (each MLP layer's steps too), and stop
  --transpose-first  the same after a (3, 4) f32 transposed copy, timed
  --deepfm-only      the Threefry kernel built and loaded, not launched,
                     then two DeepFM builds and nothing else (run it on
                     another commit's `src` too)

Host-clock seconds after a synchronize.  The full run prints the card's
name and power limit last.
"""
import subprocess
import time

import torch

from repro_torch.configs import LM_ARCHS
from repro_torch.configs import deepfm as DC
from repro_torch.core import prng
from repro_torch.hopper import threefry as F
from repro_torch.models import deepfm as M
from repro_torch.models import transformer as tf
from repro_torch.models.gnn.common import MLP


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def builds():
    cfg = LM_ARCHS["qwen3-0.6b"].CONFIG
    cases = (("qwen3-0.6b", lambda: tf.init_lm(prng.key(0), cfg, device="cuda"), True),
             ("deepfm", lambda: M.DeepFM(DC.CONFIG, seed=0, device="cuda"), True),
             ("deepfm", lambda: M.DeepFM(DC.CONFIG, seed=0, device="cuda"), False))
    for name, fn, empty in cases:
        for i in range(3):
            if empty:
                torch.cuda.empty_cache()
            before = F.threefry_bits.launches
            built, secs = timed(fn)
            print(f"[init] builds: {name} {i}, cache {'emptied' if empty else 'warm'}: "
                  f"{secs:.4f} s, {F.threefry_bits.launches - before} threefry launches",
                  flush=True)
            del built


def alloc():
    V, d = DC.CONFIG.total_vocab, DC.CONFIG.embed_dim
    for state in ("emptied", "warm"):
        if state == "emptied":
            torch.cuda.empty_cache()
        t, secs = timed(lambda: torch.empty((V, d), device="cuda"))
        print(f"[init] alloc: ({V}, {d}) f32, {4 * V * d} B, cache {state}: {secs:.4f} s",
              flush=True)
        del t


def parts(label="parts"):
    cfg = DC.CONFIG
    k1, k2, k3 = prng.split(prng.key(0), 3)
    V, d = cfg.total_vocab, cfg.embed_dim
    torch.cuda.empty_cache()
    table, secs = timed(lambda: torch.empty((V, d), device="cuda"))
    print(f"[init] {label}: empty ({V}, {d}) {secs:.4f} s", flush=True)
    flat = table.view(-1)
    for lo in range(0, flat.numel(), prng.FILL_BLOCK):
        hi = min(lo + prng.FILL_BLOCK, flat.numel())
        _, t_in = timed(lambda: F.threefry_bits(k1.k0, k1.k1, hi - lo, "cuda", "normal",
                                                start=lo, out=flat[lo:hi]).mul_(0.01))
        block, t_draw = timed(lambda: prng.normal(k1, hi - lo, "cuda", start=lo))
        _, t_scale = timed(lambda: block.mul_(0.01))
        _, t_copy = timed(lambda: flat[lo:hi].copy_(block))
        del block
        print(f"[init] {label}: embed block [{lo}, {hi}): in place {t_in:.4f} s; through a "
              f"block: draw {t_draw:.4f} s, scale {t_scale:.4f} s, copy {t_copy:.4f} s",
              flush=True)
    _, secs = timed(lambda: prng.normal_into(k2, torch.empty((V,), device="cuda"), 0.01))
    print(f"[init] {label}: linear {secs:.4f} s", flush=True)
    _, secs = timed(lambda: (torch.zeros((), device="cuda"), cfg.offsets.to("cuda")))
    print(f"[init] {label}: bias and offsets {secs:.4f} s", flush=True)
    dims = (cfg.n_fields * d,) + tuple(cfg.mlp_dims) + (1,)
    for k, i, o in zip(prng.split(k3, len(dims) - 1), dims[:-1], dims[1:]):
        layer, t_make = timed(lambda: torch.nn.utils.skip_init(torch.nn.Linear, i, o,
                                                               device="cuda"))
        w, t_draw = timed(lambda: prng.normal(k, (i, o), "cuda") * (2.0 / i) ** 0.5)
        with torch.no_grad():
            _, t_copy = timed(lambda: layer.weight.copy_(w.T))
            _, t_zero = timed(lambda: layer.bias.zero_())
        print(f"[init] {label}: mlp layer ({i}, {o}): skip_init {t_make:.4f} s, draw and scale "
              f"{t_draw:.4f} s, transposed copy {t_copy:.4f} s, bias {t_zero:.4f} s",
              flush=True)
    _, secs = timed(lambda: MLP(dims, key=k3, device="cuda", act=torch.relu))
    print(f"[init] {label}: mlp {secs:.4f} s", flush=True)
    del table, flat


def profiled():
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.empty_cache()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        M.DeepFM(DC.CONFIG, seed=0, device="cuda")
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cpu_time_total", row_limit=10), flush=True)


def first_transpose():
    """A (3, 4) f32 transposed copy, the process's first, timed."""
    x = torch.ones((3, 4), device="cuda")
    y = torch.empty((4, 3), device="cuda")
    for i in range(2):
        _, secs = timed(lambda: y.copy_(x.T))
        print(f"[init] first: a (3, 4) transposed copy, {i}: {secs:.4f} s", flush=True)


def main():
    import os
    import sys

    print(f"[init] torch {torch.__version__}, CUDA {torch.version.cuda}, archs "
          f"{torch.cuda.get_arch_list()}, CUDA_MODULE_LOADING "
          f"{os.environ.get('CUDA_MODULE_LOADING')}", flush=True)
    timed(lambda: torch.ones(1, device="cuda"))
    if "--deepfm-only" in sys.argv:
        from repro_torch.hopper.build import library

        library("threefry")                  # built and loaded, as a program's kernels are
        for i in range(2):
            _, secs = timed(lambda: M.DeepFM(DC.CONFIG, seed=0, device="cuda"))
            print(f"[init] deepfm only: build {i} of the process {secs:.4f} s", flush=True)
        return
    F.threefry_bits(0, 0, 1, "cuda", "normal")
    if "--transpose-first" in sys.argv:
        first_transpose()
    if "--first" in sys.argv:
        tf.init_lm(prng.key(0), LM_ARCHS["qwen3-0.6b"].CONFIG, device="cuda")
        parts("first")
        return
    builds()
    alloc()
    parts()
    profiled()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[init] card: {smi.stdout.strip()}", flush=True)


if __name__ == "__main__":
    main()
