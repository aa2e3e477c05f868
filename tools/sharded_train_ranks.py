#!/usr/bin/env python3
"""The distribution layer's training steps across ranks, one process per
rank (card), the group NCCL at tcp://localhost on a free port:

    python3 tools/sharded_train_ranks.py [--ranks 4] [--device cuda|cpu]
        [--only lm lm_moe deepfm moe ckpt]

  (a) lm: qwen3-0.6b whole on a (ranks, 1) ("data", "model") mesh,
      train_4k's length S = 4,096 and a global batch of 16 (4 sequences a
      card on four), `make_lm_train_step(mesh=)` over `place_lm_state`
      (ZeRO-1 moments) and `shard_batch`.  Step 0 against rank 0's
      one-card step on the same batch and state: the loss within 1e-3
      relative; the gradient norm (AdamW's, before clipping) and every
      leaf of the parameters, m and v (whole, `full_tensor()`) within 2^-5
      relative in L2.  At step 0 the warmup's learning rate barely moves
      the bf16 parameters, so m (0.1 x the clipped gradient), v and the
      norm carry the check of the reduce-scatter and the update.  Then the
      median ms of 3 more steps (CUDA events), the optimizer's collectives
      timed alone (each gradient reduce-scattered to its moments, each
      parameter gathered back: 3 runs, median) as a share of the step,
      each card's peak GiB and moment bytes beside the whole moments';
  (a') lm_moe: the same for mixtral-8x22b at full width, one layer, a
      global batch of 4 (one sequence a card), the state donated on both
      sides: the data-parallel MoE layer (`moe_ffn(dp=)`: expert ids
      all-gathered, slots ranked over the global batch at its capacity)
      against one card's, with every MoE layer's drop fraction;
  (b) deepfm: DeepFM's full CONFIG on a (ranks, 1) mesh, train_batch's
      65,536 examples, the tables' 33,889,984 rows split over the ranks
      (`place_deepfm_state`): step 0 against rank 0's one-card step (loss
      and every parameter within 1e-5), the median ms of 3 more steps,
      peak GiB, the bag kernels' launches in one step (the batches made
      before any timing; the one-card step timed warm);
  (c) moe: deepseek-v3's MoE FFN at full width on a (1, ranks) mesh, its
      experts split over the ranks (64 a card on four, drawn on the card
      that owns them), 8,192 tokens at the config's capacity factor:
      rank 0 first runs `moe_ffn` with all 256 experts and holds
      `moe_ffn_shardmap`'s output to it (tolerance 2^-5 of max |y|: the
      ranks' bf16 partial outputs are summed across cards, a few more
      bf16 roundings than `moe_ffn`'s one combine); then forward, backward
      of the output's mean square and one `adamw_update_placed` on every
      card's experts (in place, the state donated), after one untimed
      forward and backward: ms of each (CUDA events, every rank aligned
      at a barrier first), the output's all-reduce alone, peak GiB, and
      the state a card holds against the whole layer's;
  (d) ckpt: a placed `checkpoint.save` of a 64 MiB tree from every rank,
      then every rank restores it at once and holds it to the tree: no
      rank returns from the save before the writer has put the
      checkpoint in place.

With `--device cpu` the ranks are gloo processes on the CPU and every
config is cut to a CPU size (`launch.train.small_variant`, DeepFM's
SMOKE_CONFIG, 8 experts of width 64, a 1 MiB checkpoint): a rehearsal
of the same code.
Rank 0 prints one JSON line of every number (and writes it to
chiprun_out/sharded_train_ranks.json), beside the card's name and power
limit; the script exits non-zero if a rank fails or overruns `--timeout`,
and stops every rank it started.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import socket
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
LM_SEQ, LM_TIMED = 4096, 3
# part -> (arch, layers kept (None: whole), global batch, donate the state)
LM_RUNS = {"lm": ("qwen3-0.6b", None, 16, False), "lm_moe": ("mixtral-8x22b", 1, 4, True)}
DEEPFM_TIMED = 3
MOE_TOKENS = 8192
LM_LOSS_TOL = 1e-3
# step 0's gradient norm and each leaf of the parameters, m and v against
# one card's, relative in L2: 8 bf16 roundings (the ranks' bf16 gradient
# blocks are summed across cards, one card's within its GEMMs)
LM_LEAF_TOL = 2.0 ** -5
CKPT_FLOATS = 1 << 24                 # the placed save's large leaf, 64 MiB of f32
DEEPFM_TOL = 1e-5
MOE_TOL = 2.0 ** -5


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Rank:
    """This rank's device, clock and helpers."""

    def __init__(self, args):
        import torch
        import torch.distributed as dist

        self.args, self.torch, self.dist = args, torch, dist
        self.cuda = args.device == "cuda"
        self.dev = torch.device("cuda", args.rank) if self.cuda else torch.device("cpu")
        if self.cuda:
            torch.cuda.set_device(self.dev)
            torch.backends.cuda.matmul.allow_tf32 = False
        else:   # the ranks share the host's cores
            torch.set_num_threads(max((os.cpu_count() or 1) // args.ranks, 1))
        kw = {"device_id": self.dev} if self.cuda else {}
        dist.init_process_group("nccl" if self.cuda else "gloo",
                                init_method=f"tcp://localhost:{args.port}",
                                rank=args.rank, world_size=args.ranks, **kw)
        self.rank, self.size = args.rank, args.ranks

    def mesh(self, shape, names=("data", "model")):
        from torch.distributed.device_mesh import DeviceMesh

        return DeviceMesh(self.args.device, self.torch.arange(self.size).reshape(shape),
                          mesh_dim_names=names)

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.dev)

    def reset_peak(self):
        self.sync()
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats(self.dev)

    def peak_gib(self) -> float:
        return self.torch.cuda.max_memory_allocated(self.dev) / 2**30 if self.cuda else 0.0

    def ms(self, fn):
        """(fn(), ms): CUDA events on the card, the host clock on the CPU."""
        if not self.cuda:
            t0 = time.perf_counter()
            out = fn()
            return out, (time.perf_counter() - t0) * 1e3
        a = self.torch.cuda.Event(enable_timing=True)
        b = self.torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        self.sync()
        return out, a.elapsed_time(b)

    def aligned(self):
        """Every rank's queue drained, then a barrier: a timing that starts
        here does not count another rank's lag at its first collective."""
        self.sync()
        self.dist.barrier()
        self.sync()

    def gather(self, obj) -> list:
        out = [None] * self.size
        self.dist.all_gather_object(out, obj)
        return out

    def free(self):
        import gc

        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()


def fail(r: Rank, msg: str) -> None:
    print(f"FAIL rank {r.rank}: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


class StepRecorder:
    """While open, records the AdamW metrics' `grad_norm` (taken before
    clipping) of every update the LM step makes, placed or not, and the
    drop fraction of every MoE layer, by wrapping the names the step and
    the transformer call."""

    def __init__(self):
        from repro_torch.configs import lm_cells
        from repro_torch.models import transformer

        self.names = [(lm_cells, "adamw_update"), (lm_cells, "adamw_update_placed"),
                      (transformer, "moe_ffn")]
        self.grad_norms, self.drops = [], []

    def __enter__(self):
        self.orig = [getattr(mod, name) for mod, name in self.names]

        def update(fn):
            def recording(*args, **kw):
                out = fn(*args, **kw)
                self.grad_norms.append(out[2]["grad_norm"])
                return out
            return recording

        def moe(fn):
            def recording(*args, **kw):
                out, metrics = fn(*args, **kw)
                self.drops.append(metrics.drop_frac)
                return out, metrics
            return recording

        for (mod, name), fn, wrap in zip(self.names, self.orig, (update, update, moe)):
            setattr(mod, name, wrap(fn))
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.names, self.orig):
            setattr(mod, name, fn)


def leaf_err(got, want) -> float:
    """||got - want|| / ||want|| over a leaf, in f32 (0 when both are 0)."""
    import torch

    num = float(torch.linalg.vector_norm((got.float() - want.float()).reshape(-1)))
    den = float(torch.linalg.vector_norm(want.float().reshape(-1)))
    return num / den if den else num


def part_lm(r: Rank, name: str) -> dict:
    import dataclasses

    import torch
    from repro_torch.configs import LM_ARCHS
    from repro_torch.configs import lm_cells as C
    from repro_torch.data.pipeline import TokenStream, shard_batch
    from repro_torch.dist import batch_spec
    from repro_torch.launch.train import small_variant
    from repro_torch.models import transformer as tf
    from repro_torch.train import tree as T
    from repro_torch.train.optimizer import OptConfig, adamw_init

    arch, layers, B, donate = LM_RUNS[name]
    cfg = LM_ARCHS[arch].CONFIG
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    S = LM_SEQ
    if not r.cuda:
        cfg, B, S = small_variant(cfg), 2 * r.size, 64
    mesh = r.mesh((r.size, 1))
    opt_cfg = OptConfig(total_steps=10000)
    stream = TokenStream(cfg.vocab, B, S, seed=17)

    def init():
        return tf.init_lm(torch.Generator(device=r.dev).manual_seed(0), cfg)

    params, opt = C.place_lm_state(init(), mesh)
    step = C.make_lm_train_step(cfg, opt_cfg, donate=donate, mesh=mesh)
    batch = shard_batch(stream.batch_at(0), mesh, batch_spec(mesh, 1))
    r.reset_peak()
    with StepRecorder() as rec:
        (params, opt, loss, _), first_ms = r.ms(lambda: step(params, opt, *batch))
    loss0, gnorm0 = float(loss), float(rec.grad_norms[0])
    drops0 = [float(d) for d in rec.drops]
    # step 0's parameters and moments, whole, on rank 0's host
    kept = []
    for x in T.leaves((params, opt.m, opt.v)):
        whole = x.full_tensor()
        if r.rank == 0:
            kept.append(whole.cpu())
        del whole
    took = []
    for i in range(1, 1 + LM_TIMED):
        batch = shard_batch(stream.batch_at(i), mesh, batch_spec(mesh, 1))
        (params, opt, loss, _), ms = r.ms(lambda: step(params, opt, *batch))
        took.append(ms)
    peak = r.peak_gib()
    moment_bytes = sum(m.to_local().numel() * 4 for m in T.leaves(opt.m)) * 2
    whole_moments = sum(m.numel() * 4 for m in T.leaves(opt.m)) * 2

    # the optimizer's collectives alone: gradients (as the step places them)
    # reduce-scattered to the moments, each parameter's block gathered back
    from repro_torch.dist.sharding import data_axes
    from repro_torch.train.optimizer import partial_grads

    grads = partial_grads(T.tree_map(lambda p: torch.ones_like(p.to_local()), params), params,
                          mesh, set(data_axes(mesh)))
    coll = []
    for _ in range(3):
        r.sync()
        _, ms = r.ms(lambda: [(g.redistribute(mesh, m.placements),
                               p.redistribute(mesh, m.placements).redistribute(mesh, p.placements))
                              for g, m, p in zip(T.leaves(grads), T.leaves(opt.m),
                                                 T.leaves(params))])
        coll.append(ms)
    del grads, params, opt, batch
    r.free()

    out = {"config": cfg.name, "layers": cfg.n_layers, "global_batch": B, "seq": S,
           "mesh": [r.size, 1], "donate": donate, "loss0": loss0, "grad_norm0": gnorm0,
           "drop_frac0": drops0, "first_ms": first_ms,
           "step_ms": statistics.median(took), "steps_ms": took,
           "collectives_ms": statistics.median(coll),
           "collective_share": statistics.median(coll) / statistics.median(took),
           "peak_gib": r.gather(peak), "moment_bytes_card": moment_bytes,
           "moment_bytes_whole": whole_moments, "losses": [loss0, float(loss)]}
    r.dist.barrier()
    if r.rank == 0:         # one card, the whole batch, the same state
        params = init()
        opt = adamw_init(params)
        one = C.make_lm_train_step(cfg, opt_cfg, donate=donate)
        tok, tgt = (torch.from_numpy(a).to(r.dev) for a in stream.batch_at(0))
        with StepRecorder() as rec:
            (params, opt, loss1, _), one_ms = r.ms(lambda: one(params, opt, tok, tgt))
        gnorm1 = float(rec.grad_norms[0])
        errs = {}
        groups = (("params", params), ("m", opt.m), ("v", opt.v))
        mine = iter(kept)
        for what, tree in groups:
            errs[what] = max(leaf_err(next(mine).to(r.dev), x) for x in T.leaves(tree))
        out.update(one_card_loss0=float(loss1), one_card_grad_norm0=gnorm1, one_card_ms=one_ms,
                   one_card_drop_frac0=[float(d) for d in rec.drops], leaf_rel_err=errs,
                   loss_rel_err=abs(loss0 - float(loss1)) / abs(float(loss1)),
                   grad_norm_rel_err=abs(gnorm0 - gnorm1) / gnorm1)
        del params, opt, kept
        r.free()
        if (out["loss_rel_err"] > LM_LOSS_TOL or out["grad_norm_rel_err"] > LM_LEAF_TOL
                or max(errs.values()) > LM_LEAF_TOL):
            fail(r, f"{name}: step 0 against one card: {out}")
    r.dist.barrier()
    return out


def part_ckpt(r: Rank) -> dict:
    """A placed save, then every rank restores at once: the save must not
    return on any rank before the writer has put the checkpoint in place."""
    import shutil

    import torch
    from repro_torch.dist import P, distribute
    from repro_torch.train import checkpoint as ckpt

    n = CKPT_FLOATS if r.cuda else CKPT_FLOATS // 64
    g = torch.Generator(device=r.dev).manual_seed(11)
    tree = {"big": torch.randn((r.size * 8, n // (r.size * 8)), generator=g, device=r.dev),
            "small": torch.arange(10, dtype=torch.int32, device=r.dev)}
    placed = distribute(tree, {"big": P("data", None), "small": P()}, r.mesh((r.size, 1)))
    where = str(ROOT / "build" / "sharded_train_ckpt")
    if r.rank == 0:
        shutil.rmtree(where, ignore_errors=True)
    r.dist.barrier()
    t0 = time.perf_counter()
    ckpt.save(where, 0, placed)
    save_s = time.perf_counter() - t0
    back = ckpt.restore(where, 0, device=r.dev)          # at once, on every rank
    equal = all(torch.equal(back[k], tree[k]) for k in tree)
    found = r.gather([equal, save_s])
    r.dist.barrier()
    if r.rank == 0:
        shutil.rmtree(where, ignore_errors=True)
    if not all(e for e, _ in found):
        fail(r, f"ckpt: a rank read another checkpoint right after the placed save: {found}")
    return {"bytes": tree["big"].numel() * 4 + 40, "restored_equal": [e for e, _ in found],
            "save_s": [t for _, t in found]}


def part_deepfm(r: Rank) -> dict:
    import torch
    from repro_torch.configs import deepfm as C
    from repro_torch.data.pipeline import ClickStream, shard_batch
    from repro_torch.dist import P, batch_spec, data_axes
    from repro_torch.hopper import embedding_bag as E
    from repro_torch.models.deepfm import DeepFM
    from repro_torch.train import adamw_init

    cfg, B = C.CONFIG, C.SHAPES["train_batch"]["batch"]
    if not r.cuda:
        cfg, B = C.SMOKE_CONFIG, 64 * r.size
    mesh = r.mesh((r.size, 1))
    stream = ClickStream(cfg.field_vocabs, B, seed=0)
    model = DeepFM(cfg, seed=0, device=r.dev)
    params, opt = C.place_deepfm_state(C.train_params(model), mesh)

    def batch(i):
        fields, labels = stream.batch_at(i)
        return (shard_batch(fields, mesh, batch_spec(mesh, 1)),
                shard_batch(labels, mesh, P(data_axes(mesh))))

    batches = [batch(i) for i in range(1 + DEEPFM_TIMED)]     # made before any timing
    for w in (E.embedding_bag, E.embedding_bag_backward):
        w.launches = 0
    sorts = E.sort_slots.calls
    r.reset_peak()
    (params1, opt1, loss), first_ms = r.ms(lambda: C.train_step(model, params, opt, *batches[0],
                                                                 mesh=mesh))
    launches = {"embedding_bag": E.embedding_bag.launches,
                "embedding_bag_backward": E.embedding_bag_backward.launches,
                "slot_sorts": E.sort_slots.calls - sorts}
    loss0 = float(loss)
    full = {k: v.full_tensor() for k, v in params1.items()}
    took = []
    p, o = params1, opt1
    for i in range(1, 1 + DEEPFM_TIMED):
        (p, o, loss), ms = r.ms(lambda: C.train_step(model, p, o, *batches[i], mesh=mesh))
        took.append(ms)
    peak = r.peak_gib()
    rows = params["embed"].to_local().shape[0]
    del p, o, params, opt, params1, opt1, batches
    r.free()
    out = {"config": "CONFIG" if r.cuda else "SMOKE_CONFIG", "batch": B, "mesh": [r.size, 1],
           "rows_card": rows, "rows": cfg.total_vocab, "loss0": loss0, "first_ms": first_ms,
           "step_ms": statistics.median(took), "steps_ms": took, "peak_gib": r.gather(peak),
           "launches_step0_rank": launches}
    r.dist.barrier()
    if r.rank == 0:
        params = C.train_params(model)
        opt = adamw_init(params)
        fields, labels = (torch.from_numpy(a).to(r.dev) for a in stream.batch_at(0))
        p1, _, loss1 = C.train_step(model, params, opt, fields, labels)
        _, one_ms = r.ms(lambda: C.train_step(model, params, opt, fields, labels))   # warm
        err = max(float((full[k] - p1[k]).abs().max()) for k in p1)
        out.update(one_card_loss0=float(loss1), one_card_ms=one_ms, max_param_err=err,
                   loss_err=abs(loss0 - float(loss1)))
        if err > DEEPFM_TOL or out["loss_err"] > DEEPFM_TOL:
            fail(r, f"deepfm: step 0 against one card: {out}")
        del p1, params, opt
    del full, model
    r.free()
    r.dist.barrier()
    return out


def part_moe(r: Rank) -> dict:
    import dataclasses

    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.configs import LM_ARCHS
    from repro_torch.dist.sharding import P, _strides
    from repro_torch.models.lm_config import MoEConfig
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.moe_shardmap import moe_ffn_shardmap, moe_shardmap_grads
    from repro_torch.train.optimizer import (
        OptConfig,
        adamw_init_placed,
        adamw_update_placed,
        zero1_specs,
    )

    cfg = LM_ARCHS["deepseek-v3-671b"].CONFIG
    N = MOE_TOKENS
    if not r.cuda:
        cfg = dataclasses.replace(cfg, d_model=64, dtype=torch.float32, moe=MoEConfig(
            n_experts=8, top_k=2, d_expert=64, n_shared=1, router="sigmoid"))
        N = 256
    moe_cfg, E = cfg.moe, cfg.moe.n_experts
    D, F, F_sh = cfg.d_model, moe_cfg.d_expert, moe_cfg.d_expert * moe_cfg.n_shared
    E_r = E // r.size
    lo = r.rank * E_r
    mesh = r.mesh((1, r.size))
    dt = cfg.dtype

    def normal(shape, seed, dtype=dt):
        g = torch.Generator(device=r.dev).manual_seed(seed)
        return (torch.randn(shape, generator=g, device=r.dev, dtype=dtype) * 0.02).to(dtype)

    def experts(e_lo, e_hi):
        out = {}
        for j, name in enumerate(("we1", "we3", "we2")):
            shape = (D, F) if name != "we2" else (F, D)
            stack = torch.empty((e_hi - e_lo,) + shape, dtype=dt, device=r.dev)
            for e in range(e_lo, e_hi):
                stack[e - e_lo] = normal(shape, 1 + 3 * e + j)
            out[name] = stack
        return out

    whole = {"router": normal((D, E), 0, torch.float32), "ws1": normal((D, F_sh), 1 + 3 * E),
             "ws3": normal((D, F_sh), 2 + 3 * E), "ws2": normal((F_sh, D), 3 + 3 * E)}
    x = normal((N, D), 7) * 50          # unit-scale tokens, as after the layer's rms norm
    want = None
    if r.rank == 0:                     # the reference on one card, all E experts
        params = dict(whole, **experts(0, E))
        with torch.no_grad():
            want, metrics = moe_ffn(params, x, moe_cfg, cfg.act)
            _, ref_ms = r.ms(lambda: moe_ffn(params, x, moe_cfg, cfg.act))       # warm
        ref_drop = float(metrics.drop_frac)
        del params
        r.free()
    r.dist.barrier()

    # the placed layer: this rank's experts drawn here, the rest replicated
    local = dict(whole, **experts(lo, lo + E_r))
    specs = {k: P("model", None, None) if k.startswith("we") else P() for k in local}
    placed = {}
    for k, v in local.items():
        pl = [Replicate(), Shard(0) if k.startswith("we") else Replicate()]
        shape = (E,) + tuple(v.shape[1:]) if k.startswith("we") else tuple(v.shape)
        placed[k] = DTensor.from_local(v, mesh, pl, run_check=False, shape=torch.Size(shape),
                                       stride=_strides(shape))
    opt = adamw_init_placed(placed, zero1_specs(specs, placed, "data", 1), mesh)
    leaves = {k: v.to_local().detach().requires_grad_() for k, v in placed.items()}
    with torch.enable_grad():     # a warm-up forward and backward, untimed
        y = moe_ffn_shardmap(leaves, x, moe_cfg, cfg.act, mesh)
        torch.autograd.grad(torch.mean(torch.square(y.float())), list(leaves.values()))
    del y
    r.reset_peak()
    with torch.enable_grad():
        r.aligned()
        y, fwd_ms = r.ms(lambda: moe_ffn_shardmap(leaves, x, moe_cfg, cfg.act, mesh))
        loss = torch.mean(torch.square(y.float()))
        r.aligned()
        grads, bwd_ms = r.ms(lambda: torch.autograd.grad(loss, list(leaves.values())))
    grads = moe_shardmap_grads(dict(zip(leaves, grads)), placed, mesh)
    r.aligned()
    (new, opt, metrics), opt_ms = r.ms(lambda: adamw_update_placed(
        OptConfig(total_steps=10000), grads, opt, placed, in_place=True))
    # the forward's one collective alone: the (N, D) sum over the expert ranks
    group = mesh.get_group("model")
    took = []
    for _ in range(3):
        r.aligned()
        took.append(r.ms(lambda: r.dist.all_reduce(y.detach().clone(), group=group))[1])
    peak = r.peak_gib()
    state_card = sum(v.to_local().numel() * v.to_local().element_size() for v in new.values())
    state_card += sum(m.to_local().numel() * 4 * 2 for m in opt.m.values())
    n_params = sum(v.numel() for v in new.values())
    state_whole = sum(v.numel() * v.element_size() for v in new.values()) + n_params * 8
    out = {"config": cfg.name, "mesh": [1, r.size], "tokens": N, "experts_card": E_r,
           "capacity_factor": moe_cfg.capacity_factor, "forward_ms": fwd_ms,
           "output_all_reduce_ms": statistics.median(took),
           "backward_ms": bwd_ms, "optimizer_ms": opt_ms, "peak_gib": r.gather(peak),
           "state_bytes_card": state_card, "state_bytes_whole": state_whole,
           "grad_norm": float(metrics["grad_norm"]), "params": n_params}
    if r.rank == 0:
        err = float((y.detach().float() - want.float()).abs().max()) / float(
            want.float().abs().max())
        out.update(moe_ffn_ms=ref_ms, out_rel_err=err, drop_frac=ref_drop)
        if not err <= MOE_TOL:
            fail(r, f"moe: moe_ffn_shardmap vs moe_ffn: {err} of max |y| (tol {MOE_TOL})")
    del y, grads, new, opt, placed, leaves, local, want
    r.free()
    r.dist.barrier()
    return out


PARTS = {"lm": lambda r: part_lm(r, "lm"), "lm_moe": lambda r: part_lm(r, "lm_moe"),
         "deepfm": part_deepfm, "moe": part_moe, "ckpt": part_ckpt}


def rank_main(args) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    r = Rank(args)
    out = {"ranks": args.ranks, "device": args.device}
    for name in args.only:
        t0 = time.perf_counter()
        out[name] = PARTS[name](r)
        out[name]["seconds"] = time.perf_counter() - t0
    r.dist.barrier()
    r.dist.destroy_process_group()
    if r.rank == 0:
        if r.cuda:
            out["card"] = card_line()
        line = json.dumps(out)
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "sharded_train_ranks.json").write_text(line + "\n")
        print(line, flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--only", nargs="+", choices=sorted(PARTS), default=list(PARTS))
    ap.add_argument("--timeout", type=float, default=1500.0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args)
        return
    if args.device == "cuda":
        import torch

        if torch.cuda.device_count() < args.ranks:
            sys.exit(f"{args.ranks} ranks need {args.ranks} CUDA cards, "
                     f"found {torch.cuda.device_count()}")
    port = free_port()
    cmd = [sys.executable, str(pathlib.Path(__file__).resolve()), "--ranks", str(args.ranks),
           "--device", args.device, "--only", *args.only, "--port", str(port)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)]) for r in range(args.ranks)]
    deadline = time.monotonic() + args.timeout
    rc = 0
    try:
        for p in procs:
            try:
                rc = rc or p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                print(f"FAIL: a rank ran past {args.timeout} s", file=sys.stderr)
                rc = 1
                break
            if rc:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    sys.exit(rc)


if __name__ == "__main__":
    main()
