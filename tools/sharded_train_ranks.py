#!/usr/bin/env python3
"""The distribution layer's training steps across ranks, one process per
rank (card), the group NCCL at tcp://localhost on a free port:

    python3 tools/sharded_train_ranks.py [--ranks 4] [--device cuda|cpu]
        [--only lm lm_moe deepfm moe ckpt lm_tp lm_tp_moe lm_fsdp decode_tp deepfm_tp
                gnn_products gnn_minibatch]

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
      checkpoint in place;
  (e) lm_tp: (a) for qwen3-0.6b whole at 16 x 4,096 global on a (1, 4)
      and a (2, 2) mesh: the tensor-parallel step (`tp=`), its heads,
      hidden units and vocab split over 'model'; besides (a)'s numbers,
      the device ms of NCCL's kernels in one more profiled step as a
      share of the step;
  (f) lm_tp_moe: the same for mixtral-8x22b at full width in f32, one
      layer, 1 x 4,096, on (1, 4) (2 experts a card; in bf16 a rounding
      flips some tokens' experts, so only f32 holds the router to one
      card's), and deepseek-v3's 3 dense layers with the MTP block (MLA,
      the MTP projection gathered) at 1 x 2,048 (one card's comparison
      step must fit beside an NCCL rank), both donated;
  (g) lm_fsdp: nemotron-4-340b at full width, one layer (`FSDP_RUN`: its
      154.7 GB of state fits no card), 2 x 4,096, drawn leaf by leaf onto
      its blocks (no rank holds the whole tree), one donated step with
      `fsdp=True` on (1, 4) and on (2, 2): ms, peak GiB and state bytes a
      card, then the device ms of NCCL's kernels in one more profiled
      step as a share of the first's; step 0's losses within 1e-3 relative of each other and of
      rank 0's one-card forward of `lm_loss` on the same weights;
  (h) decode_tp: on (1, ranks), qwen3-0.6b whole, nemotron-4-340b one
      layer (2 KV heads a card) and deepseek-v3's 3 dense (MLA) layers:
      `prefill_step(mesh=)` of 8 x 512 into a 32,768-slot cache placed
      by `cache_specs`, then 16 `serve_step(mesh=)` calls fed rank 0's
      one-card greedy tokens, ms a step beside one card's; every step's
      logits within twice one card's own bf16 spread (the max |logit|
      difference between its last decode step and a prefill of the same
      tokens: two bf16 paths to one function, and the layout's run and
      the one-card run each carry that spread), and the greedy tokens
      equal wherever one card's top-2 margin exceeds that tolerance;
  (i) deepfm_tp: (b) on a (2, ranks / 2) mesh: the tables over
      ('data', 'model'), the tower's first layers over 'model'; (b) also
      holds serve_bulk's logits and retrieval_cand's scores (its
      candidates over every rank, the item field's rows on one) to one
      card's within 1e-5, and times them;
  (j) gnn_products: ogb_products' full-graph step, the graph split over
      the ranks (`gnn_cells.products_inputs` drawn whole on every rank,
      `dist.graph.split_graph`, `full_graph_step(split=)` over
      `place_gnn_state`): gin-tu on the whole stand-in (2,449,029
      vertices, about 123.7 M half-edges) on (ranks, 1) and (2, ranks /
      2), 3 steps each (the loss must fall), ms a step (the median after
      the first), NCCL's device ms in one more profiled step and its share
      of the step, each card's peak GiB; step 0's loss within
      GNN_LOSS_TOL of rank 0's one-card forward under no_grad with the
      edges summed CHUNK_EDGES at a time; pna, egnn and mace the same at
      PRODUCTS_4's fractions (the losses finite); then each arch at
      PRODUCTS_1's fraction, one placed step against rank 0's one-card
      step from the same state: the loss, the gradient norm and every leaf
      of m and sqrt(v) (relative in L2) within twice one card's
      run-to-run spread (the largest difference from it of the one-card
      step on the graph relabelled three ways, vertices and edges in other
      orders, and of the step with its GEMMs on cuBLASLt: the order of its
      sums over edges, over vertices and inside each GEMM, which the split
      changes too, a card's GEMMs running on its quarter of the rows), no
      less than twice 2^-23.  Rank 0 prints
      each run's numbers as a `[gnn_products]` line when it ends;
  (k) gnn_minibatch: minibatch_lg's step with its tables split over the
      ranks as the reference places them (`dist.lookup.TableSplit`,
      `minibatch_step(tables=)`) against the step on whole tables on the
      same mesh: gin-tu on the Reddit-shaped stand-in that chip_smoke's
      phase 12 (b) builds (`erdos_renyi` at 232,965 vertices and about
      114.6 M half-edges, drawn on every rank's host; the CSR on the card;
      a 602-wide feature table), B = 1,024 global seeds at fanout (15,
      10), split over the batch ranks, on (ranks, 1) and (2, ranks / 2).
      MINI_STEPS steps of each from the same state on the same seeds and
      draws: every step's loss and every leaf of the parameters, m and v
      bit-equal on every rank, both run under torch's deterministic
      algorithms (the segment sums' float atomics would put two runs of
      one step a few ulps apart), the timed steps after them in its
      default mode.  The replicated steps run first with the
      whole tables on the card; the blocks are then cut and the whole
      tables dropped, so each run's peak is what its placement holds.  Per
      card: the median ms of the steps after the first (CUDA events, every
      rank aligned first), the peak GiB, the tables' bytes, and the lookup
      alone (the tree sampled and its rows read, median of MINI_STEPS).

With `--device cpu` the ranks are gloo processes on the CPU and every
config is cut to a CPU size (`launch.train.small_variant`, DeepFM's
SMOKE_CONFIG, 8 experts of width 64, a 1 MiB checkpoint, 16-token
prompts into a 48-slot cache, ogb_products' stand-in at GNN_CPU_NODES
vertices for the whole): a rehearsal of the same code.
Rank 0 prints one JSON line of every number (and writes it to
chiprun_out/sharded_train_ranks.json), beside the card's name and power
limit, with the checks that failed (`failures`; every part runs all the
same); the script exits non-zero if a check fails, a rank fails or
overruns `--timeout`, and stops every rank it started.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import socket
import statistics
import subprocess
import sys
import time
from typing import NamedTuple, Optional

ROOT = pathlib.Path(__file__).resolve().parent.parent
LM_SEQ, LM_TIMED = 4096, 3


class LMRun(NamedTuple):
    arch: str
    layers: Optional[int]             # layers kept (None: whole)
    dense_only: bool                  # keep only dense layers
    batch: int                        # global batch of `seq`-token sequences
    donate: bool                      # the step writes its state in place
    mesh: Optional[tuple] = None      # ("data", "model"); None: (ranks, 1)
    seq: int = LM_SEQ
    f32: bool = False                 # the config in f32 (bf16 as published)


# part -> its runs.  mixtral's layer is held to one card in f32: in bf16 a
# rounding upstream flips some tokens' top-2 experts (routing is not
# continuous), which moved the router's m by 8 % in L2 on four H100s.
# deepseek's dense layers run 2,048 tokens: one card's step at 4,096 peaks at
# 70.9 GiB, which does not fit beside an NCCL rank.
LM_RUNS = {
    "lm": [LMRun("qwen3-0.6b", None, False, 16, False)],
    "lm_moe": [LMRun("mixtral-8x22b", 1, False, 4, True)],
    "lm_tp": [LMRun("qwen3-0.6b", None, False, 16, False, (1, 4)),
              LMRun("qwen3-0.6b", None, False, 16, False, (2, 2))],
    "lm_tp_moe": [LMRun("mixtral-8x22b", 1, False, 1, True, (1, 4), f32=True),
                  LMRun("deepseek-v3-671b", 3, True, 1, True, (1, 4), seq=2048)],
}
DEEPFM_TIMED = 3
MOE_TOKENS = 8192
LM_LOSS_TOL = 1e-3
# step 0's gradient norm and each leaf of the parameters, m and v against
# one card's, relative in L2: 8 bf16 roundings (the ranks' bf16 gradient
# blocks are summed across cards, one card's within its GEMMs)
LM_LEAF_TOL = 2.0 ** -5
CKPT_FLOATS = 1 << 24                 # the placed save's large leaf, 64 MiB of f32
DEEPFM_TOL = 1e-5
RETRIEVAL_FIELD = 13                  # chip_smoke's item field: 1,000,000 rows, on one rank
MOE_TOL = 2.0 ** -5
# lm_fsdp: nemotron-4-340b at full width, layers kept (one layer: 12.891 B
# parameters, 154.7 GB of training state; two would put ~76 GB on a card of
# the (2, 2) layout, whose gathered embedding and head (and their gradients)
# add ~19 GB), global batch of LM_SEQ tokens, the two layouts
FSDP_RUN = ("nemotron-4-340b", 1, 2, ((1, 4), (2, 2)))
FSDP_LOSS_TOL = 1e-3
# decode_tp on (1, ranks): arch -> (layers kept, only dense layers); batch 8,
# 512-token prompts into a 32,768-slot cache (decode_32k's), 16 greedy steps
DECODE_RUNS = {"qwen3-0.6b": (None, False), "nemotron-4-340b": (1, False),
               "deepseek-v3-671b": (3, True)}
DECODE = dict(batch=8, prompt=512, cache=32_768, steps=16)
# gnn_products: ogb_products' stand-in at its widths and average degree,
# fractions of its 2,449,029 vertices (PERF.md section 4 reckons the bytes):
# gin-tu whole on both layouts; pna, egnn and mace at the largest power of
# two that four cards hold; each arch held to one card where rank 0's card
# holds it beside NCCL's buffers (6.4 GB outside PyTorch there: pna's one
# card step at 1/16, 74 GiB alone, ran out of memory)
GNN_WHOLE = ("gin-tu", 1.0, ((4, 1), (2, 2)))
PRODUCTS_4 = {"pna": 1 / 4, "egnn": 1 / 4, "mace": 1 / 32}
PRODUCTS_1 = {"gin-tu": 1 / 4, "pna": 1 / 32, "egnn": 1 / 16, "mace": 1 / 256}
GNN_STEPS = 3
GNN_SEED = 0
GNN_CPU_NODES = 4096          # the whole stand-in's vertices on the CPU
# step 0's loss against the chunked one-card forward, relative: f32 sums of
# about 50 messages a vertex in other orders through five layers
GNN_LOSS_TOL = 1e-5
CHUNK_EDGES = 1 << 24
SPREAD_FLOOR = 2.0 ** -23     # two runs that happen to round alike
SPREAD_SEEDS = (0, 1, 2)      # the relabelled one-card runs behind a spread
# gnn_minibatch: minibatch_lg's Reddit-shaped stand-in (the vertex count cut
# to MINI_CPU_NODES, the batch to MINI_CPU_BATCH, on the CPU)
MINI_STEPS = 4
MINI_CPU_NODES, MINI_CPU_BATCH = 2048, 64


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
        self.failures = []

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
    """A check failed: said at once, the rank goes on to the other parts
    and exits non-zero at the end."""
    print(f"FAIL rank {r.rank}: {msg}", file=sys.stderr, flush=True)
    r.failures.append(msg)


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


def nccl_ms(r: Rank, fn):
    """(fn(), the device ms of NCCL's kernels in it) by torch.profiler (the
    card only: None on the CPU)."""
    if not r.cuda:
        return fn(), None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        r.sync()
    total = 0.0
    for evt in prof.key_averages():
        if "nccl" in evt.key.lower():
            total += getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
    return out, total / 1e3


def lm_run(r: Rank, run) -> dict:
    """One LM run on its mesh against rank 0's one-card step (see the
    module docstring, (a))."""
    import dataclasses

    import torch
    from repro_torch.configs import LM_ARCHS
    from repro_torch.configs import lm_cells as C
    from repro_torch.core import prng
    from repro_torch.data.pipeline import TokenStream, shard_batch
    from repro_torch.dist import batch_spec
    from repro_torch.launch.train import small_variant
    from repro_torch.models import transformer as tf
    from repro_torch.train import tree as T
    from repro_torch.train.optimizer import OptConfig, adamw_init

    arch, layers, dense_only, B, donate, shape, S, f32 = run
    full = LM_ARCHS[arch].CONFIG
    cfg = full
    if layers is not None:
        cfg = dataclasses.replace(full, n_layers=layers,
                                  n_dense_layers=layers if dense_only else full.n_dense_layers)
    if f32:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    shape = shape or (r.size, 1)
    if not r.cuda:
        cfg, B, S = small_variant(cfg), 2 * r.size, 64
    mesh = r.mesh(shape)
    opt_cfg = OptConfig(total_steps=10000)
    stream = TokenStream(cfg.vocab, B, S, seed=17)

    def init():
        return tf.init_lm(prng.key(0), cfg, device=r.dev)

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
            kept.append(whole.to("cpu", copy=True))   # not an alias of a donated leaf
        del whole
    took = []
    for i in range(1, 1 + LM_TIMED):
        batch = shard_batch(stream.batch_at(i), mesh, batch_spec(mesh, 1))
        r.aligned()
        (params, opt, loss, _), ms = r.ms(lambda: step(params, opt, *batch))
        took.append(ms)
    peak = r.peak_gib()
    moment_bytes = sum(m.to_local().numel() * 4 for m in T.leaves(opt.m)) * 2
    whole_moments = sum(m.numel() * 4 for m in T.leaves(opt.m)) * 2

    # the collectives: NCCL's kernels in one more profiled step, and the
    # optimizer's alone (each gradient reduce-scattered to its moments,
    # each parameter gathered back)
    from repro_torch.dist.sharding import data_axes
    from repro_torch.train.optimizer import partial_grads

    batch = shard_batch(stream.batch_at(1 + LM_TIMED), mesh, batch_spec(mesh, 1))
    r.aligned()
    (params, opt, loss, _), step_nccl_ms = nccl_ms(r, lambda: step(params, opt, *batch))
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
           "dtype": str(cfg.dtype),
           "mesh": list(shape), "donate": donate, "loss0": loss0, "grad_norm0": gnorm0,
           "drop_frac0": drops0, "first_ms": first_ms,
           "step_ms": statistics.median(took), "steps_ms": took,
           "collectives_ms": statistics.median(coll),
           "collective_share": statistics.median(coll) / statistics.median(took),
           "step_nccl_ms": step_nccl_ms,
           "step_nccl_share": None if step_nccl_ms is None else
           step_nccl_ms / statistics.median(took),
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
        errs, worst = {}, {}
        groups = (("params", params), ("m", opt.m), ("v", opt.v))
        mine = iter(kept)
        for what, tree in groups:
            paths = []
            T.tree_map_with_path(lambda path, x: paths.append("/".join(map(str, path))), tree)
            each = [leaf_err(next(mine).to(r.dev), x) for x in T.leaves(tree)]
            errs[what] = max(each)
            worst[what] = paths[each.index(errs[what])]
        out.update(one_card_loss0=float(loss1), one_card_grad_norm0=gnorm1, one_card_ms=one_ms,
                   one_card_drop_frac0=[float(d) for d in rec.drops], leaf_rel_err=errs,
                   worst_leaf=worst,
                   loss_rel_err=abs(loss0 - float(loss1)) / abs(float(loss1)),
                   grad_norm_rel_err=abs(gnorm0 - gnorm1) / gnorm1)
        del params, opt, kept
        r.free()
        if (out["loss_rel_err"] > LM_LOSS_TOL or out["grad_norm_rel_err"] > LM_LEAF_TOL
                or max(errs.values()) > LM_LEAF_TOL):
            fail(r, f"{cfg.name} on {shape}: step 0 against one card: {out}")
    r.dist.barrier()
    return out


def part_lm(r: Rank, name: str) -> dict:
    """Each of the part's runs (`LM_RUNS`); one run's numbers as they are."""
    outs = [lm_run(r, run) for run in LM_RUNS[name]]
    if len(outs) == 1:
        return outs[0]
    return {f"{o['config']} {tuple(o['mesh'])}": o for o in outs}


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


def part_deepfm(r: Rank, shape=None) -> dict:
    import torch
    from repro_torch.configs import deepfm as C
    from repro_torch.data.pipeline import ClickStream, shard_batch
    from repro_torch.dist import P, batch_spec, data_axes
    from repro_torch.hopper import embedding_bag as E
    from repro_torch.models.deepfm import DeepFM
    from repro_torch.train import adamw_init

    cfg, B = C.CONFIG, C.SHAPES["train_batch"]["batch"]
    n_bulk, n_cands = C.SHAPES["serve_bulk"]["batch"], C.RETRIEVAL_CANDIDATES
    if not r.cuda:
        cfg, B, n_bulk, n_cands = C.SMOKE_CONFIG, 64 * r.size, 128 * r.size, 512
    shape = shape or (r.size, 1)
    mesh = r.mesh(shape)
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
    # serving through the placed tables (the step-0 state): serve_bulk's
    # logits (this rank's block of the batch) and retrieval_cand's scores
    # (this rank's block of the candidates, over every rank)
    bulk = ClickStream(cfg.field_vocabs, n_bulk, seed=1).batch_at(0)[0]
    cands = torch.randint(0, cfg.field_vocabs[RETRIEVAL_FIELD], (n_cands,),
                          generator=torch.Generator().manual_seed(13), dtype=torch.int32)
    user = torch.from_numpy(bulk[0]).to(r.dev)
    flat = P(tuple(mesh.mesh_dim_names))
    bulk_placed = shard_batch(bulk, mesh, batch_spec(mesh, 1))
    cands_placed = shard_batch(cands, mesh, flat)
    logits, bulk_ms = r.ms(lambda: C.serve_step(model, bulk_placed, params=params1, mesh=mesh))
    scores, ret_ms = r.ms(lambda: C.retrieval_step(model, user, cands_placed, RETRIEVAL_FIELD,
                                                   params=params1, mesh=mesh))
    served = {"logits": logits.cpu(), "scores": scores.cpu()}
    del p, o, params, opt, params1, opt1, batches, logits, scores
    r.free()
    out = {"config": "CONFIG" if r.cuda else "SMOKE_CONFIG", "batch": B, "mesh": list(shape),
           "rows_card": rows, "rows": cfg.total_vocab, "loss0": loss0, "first_ms": first_ms,
           "step_ms": statistics.median(took), "steps_ms": took, "peak_gib": r.gather(peak),
           "launches_step0_rank": launches, "serve_bulk_ms": bulk_ms,
           "retrieval_cand_ms": ret_ms}
    # every rank's blocks, on rank 0
    blocks = r.gather((served, list(mesh.get_coordinate())))
    r.dist.barrier()
    if r.rank == 0:
        params = C.train_params(model)
        opt = adamw_init(params)
        fields, labels = (torch.from_numpy(a).to(r.dev) for a in stream.batch_at(0))
        p1, _, loss1 = C.train_step(model, params, opt, fields, labels)
        _, one_ms = r.ms(lambda: C.train_step(model, params, opt, fields, labels))   # warm
        err = max(float((full[k] - p1[k]).abs().max()) for k in p1)
        model.load_state_dict(p1, strict=False)
        want_logits = C.serve_step(model, torch.from_numpy(bulk).to(r.dev)).cpu()
        want_scores = C.retrieval_step(model, user, cands.to(r.dev), RETRIEVAL_FIELD).cpu()
        n, m = n_bulk // shape[0], n_cands // r.size
        serve_err = max(float((b["logits"] - want_logits[c[0] * n:(c[0] + 1) * n]).abs().max())
                        for b, c in blocks)
        ret_err = max(float((b["scores"] - want_scores[i * m:(i + 1) * m]).abs().max())
                      for i, (b, _) in enumerate(blocks))
        out.update(one_card_loss0=float(loss1), one_card_ms=one_ms, max_param_err=err,
                   loss_err=abs(loss0 - float(loss1)), serve_bulk_err=serve_err,
                   retrieval_cand_err=ret_err)
        if max(err, out["loss_err"], serve_err, ret_err) > DEEPFM_TOL:
            fail(r, f"deepfm: step 0, serve_bulk or retrieval_cand against one card: {out}")
        del p1, params, opt
    del full, model
    r.free()
    r.dist.barrier()
    return out


def part_deepfm_tp(r: Rank) -> dict:
    return part_deepfm(r, (2, r.size // 2))


def seeded_lm(cfg, dev, specs=None, mesh=None):
    """An LM tree at `cfg`'s widths drawn leaf by leaf, each leaf under its
    own key (seeded by its path) with `init_lm`'s kinds of values:
    with `specs` each rank keeps its block of each leaf as a DTensor and
    frees the whole leaf at once, so no rank ever holds the whole tree."""
    import zlib

    import torch
    from repro_torch.core import prng
    from repro_torch.dist.sharding import Sharding
    from repro_torch.models import transformer as tf

    tree = {}
    for path, shape, dt, init in tf._walk(tf._tree_spec(cfg)):
        if init == "ones":
            leaf = torch.ones(shape, dtype=dt, device=dev)
        elif init == "zeros":
            leaf = torch.zeros(shape, dtype=dt, device=dev)
        else:
            leaf = torch.empty(shape, dtype=dt, device=dev)
            prng.normal_into(prng.key(zlib.crc32("/".join(path).encode())), leaf, init)
        if specs is not None:
            node = specs
            for k in path:
                node = node[k]
            leaf = Sharding(mesh, node).place(leaf, dev)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def part_lm_fsdp(r: Rank) -> dict:
    """nemotron-4-340b at full width, its state on no one card, one step on
    each layout with FSDP; step 0's losses against each other and against
    one card's forward of `lm_loss` on rank 0."""
    import dataclasses

    import torch
    from repro_torch.configs import LM_ARCHS
    from repro_torch.configs import lm_cells as C
    from repro_torch.data.pipeline import TokenStream, shard_batch
    from repro_torch.dist import batch_spec
    from repro_torch.dist.sharding import _axis_size, data_axes, lm_param_specs
    from repro_torch.launch.train import small_variant
    from repro_torch.models import transformer as tf
    from repro_torch.train import tree as T
    from repro_torch.train.optimizer import OptConfig, adamw_init_placed, zero1_specs

    arch, layers, B, shapes = FSDP_RUN
    cfg = dataclasses.replace(LM_ARCHS[arch].CONFIG, n_layers=layers)
    S = LM_SEQ
    if not r.cuda:
        cfg, B, S = dataclasses.replace(small_variant(cfg), n_layers=layers), 4, 64
    shapes = [(1, r.size), (2, r.size // 2)] if r.size != 4 else list(shapes)
    tok, tgt = TokenStream(cfg.vocab, B, S, seed=17).batch_at(0)
    meta = T.tree_map(lambda x: torch.empty(x[0], dtype=x[1], device="meta"),
                      tf.param_shapes(cfg), is_leaf=lambda x: isinstance(x, tuple))
    n_params = sum(x.numel() for x in T.leaves(meta))
    out = {"config": cfg.name, "layers": layers, "params": n_params, "global_batch": B,
           "seq": S, "state_bytes_whole": sum(x.numel() * (x.element_size() + 8)
                                              for x in T.leaves(meta))}
    if r.rank == 0:         # one card's forward of the same weights, whole
        params = seeded_lm(cfg, r.dev)
        with torch.inference_mode():
            loss, _ = tf.lm_loss(params, cfg, torch.from_numpy(tok).to(r.dev),
                                 torch.from_numpy(tgt).to(r.dev))
        out["one_card_forward_loss"] = float(loss)
        del params
        r.free()
    r.dist.barrier()
    for shape in shapes:
        mesh = r.mesh(tuple(shape))
        specs = lm_param_specs(meta, mesh, fsdp=True)
        dp = data_axes(mesh)
        r.reset_peak()
        params = seeded_lm(cfg, r.dev, specs, mesh)
        opt = adamw_init_placed(params, zero1_specs(specs, meta, mesh_axis=dp,
                                                    mesh_size=_axis_size(mesh, dp)), mesh)
        state = (sum(x.to_local().numel() * x.to_local().element_size()
                     for x in T.leaves(params))
                 + sum(x.to_local().numel() * 4 for x in T.leaves((opt.m, opt.v))))
        step = C.make_lm_train_step(cfg, OptConfig(total_steps=10000), donate=True, mesh=mesh,
                                    fsdp=True)
        batch = shard_batch((tok, tgt), mesh, batch_spec(mesh, 1))
        r.aligned()
        (params, opt, loss, _), ms = r.ms(lambda: step(params, opt, *batch))
        peak = r.peak_gib()
        # NCCL's kernels in one more (profiled) step, as a share of the first's time
        r.aligned()
        (params, opt, _, _), step_nccl_ms = nccl_ms(r, lambda: step(params, opt, *batch))
        out[f"{tuple(shape)}"] = {"loss0": float(loss), "step_ms": ms,
                                  "step_nccl_ms": step_nccl_ms,
                                  "step_nccl_share": None if step_nccl_ms is None else
                                  step_nccl_ms / ms,
                                  "peak_gib": r.gather(peak),
                                  "state_bytes_card": r.gather(state)}
        del params, opt, batch
        r.free()
        r.dist.barrier()
    losses = [out[f"{tuple(s)}"]["loss0"] for s in shapes]
    errs = [abs(x - losses[0]) / abs(losses[0]) for x in losses[1:]]
    if "one_card_forward_loss" in out:
        one = out["one_card_forward_loss"]
        errs += [abs(x - one) / abs(one) for x in losses]
    out["loss_rel_errs"] = errs
    if max(errs) > FSDP_LOSS_TOL or not all(map(math.isfinite, losses)):
        fail(r, f"lm_fsdp: step 0's losses disagree: {out}")
    return out


def _decode(r: Rank, params, cfg, prompts, L: int, feed, mesh=None):
    """Prefill `prompts`, then one `serve_step` for each of `feed`'s tokens
    (or, with `feed` None, greedily): (the logits of the prefill and of
    each step, the tokens fed, each step's ms)."""
    import torch
    from repro_torch.configs import lm_cells as C

    logits, cache = C.prefill_step(params, cfg, prompts, max_len=L, mesh=mesh)
    out, toks, ms = [logits], [], []
    for i in range(DECODE["steps"]):
        tok = torch.argmax(logits, dim=-1).to(torch.int32) if feed is None else feed[i]
        toks.append(tok)
        (logits, cache), t = r.ms(lambda: C.serve_step(params, cfg, cache, tok, mesh=mesh))
        out.append(logits)
        ms.append(t)
    del cache
    return torch.stack(out), toks, ms


def cache_bytes(cfg, batch: int, length: int) -> int:
    """A whole decode cache's bytes (`transformer.init_decode_cache`)."""
    C = min(cfg.window, length) if cfg.window else length
    per_slot = ((cfg.mla.kv_lora_rank + cfg.mla.d_rope) if cfg.mla is not None
                else 2 * cfg.n_kv_heads * cfg.d_head)
    return cfg.n_layers * batch * C * per_slot * 2


def decode_run(r: Rank, arch: str) -> dict:
    """One arch's prefill and decode on (1, ranks) against rank 0's one card."""
    import dataclasses

    import torch
    from repro_torch.configs import LM_ARCHS
    from repro_torch.configs import lm_cells as C
    from repro_torch.core import prng
    from repro_torch.data.pipeline import TokenStream, shard_batch
    from repro_torch.dist import batch_spec, distribute, lm_param_specs
    from repro_torch.launch.train import small_variant
    from repro_torch.models import transformer as tf

    layers, dense_only = DECODE_RUNS[arch]
    full = LM_ARCHS[arch].CONFIG
    cfg = full
    if layers is not None:
        cfg = dataclasses.replace(full, n_layers=layers,
                                  n_dense_layers=layers if dense_only else full.n_dense_layers)
    B, P, L = DECODE["batch"], DECODE["prompt"], DECODE["cache"]
    if not r.cuda:
        cfg, P, L = small_variant(cfg), 16, 48
    mesh = r.mesh((1, r.size))
    prompts = torch.from_numpy(TokenStream(cfg.vocab, B, P, seed=17).batch_at(0)[0]).to(r.dev)
    whole = tf.init_lm(prng.key(0), cfg, device=r.dev)
    placed = distribute(whole, lm_param_specs(whole, mesh), mesh)
    feed = None
    if r.rank == 0:         # one card: greedy, then one prefill of every token fed
        want, feed, one_ms = _decode(r, whole, cfg, prompts, L, None)
        full_prompt = torch.cat([prompts, torch.stack(feed, dim=1)], dim=1)
        again, _ = C.prefill_step(whole, cfg, full_prompt, max_len=full_prompt.shape[1])
        spread = float((again - want[-1]).abs().max())
        margin = want.topk(2, dim=-1).values
        margin = (margin[..., 0] - margin[..., 1])
    whole = None
    r.free()
    feed = r.gather(None if feed is None else [t.cpu() for t in feed])[0]
    feed = [t.to(r.dev) for t in feed]
    r.reset_peak()
    r.aligned()
    got, _, ms = _decode(r, placed, cfg, shard_batch(prompts, mesh, batch_spec(mesh, 1)), L,
                         feed, mesh=mesh)
    peak = r.peak_gib()
    out = {"config": cfg.name, "layers": cfg.n_layers, "batch": B, "prompt": P, "cache": L,
           "cache_bytes_whole": cache_bytes(cfg, B, L), "step_ms": statistics.median(ms),
           "steps_ms": ms,
           "peak_gib": r.gather(peak)}
    if r.rank == 0:
        tol = 2 * spread
        err = float((got - want).abs().max())
        sure = margin > tol
        same = bool((got.argmax(-1) == want.argmax(-1))[sure].all())
        out.update(one_card_step_ms=statistics.median(one_ms), spread=spread, tol=tol,
                   max_logit_err=err, greedy_checked=int(sure.sum()), greedy_equal=same)
        if not err <= tol or not same:
            fail(r, f"decode_tp {arch}: against one card: {out}")
    del placed, got
    r.free()
    r.dist.barrier()
    return out


def part_decode_tp(r: Rank) -> dict:
    return {arch: decode_run(r, arch) for arch in DECODE_RUNS}


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


class GNNNorms:
    """While open, records the `grad_norm` (taken before clipping) of every
    AdamW update the GNN steps make, placed or not."""

    def __enter__(self):
        from repro_torch.configs import gnn_cells
        from repro_torch.train import optimizer

        self.names = [(gnn_cells, "adamw_update"), (optimizer, "adamw_update_placed")]
        self.orig = [getattr(mod, name) for mod, name in self.names]
        self.grad_norms = []

        def wrap(fn):
            def recording(*args, **kw):
                out = fn(*args, **kw)
                self.grad_norms.append(float(out[2]["grad_norm"]))
                return out
            return recording

        for (mod, name), fn in zip(self.names, self.orig):
            setattr(mod, name, wrap(fn))
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.names, self.orig):
            setattr(mod, name, fn)


def products_graph(r: Rank, fraction: float):
    """ogb_products' stand-in at `fraction` of its vertices (the vertex
    count cut to CPU sizes on the CPU), drawn whole on every rank: (n,
    host edges, feats, coords, labels on this rank's device)."""
    from repro_torch.configs import gnn_cells as C

    n = C.products_nodes(fraction) if r.cuda else max(int(fraction * GNN_CPU_NODES), 8 * r.size)
    s, rcv, m, *rows = C.products_inputs(n, seed=GNN_SEED, device=r.dev)
    return n, (s, rcv, m), rows


def gnn_model(r: Rank, arch: str):
    from repro_torch.configs import GNN_ARCHS
    from repro_torch.configs import gnn_cells as C

    shape = C.GNN_SHAPES["ogb_products"]
    return GNN_ARCHS[arch].init(shape["d_feat"], shape["n_out"], seed=GNN_SEED, device=r.dev)


def gnn_groups(loss, opt, grad_norm: float) -> dict:
    """One step's loss, gradient norm and each leaf of m and sqrt(v) (v
    holds the gradient's squares), whole, on the host."""
    from repro_torch.dist.sharding import local

    return {"loss": float(loss), "grad_norm": grad_norm,
            "m": {k: local(x).float().cpu() for k, x in opt.m.items()},
            "v": {k: local(x).float().sqrt().cpu() for k, x in opt.v.items()}}


def gnn_errs(got: dict, want: dict) -> tuple:
    """(errors, worst leaves): the relative errors of the loss and gradient
    norm; for m and v the largest over the leaves of ||got - want|| /
    ||want|| (`leaf_err`), and which leaf it is."""
    out = {k: abs(got[k] - want[k]) / abs(want[k]) for k in ("loss", "grad_norm")}
    worst = {}
    for k in ("m", "v"):
        each = {leaf: leaf_err(got[k][leaf], want[k][leaf]) for leaf in want[k]}
        worst[k] = max(each, key=each.get)
        out[k] = each[worst[k]]
    return out, worst


def products_steps(r: Rank, arch: str, split, rows, mesh, steps: int) -> dict:
    """`steps` placed steps of `arch` on `split` (re-pointed at `mesh`) from
    a fresh state, every rank aligned before each (CUDA events), then one
    profiled step: the losses, step ms, NCCL's device ms in the profiled
    step and each card's peak GiB."""
    import dataclasses

    from repro_torch.configs import GNN_ARCHS
    from repro_torch.configs import gnn_cells as C

    a = GNN_ARCHS[arch]
    split = dataclasses.replace(split, mesh=mesh)
    model = gnn_model(r, arch)
    params, opt = C.place_gnn_state(C.train_params(model), mesh)
    r.reset_peak()
    losses, took = [], []
    for _ in range(steps):
        r.aligned()
        (params, opt, loss), ms = r.ms(lambda: C.full_graph_step(
            a, model, params, opt, *rows[:2], *split.edges, rows[2], split=split))
        losses.append(float(loss))
        took.append(ms)
    peak = r.peak_gib()
    r.aligned()
    (params, opt, loss), step_nccl_ms = nccl_ms(r, lambda: C.full_graph_step(
        a, model, params, opt, *rows[:2], *split.edges, rows[2], split=split))
    timed = took[1:] or took
    del params, opt, model
    r.free()
    return {"mesh": list(mesh.shape), "losses": losses, "first_ms": took[0],
            "step_ms": statistics.median(timed), "steps_ms": took, "step_nccl_ms": step_nccl_ms,
            "step_nccl_share": None if step_nccl_ms is None else
            step_nccl_ms / statistics.median(timed), "peak_gib": r.gather(peak),
            "edges_card": r.gather(int(split.senders.numel()))}


def chunked_gin_loss(r: Rank, edges, rows) -> float:
    """gin-tu's step-0 loss on one card under no_grad, the whole graph, its
    edges summed into each layer's aggregate CHUNK_EDGES at a time (the
    same model, seed and function as the step's forward)."""
    import torch
    from repro_torch.configs import gnn_cells as C

    model = gnn_model(r, "gin-tu")
    s, rcv, m = edges
    feats, _, labels = rows
    with torch.no_grad():
        h = feats
        for layer in model.layers:
            agg = torch.zeros_like(h)
            for lo in range(0, s.shape[0], CHUNK_EDGES):
                sl = slice(lo, lo + CHUNK_EDGES)
                msg = torch.where(m[sl].to(r.dev)[:, None], h[s[sl].to(r.dev).long()], 0)
                agg.index_add_(0, rcv[sl].to(r.dev).long(), msg)
                del msg
            h = layer.mlp((1.0 + layer.eps) * h + agg)
            del agg
        loss = C._xent(model.head(h), labels)
    return float(loss)


def relabelled(edges, rows, seed: int) -> list:
    """The full-graph step's inputs (feats, coords, senders, receivers,
    mask, labels) on the same graph with its vertices and its edges in
    another order (permutations seeded with `seed`): the same loss and
    gradients in exact arithmetic, summed in another order."""
    import torch

    s, rcv, m = edges
    n = rows[0].shape[0]
    gen = torch.Generator().manual_seed(seed)
    order = torch.randperm(n, generator=gen).to(s.device)          # new row i: old order[i]
    new_id = torch.empty_like(order)
    new_id[order] = torch.arange(n, device=s.device)
    e_order = torch.randperm(s.shape[0], generator=gen).to(s.device)
    feats, coords, labels = (x[order] for x in rows)
    return [feats, coords, new_id[s[e_order].long()].to(s.dtype),
            new_id[rcv[e_order].long()].to(rcv.dtype), m[e_order], labels]


def products_vs_one_card(r: Rank, arch: str, fraction: float, mesh) -> dict:
    """One placed step of `arch` on (ranks, 1) at `fraction` against rank
    0's one-card step on the same stand-in from the same state; then that
    step again on the graph relabelled with each of SPREAD_SEEDS
    (`relabelled`) and, on the card, once with its GEMMs on cuBLASLt: the
    largest difference of those runs from the first is one card's
    run-to-run spread, that of the order it sums in, over edges (its float
    atomics), over vertices and within each GEMM (the kernel cuBLAS picks),
    which is what the split changes too: a card's GEMMs run on its quarter
    of the rows, where cuBLAS picks other kernels.  The loss, the gradient
    norm and every leaf of m and sqrt(v), each group within twice the
    spread (no less than twice SPREAD_FLOOR)."""
    import torch
    from repro_torch.configs import GNN_ARCHS
    from repro_torch.configs import gnn_cells as C
    from repro_torch.dist.graph import split_graph
    from repro_torch.train import adamw_init

    a = GNN_ARCHS[arch]
    n, edges, rows = products_graph(r, fraction)
    split = split_graph(*edges, n, mesh)
    local_rows = [split.rows(x) for x in rows]
    model = gnn_model(r, arch)
    params, opt = C.place_gnn_state(C.train_params(model), mesh)
    r.aligned()
    with GNNNorms() as rec:
        (params, opt, loss), ms = r.ms(lambda: C.full_graph_step(
            a, model, params, opt, *local_rows[:2], *split.edges, local_rows[2], split=split))
        got = gnn_groups(loss, opt, rec.grad_norms[-1])
    out = {"vertices": n, "half_edges": int(edges[0].shape[0]), "placed_ms": ms}
    del params, opt, local_rows, split
    r.free()
    r.dist.barrier()
    if r.rank == 0:
        e = [x.to(r.dev) for x in edges]
        params = C.train_params(model)
        runs, one_ms = [], []
        # the first run, then the spread's: relabelled, and on the other BLAS
        # library (the card's only; its GEMMs pick other kernels)
        variants = [("first", None)] + [(f"relabelled {k}", k) for k in SPREAD_SEEDS]
        if r.cuda:
            variants.append(("cuBLASLt", None))
        with GNNNorms() as rec:
            for name, seed in variants:
                inputs = ([*rows[:2], *e, rows[2]] if seed is None
                          else relabelled(e, rows, seed))
                blas = torch.backends.cuda.preferred_blas_library() if r.cuda else None
                if name == "cuBLASLt":
                    torch.backends.cuda.preferred_blas_library("cublaslt")
                try:
                    (_, o, loss), ms = r.ms(lambda: C.full_graph_step(
                        a, model, params, adamw_init(params), *inputs))
                finally:
                    if blas is not None:
                        torch.backends.cuda.preferred_blas_library(blas)
                runs.append(gnn_groups(loss, o, rec.grad_norms[-1]))
                one_ms.append(ms)
                del o, inputs
        spreads = {name: gnn_errs(x, runs[0])[0]
                   for (name, _), x in zip(variants[1:], runs[1:])}
        spread = {k: max(x[k] for x in spreads.values()) for k in ("loss", "grad_norm", "m", "v")}
        errs, worst = gnn_errs(got, runs[0])
        tol = {k: 2 * max(v, SPREAD_FLOOR) for k, v in spread.items()}
        out.update(one_card_ms=one_ms, spread=spread, spreads=spreads, errs=errs,
                   worst_leaf=worst, tol=tol, loss=got["loss"], one_card_loss=runs[0]["loss"])
        if any(errs[k] > tol[k] for k in errs):
            fail(r, f"gnn_products {arch} at {fraction}: four cards against one: {out}")
        del e, runs, params
    del model, rows, edges
    r.free()
    r.dist.barrier()
    return out


def part_gnn_products(r: Rank) -> dict:
    """ogb_products (see the module docstring, (j))."""
    from repro_torch.dist.graph import split_graph

    out = {}
    arch, fraction, shapes = GNN_WHOLE
    if r.size != 4:
        shapes = ((r.size, 1), (2, r.size // 2))
    # one mesh a layout for the whole part: each new DeviceMesh brings new
    # NCCL communicators, whose buffers stay on the card
    meshes = {shape: r.mesh(tuple(shape)) for shape in shapes}
    flat = meshes[shapes[0]]
    n, edges, rows = products_graph(r, fraction)
    split = split_graph(*edges, n, flat)
    local_rows = [split.rows(x) for x in rows]
    runs = {}
    for shape, mesh in meshes.items():
        runs[f"{tuple(shape)}"] = products_steps(r, arch, split, local_rows, mesh, GNN_STEPS)
    del split, local_rows
    r.free()
    whole = {"vertices": n, "half_edges": int(edges[0].shape[0]), **runs}
    r.dist.barrier()
    if r.rank == 0:
        one = chunked_gin_loss(r, edges, rows)
        whole["one_card_forward_loss0"] = one
        whole["loss0_rel_errs"] = [abs(v["losses"][0] - one) / abs(one) for v in runs.values()]
        bad = [k for k, v in runs.items()
               if not (all(map(math.isfinite, v["losses"])) and v["losses"][-1] < v["losses"][0])]
        if bad or max(whole["loss0_rel_errs"]) > GNN_LOSS_TOL:
            fail(r, f"gnn_products {arch} whole: losses not falling on {bad}, or step 0 against "
                    f"the chunked one-card forward: {whole}")
    del edges, rows
    r.free()
    r.dist.barrier()
    out[f"{arch} whole"] = whole
    said(r, f"{arch} whole", whole)
    for arch, fraction in PRODUCTS_4.items():
        n, edges, rows = products_graph(r, fraction)
        split = split_graph(*edges, n, flat)
        local_rows = [split.rows(x) for x in rows]
        del edges, rows
        run = products_steps(r, arch, split, local_rows, flat, GNN_STEPS)
        if not all(map(math.isfinite, run["losses"])):
            fail(r, f"gnn_products {arch} at {fraction}: losses {run['losses']}")
        out[f"{arch} 1/{round(1 / fraction)}"] = {"vertices": n, **run}
        said(r, f"{arch} 1/{round(1 / fraction)}", out[f"{arch} 1/{round(1 / fraction)}"])
        del split, local_rows
        r.free()
        r.dist.barrier()
    for arch, fraction in PRODUCTS_1.items():
        key = f"{arch} 1/{round(1 / fraction)} vs one card"
        out[key] = products_vs_one_card(r, arch, fraction, flat)
        said(r, key, out[key])
    return out


def said(r: Rank, key: str, run: dict, part: str = "gnn_products") -> None:
    """Rank 0 prints a run's numbers as soon as it ends."""
    if r.rank == 0:
        print(f"[{part}] {key} {json.dumps(run)}", flush=True)


def minibatch_inputs(r: Rank):
    """minibatch_lg's stand-in, the same on every rank: (shape, indptr,
    indices, feats, coords, labels on this rank's device, host seconds to
    draw the graph)."""
    import torch
    from repro_torch.configs import gnn_cells as C
    from repro_torch.graphs.generators import erdos_renyi
    from repro_torch.graphs.sampler import NeighborSampler

    shape = dict(C.GNN_SHAPES["minibatch_lg"])
    avg_deg = shape["n_edges"] / shape["n_nodes"]
    if not r.cuda:
        shape.update(n_nodes=MINI_CPU_NODES, batch_nodes=MINI_CPU_BATCH)
    t0 = time.perf_counter()
    g = erdos_renyi(shape["n_nodes"], avg_deg=avg_deg, seed=GNN_SEED, device=r.dev)
    host_s = time.perf_counter() - t0
    sampler = NeighborSampler(g, shape["fanout"])
    del g
    n = sampler.indptr.numel() - 1
    gen = torch.Generator(device=r.dev).manual_seed(GNN_SEED)
    feats = torch.randn((n, shape["d_feat"]), generator=gen, device=r.dev)
    coords = torch.randn((n, 3), generator=gen, device=r.dev)
    labels = torch.randint(0, shape["n_out"], (n,), generator=gen, device=r.dev,
                           dtype=torch.int32)
    return shape, sampler.indptr, sampler.indices, feats, coords, labels, host_s


def minibatch_batches(r: Rank, shape: dict, n: int, dp: int, coord: int) -> list:
    """MINI_STEPS global batches (seeds and draws, the same on every rank),
    each cut to this rank's block of the batch ranks."""
    import torch
    from repro_torch.configs.gnn_cells import minibatch_draws
    from repro_torch.core import prng

    out = []
    for i in range(MINI_STEPS):
        gen = torch.Generator(device=r.dev).manual_seed(GNN_SEED + 1000 + i)
        B = shape["batch_nodes"]
        seeds = torch.randperm(n, generator=gen, device=r.dev)[:B].to(torch.int32)
        u = minibatch_draws(prng.fold_in(prng.key(GNN_SEED), 1000 + i), B, shape["fanout"],
                            r.dev)
        out.append((tuple(x.chunk(dp)[coord] for x in u), seeds.chunk(dp)[coord]))
    return out


def deterministic_algorithms(r: Rank, on: bool) -> None:
    """torch's deterministic algorithms on or off (warn-only: an op that
    has none warns).  On the card `index_add_`, `index_put_(accumulate=
    True)` and `scatter_add_` then sum in one order, not by float atomics,
    so two runs of one step give the same bits."""
    r.torch.use_deterministic_algorithms(on, warn_only=on)


def minibatch_run(r: Rank, shape: dict, mesh, indptr, tabs, tables) -> dict:
    """MINI_STEPS steps of gin-tu from a fresh state on `tabs` (whole, or
    this rank's blocks with `tables`) under deterministic algorithms: each
    step's loss and the final leaves on the host.  Then, in torch's
    default mode, the same batches again from that state: the median ms of
    the steps after the first, this rank's peak GiB over them, and the
    lookup alone (the tree and its rows, median of MINI_STEPS)."""
    from repro_torch.configs import GNN_ARCHS
    from repro_torch.configs import gnn_cells as C
    from repro_torch.dist.sharding import local

    a = GNN_ARCHS["gin-tu"]
    dp = mesh.size(0)
    batches = minibatch_batches(r, shape, indptr.numel() - 1, dp, mesh.get_coordinate()[0])
    model = a.init(shape["d_feat"], shape["n_out"], seed=GNN_SEED, device=r.dev)
    params, opt = C.place_gnn_state(C.train_params(model), mesh)

    def step(params, opt, draws, seeds):
        return C.minibatch_step(a, model, params, opt, draws, indptr, *tabs, seeds, mesh=mesh,
                                tables=tables)

    deterministic_algorithms(r, True)
    try:
        losses = []
        for draws, seeds in batches:
            params, opt, loss = step(params, opt, draws, seeds)
            losses.append(loss.cpu())
    finally:
        deterministic_algorithms(r, False)
    leaves = {f"p/{k}": local(v).cpu() for k, v in params.items()}
    leaves.update({f"m/{k}": local(v).cpu() for k, v in opt.m.items()})
    leaves.update({f"v/{k}": local(v).cpu() for k, v in opt.v.items()})
    r.reset_peak()
    took, lookup = [], []
    for draws, seeds in batches:
        r.aligned()
        (params, opt, _), ms = r.ms(lambda: step(params, opt, draws, seeds))
        took.append(ms)
    peak = r.peak_gib()
    for draws, seeds in batches:
        r.aligned()
        _, ms = r.ms(lambda: C.minibatch_rows(
            C.minibatch_tree(indptr, tabs[0], seeds, draws, tables), *tabs[1:], seeds, tables))
        lookup.append(ms)
    del params, opt, model
    r.free()
    return {"losses": losses, "leaves": leaves, "step_ms": statistics.median(took[1:]),
            "steps_ms": took, "lookup_ms": statistics.median(lookup), "peak_gib": peak,
            "tables_bytes": sum(x.numel() * x.element_size() for x in tabs)}


def part_gnn_minibatch(r: Rank) -> dict:
    """minibatch_lg's tables split over the ranks (see the module
    docstring, (k))."""
    import torch
    from repro_torch.dist.lookup import TableSplit

    def same(x, y):
        view = {torch.float32: torch.int32, torch.float64: torch.int64}
        return x.shape == y.shape and x.dtype == y.dtype and torch.equal(
            x.view(view.get(x.dtype, x.dtype)), y.view(view.get(y.dtype, y.dtype)))

    shapes = ((r.size, 1), (2, r.size // 2))
    meshes = {shape: r.mesh(tuple(shape)) for shape in shapes}
    shape, indptr, *whole, host_s = minibatch_inputs(r)
    replicated = {k: minibatch_run(r, shape, mesh, indptr, whole, None)
                  for k, mesh in meshes.items()}
    tables = {k: TableSplit.of(mesh) for k, mesh in meshes.items()}
    blocks = tables[shapes[0]].block
    blocks = [blocks(x) for x in whole]       # the flat group's blocks: the same on every mesh
    del whole
    r.free()
    out = {"vertices": int(indptr.numel() - 1), "half_edges": int(indptr[-1]),
           "batch": shape["batch_nodes"], "fanout": list(shape["fanout"]),
           "graph_host_s": host_s}
    for k, mesh in meshes.items():
        split = minibatch_run(r, shape, mesh, indptr, blocks, tables[k])
        rep = replicated[k]
        differ = sorted(n for n in rep["leaves"] if not same(rep["leaves"][n], split["leaves"][n]))
        losses_equal = all(same(x, y) for x, y in zip(rep["losses"], split["losses"]))
        run = {"losses": [float(x) for x in split["losses"]], "losses_equal": losses_equal,
               "leaves": len(rep["leaves"]), "leaves_differ": differ}
        for name, res in (("replicated", rep), ("split", split)):
            run[name] = {key: r.gather(res[key]) for key in
                         ("step_ms", "lookup_ms", "peak_gib", "tables_bytes")}
            run[name]["steps_ms_rank0"] = res["steps_ms"]
        if differ or not losses_equal:
            fail(r, f"gnn_minibatch {k}: the split step differs from the replicated step: "
                    f"losses equal {losses_equal}, leaves {differ}")
        out[f"{k}"] = run
        said(r, f"gin-tu {k}", {**run, **{x: out[x] for x in ("vertices", "half_edges")}},
             "gnn_minibatch")
        r.dist.barrier()
    del blocks
    r.free()
    return out


PARTS = {"lm": lambda r: part_lm(r, "lm"), "lm_moe": lambda r: part_lm(r, "lm_moe"),
         "deepfm": part_deepfm, "moe": part_moe, "ckpt": part_ckpt,
         "lm_tp": lambda r: part_lm(r, "lm_tp"), "lm_tp_moe": lambda r: part_lm(r, "lm_tp_moe"),
         "lm_fsdp": part_lm_fsdp, "decode_tp": part_decode_tp, "deepfm_tp": part_deepfm_tp,
         "gnn_products": part_gnn_products, "gnn_minibatch": part_gnn_minibatch}


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
        out["failures"] = r.failures
        line = json.dumps(out)
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "sharded_train_ranks.json").write_text(line + "\n")
        print(line, flush=True)
    if r.failures:
        sys.exit(1)


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
    # the one-card comparisons run beside NCCL's buffers: deepseek's dense
    # layers peak at 70.9 GiB alone, so the allocator must not strand
    # reserved blocks
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env) for r in range(args.ranks)]
    deadline = time.monotonic() + args.timeout
    rc = 0
    try:
        # a rank that fails stops the run at once: the others would wait
        # for it in their next collective
        while True:
            codes = [p.poll() for p in procs]
            rc = next((c for c in codes if c), 0)
            if rc or all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                print(f"FAIL: a rank ran past {args.timeout} s", file=sys.stderr)
                rc = 1
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    sys.exit(rc)


if __name__ == "__main__":
    main()
