"""The LM family's cells (counterpart of the LM part of
`repro.configs.common`): the assigned shapes, the analytic FLOP counts,
the train cell's step (`make_lm_train_step`), the two serve steps the
reference's prefill and decode cells lower, and `lm_smoke`, which each
arch module's `smoke` runs.

On a `DeviceMesh` (`mesh=`) of one batch axis and 'model' the steps run
the layouts the reference's cells give: the train step placed as its
train cell places it (`place_lm_state`): parameters by `lm_param_specs`
(tensor-parallel over 'model', FSDP over the batch axes when the caller
asks: the reference's `_needs_fsdp` is a rule for a 16 GB TPU and stays
out), AdamW moments by `zero1_specs` of those specs over the data axes,
tokens and targets by `batch_spec(mesh, 1)` (`data.pipeline.shard_batch`);
prefill and decode with the cache placed by `cache_specs`
(`place_decode_cache`).  Each computes the function of the step without
a mesh.  Left out, as `gnn_cells` leaves them out: the `Cell` / `ArchDef` registry
and the dry-run machinery (`_dryrun_cfg`, `_with_stack_layers`, the cost
passes' unrolled variants).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core import prng
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.lm_config import LMConfig
from repro_torch.train import tree as T
from repro_torch.train.optimizer import (
    OptConfig,
    adamw_init,
    adamw_init_placed,
    adamw_update,
    adamw_update_placed,
    partial_grads,
    zero1_specs,
)

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


def lm_loss_and_grads(params, cfg: LMConfig, tokens: torch.Tensor, targets: torch.Tensor,
                      dp=None, tp=None, fsdp=None):
    """`transformer.lm_loss` and its gradient with respect to every leaf
    of `params`: (loss, metrics, grads); a leaf the loss does not reach
    gets zeros, as `jax.value_and_grad` gives.  With `dp` (a
    `dist.collectives.DataGroup`), this rank's parts of them; with `tp` /
    `fsdp`, of its blocks of the leaves (`transformer.lm_loss`)."""
    leaves, spec = T.flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        kw = {k: v for k, v in (("dp", dp), ("tp", tp), ("fsdp", fsdp)) if v is not None}
        loss, metrics = tf.lm_loss(T.unflatten(spec, leaves), cfg, tokens, targets, **kw)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            T.unflatten(spec, grads))


_STACKS = ("dense_layers", "moe_layers")


class LayerGather:
    """FSDP's gathers for the transformer (`fsdp=`): each leaf of a placed
    tree is gathered over the batch ranks, along the dim that
    `lm_param_specs(fsdp=True)` shards (`dist.sharding.fsdp_dim`), back to
    its block over 'model'; the gradient of the gathered leaf is
    reduce-scattered back (`DataGroup.gather_leaf`).  `top` gathers the
    leaves outside the layer stacks, `layer` one layer of a stack."""

    def __init__(self, params, mesh, dp):
        from repro_torch.dist.sharding import fsdp_dim, lm_param_specs

        self.dp, self.dims = dp, {}

        def note(path, spec, p):
            self.dims[path] = fsdp_dim(spec, p.shape, dp.size)
            return spec

        T.tree_map_with_path(note, lm_param_specs(params, mesh), params)

    def _gather(self, x, dim):
        return x if dim is None else self.dp.gather_leaf(x, dim)

    def top(self, params):
        return {k: v if k in _STACKS else T.tree_map_with_path(
                    lambda path, x, k=k: self._gather(x, self.dims[(k,) + path]), v)
                for k, v in params.items()}

    def layer(self, name: str, stack, i: int):
        def take(path, x):
            dim = self.dims[(name,) + path]
            if dim == 0:                # the stack's own dim: gather it, then the layer
                return self._gather(x, 0)[i]
            return self._gather(x[i], None if dim is None else dim - 1)

        return T.tree_map_with_path(take, stack)


def make_lm_train_step(cfg: LMConfig, opt_cfg: OptConfig, *, donate: bool = False,
                       mesh=None, fsdp: bool = False):
    """The train cell's step: (params, opt_state, tokens, targets) ->
    (params, opt_state, loss, xent), the loss's gradient through autograd
    and one AdamW update.  With `donate` the step writes the new state
    into the one it is given (`adamw_update(in_place=True)`), as a jitted
    step that donates its state: one copy of the state, not two.

    With `mesh` (a `DeviceMesh` of one batch axis larger than 1, or none,
    and a 'model' axis of any size) the same function runs over the state
    `place_lm_state` placed (with `fsdp` as it was placed) and the batch
    `shard_batch` placed: each batch rank takes its part of the loss of
    the global batch (`transformer.lm_loss(dp=)`), each model rank its
    blocks of the leaves (`tp=`: heads, hidden units, experts and vocab
    split over 'model', the layer carry this rank's block of the
    sequence where it splits, an all-gather into each parallel block and a
    reduce-scatter out of it, so a leaf replicated over 'model' gets the
    same gradient on every model rank), and with `fsdp` each layer's
    leaves gathered over the batch ranks as it runs (`LayerGather`);
    `adamw_update_placed` reduce-scatters the gradients to the ZeRO-1
    moments and gathers the parameters back; the loss and xent returned
    are the global batch's, on every rank.  Every collective runs on a
    one-rank mesh too, where the step is the step without a mesh."""
    if mesh is None:
        def train_step(params, opt_state, tokens, targets):
            loss, metrics, grads = lm_loss_and_grads(params, cfg, tokens, targets)
            params, opt_state, _ = adamw_update(opt_cfg, grads, opt_state, params,
                                                in_place=donate)
            return params, opt_state, loss, metrics["xent"]

        return train_step

    from repro_torch.dist.collectives import data_group
    from repro_torch.dist.sharding import data_axes, local

    dp, tp = data_group(mesh, "the LM train step")
    batch_axes = set(data_axes(mesh))

    def placed_step(params, opt_state, tokens, targets):
        gather = LayerGather(params, mesh, dp) if fsdp else None
        loss, metrics, grads = lm_loss_and_grads(T.tree_map(local, params), cfg,
                                                 local(tokens), local(targets), dp=dp, tp=tp,
                                                 fsdp=gather)
        grads = partial_grads(grads, params, mesh, batch_axes)
        params, opt_state, _ = adamw_update_placed(opt_cfg, grads, opt_state, params,
                                                   in_place=donate)
        return params, opt_state, dp.all_reduce(loss), dp.all_reduce(metrics["xent"])

    return placed_step


def place_lm_state(params, mesh, *, fsdp: bool = False):
    """An LM's parameters (whole, the same on every rank) placed on `mesh` as
    the reference's train cell places them (`lm_param_specs(fsdp=)`), and
    zero AdamW moments under `zero1_specs` of those specs over the data
    axes: (params, opt_state) of DTensors."""
    from repro_torch.dist.sharding import (
        _axis_size,
        data_axes,
        distribute,
        lm_param_specs,
    )

    specs = lm_param_specs(params, mesh, fsdp=fsdp)
    dp = data_axes(mesh)
    placed = distribute(params, specs, mesh)
    moments = zero1_specs(specs, params, mesh_axis=dp, mesh_size=_axis_size(mesh, dp))
    return placed, adamw_init_placed(placed, moments, mesh)


def place_decode_cache(cache: tf.DecodeCache, cfg: LMConfig, mesh) -> tf.DecodeCache:
    """A whole decode cache (the same on every rank) placed by
    `cache_specs`: its buffers DTensors, each rank keeping its block of
    the batch and of the KV heads; `pos` as it is."""
    from repro_torch.dist.sharding import cache_specs, distribute

    batch = next(iter(cache.data.values())).shape[1]
    specs = cache_specs(cfg, mesh, batch, cache.length)
    return tf.DecodeCache(data=distribute(cache.data, specs.data, mesh), pos=cache.pos,
                          length=cache.length)


def _placed_cache(cache: tf.DecodeCache, cfg: LMConfig, mesh, batch: int) -> tf.DecodeCache:
    """This rank's blocks of a cache of `batch` sequences, as DTensors under
    `cache_specs`."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import Sharding, _strides, cache_specs

    specs = cache_specs(cfg, mesh, batch, cache.length)
    data = {}
    for k, block in cache.data.items():
        sh = Sharding(mesh, specs.data[k])
        shape = list(block.shape)
        shape[1] = batch
        if k in ("k", "v"):
            shape[3] = cfg.n_kv_heads
        data[k] = DTensor.from_local(block, mesh, sh.placements, run_check=False,
                                     shape=torch.Size(shape), stride=_strides(shape))
    return tf.DecodeCache(data=data, pos=cache.pos, length=cache.length)


def _serving(params, mesh, what: str, fsdp: bool, batch_split: bool):
    """(local params, keywords for `transformer.prefill` / `decode_step`) of
    a serve step on `mesh`: `dp` only where the batch is split over the
    batch ranks (an MoE layer then routes by the global batch)."""
    from repro_torch.dist.collectives import data_group
    from repro_torch.dist.sharding import local

    dp, tp = data_group(mesh, what)
    kw = {"tp": tp, "dp": dp if batch_split else None,
          "fsdp": LayerGather(params, mesh, dp) if fsdp else None}
    return T.tree_map(local, params), kw


def _split_over_data(x, mesh, dim: int = 0) -> bool:
    """Whether DTensor x's `dim` is sharded over the batch axes."""
    from torch.distributed.tensor import Shard

    from repro_torch.dist.sharding import data_axes

    names = mesh.mesh_dim_names
    return any(isinstance(q, Shard) and q.dim == dim and names[i] in data_axes(mesh)
               for i, q in enumerate(x.placements))


def prefill_step(params, cfg: LMConfig, tokens: torch.Tensor,
                 max_len: Optional[int] = None, *, mesh=None, fsdp: bool = False):
    """The prefill cell's step: (last logits, cache).  The cell sizes the
    cache to the prompt (`max_len` None); a server prefilling ahead of
    decode passes its cache length.

    With `mesh`: `params` placed by `lm_param_specs(fsdp=)` and `tokens`
    a DTensor (`shard_batch` under `batch_spec(mesh, 1)`, or P() for a
    batch that does not split); the logits are this rank's sequences,
    whole over the vocab, and the cache is placed by `cache_specs`."""
    S = tokens.shape[1]
    if mesh is None:
        return tf.prefill(params, cfg, tokens, max_len=max_len or S)
    from repro_torch.dist.sharding import local

    p, kw = _serving(params, mesh, "the LM prefill step", fsdp, _split_over_data(tokens, mesh))
    logits, cache = tf.prefill(p, cfg, local(tokens), max_len or S, **kw)
    return logits, _placed_cache(cache, cfg, mesh, tokens.shape[0])


def serve_step(params, cfg: LMConfig, cache: tf.DecodeCache, tokens: torch.Tensor,
               *, mesh=None, fsdp: bool = False):
    """The decode cell's step: one token per sequence against the cache,
    which it consumes (`transformer.decode_step`).

    With `mesh`: `params` as `prefill_step`'s, `cache` placed by
    `cache_specs` (`prefill_step(mesh=)` or `place_decode_cache`) and
    `tokens` a DTensor or this rank's block of them (its sequences of the
    cache); returns this rank's logits, whole over the vocab, and the
    placed cache at pos + 1."""
    if mesh is None:
        return tf.decode_step(params, cfg, cache, tokens)
    from repro_torch.dist.sharding import local

    first = next(iter(cache.data.values()))
    p, kw = _serving(params, mesh, "the LM decode step", fsdp,
                     _split_over_data(first, mesh, dim=1))
    blocks = tf.DecodeCache(data={k: local(v) for k, v in cache.data.items()}, pos=cache.pos,
                            length=cache.length)
    logits, after = tf.decode_step(p, cfg, blocks, local(tokens), **kw)
    return logits, tf.DecodeCache(data=cache.data, pos=after.pos, length=cache.length)


def smoke_inputs(cfg_small: LMConfig, device) -> Tuple[tf.Params, torch.Tensor]:
    """`lm_smoke`'s weights `init_lm(key(0))` and (2, 32) tokens
    `randint(key(1), (2, 32), 0, vocab)`, the reference's."""
    return (tf.init_lm(prng.key(0), cfg_small, device=device),
            prng.randint(prng.key(1), (2, 32), 0, cfg_small.vocab, device))


def lm_smoke(cfg_small: LMConfig, device: DeviceLike = "cuda") -> None:
    """One train step on a reduced config, then a prefill and a decode step
    of the updated weights; raises unless the loss and the last logits are
    finite and the tree and the logits keep their shapes."""
    dev = resolve_device(device)
    params, tokens = smoke_inputs(cfg_small, dev)
    opt = adamw_init(params)
    B, S = tokens.shape
    targets = torch.roll(tokens, -1, dims=1)
    step = make_lm_train_step(cfg_small, OptConfig(total_steps=100))
    params2, _, loss, _ = step(params, opt, tokens, targets)
    if not math.isfinite(float(loss)):
        raise AssertionError(f"{cfg_small.name} smoke loss not finite: {float(loss)}")
    if T.flatten(params2)[1] != T.flatten(params)[1]:
        raise AssertionError(f"{cfg_small.name} smoke: the step changed the tree")
    _, cache = tf.prefill(params2, cfg_small, tokens, max_len=S + 4)
    logits, _ = tf.decode_step(params2, cfg_small, cache, tokens[:, -1])
    if tuple(logits.shape) != (B, cfg_small.vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg_small.name} smoke logits: shape {tuple(logits.shape)}, "
                             "not all finite")
