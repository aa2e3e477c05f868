"""The LM family's cells (counterpart of the LM part of
`repro.configs.common`): the assigned shapes, the analytic FLOP counts,
the train cell's step (`make_lm_train_step`), the two serve steps the
reference's prefill and decode cells lower, and `lm_smoke`, which each
arch module's `smoke` runs.

The train step runs data-parallel on a `DeviceMesh` (`mesh=`), placed as
the reference's train cell places it (`place_lm_state`): parameters by
`lm_param_specs`, AdamW moments by `zero1_specs` over the data axes,
tokens and targets by `batch_spec(mesh, 1)` (`data.pipeline.shard_batch`).
Left out, as `gnn_cells` leaves them out: the `Cell` / `ArchDef` registry
and the dry-run machinery (`_dryrun_cfg`, `_with_stack_layers`,
`_needs_fsdp`, the cost passes' unrolled variants).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

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
                      dp=None):
    """`transformer.lm_loss` and its gradient with respect to every leaf
    of `params`: (loss, metrics, grads); a leaf the loss does not reach
    gets zeros, as `jax.value_and_grad` gives.  With `dp` (a
    `dist.collectives.DataGroup`), this rank's parts of them."""
    leaves, spec = T.flatten(params)
    leaves = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        kw = {} if dp is None else {"dp": dp}
        loss, metrics = tf.lm_loss(T.unflatten(spec, leaves), cfg, tokens, targets, **kw)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            T.unflatten(spec, grads))


def make_lm_train_step(cfg: LMConfig, opt_cfg: OptConfig, *, donate: bool = False,
                       mesh=None):
    """The train cell's step: (params, opt_state, tokens, targets) ->
    (params, opt_state, loss, xent), the loss's gradient through autograd
    and one AdamW update.  With `donate` the step writes the new state
    into the one it is given (`adamw_update(in_place=True)`), as a jitted
    step that donates its state: one copy of the state, not two.

    With `mesh` (a `DeviceMesh` whose axes but 'model' are batch axes;
    'model' must be 1) the same function runs data-parallel over the
    state `place_lm_state` placed and the batch `shard_batch` placed:
    each rank takes its part of the loss of the global batch
    (`transformer.lm_loss(dp=)`), `adamw_update_placed` reduce-scatters
    the gradients to the ZeRO-1 moments and gathers the parameters back;
    the loss and xent returned are the global batch's, on every rank."""
    if mesh is None:
        def train_step(params, opt_state, tokens, targets):
            loss, metrics, grads = lm_loss_and_grads(params, cfg, tokens, targets)
            params, opt_state, _ = adamw_update(opt_cfg, grads, opt_state, params,
                                                in_place=donate)
            return params, opt_state, loss, metrics["xent"]

        return train_step

    from repro_torch.dist.collectives import data_group
    from repro_torch.dist.sharding import data_axes, local

    dp = data_group(mesh, "the LM train step")
    batch_axes = set(data_axes(mesh))

    def placed_step(params, opt_state, tokens, targets):
        loss, metrics, grads = lm_loss_and_grads(T.tree_map(local, params), cfg,
                                                 local(tokens), local(targets), dp=dp)
        grads = partial_grads(grads, params, mesh, batch_axes)
        params, opt_state, _ = adamw_update_placed(opt_cfg, grads, opt_state, params,
                                                   in_place=donate)
        return params, opt_state, dp.all_reduce(loss), dp.all_reduce(metrics["xent"])

    return placed_step


def place_lm_state(params, mesh, *, fsdp: bool = False):
    """An LM's parameters (whole, the same on every rank) placed on `mesh` as
    the reference's train cell places them, and zero AdamW moments under
    `zero1_specs` over the data axes: (params, opt_state) of DTensors."""
    from repro_torch.dist.collectives import MODEL_AXIS_ITEM
    from repro_torch.dist.sharding import (
        _axis_size,
        data_axes,
        distribute,
        lm_param_specs,
    )

    if fsdp:
        raise NotImplementedError(f"FSDP execution waits for {MODEL_AXIS_ITEM}")
    specs = lm_param_specs(params, mesh)
    dp = data_axes(mesh)
    placed = distribute(params, specs, mesh)
    moments = zero1_specs(specs, params, mesh_axis=dp, mesh_size=_axis_size(mesh, dp))
    return placed, adamw_init_placed(placed, moments, mesh)


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


def lm_smoke(cfg_small: LMConfig, device: DeviceLike = "cuda") -> None:
    """One train step on a reduced config, then a prefill and a decode step
    of the updated weights; raises unless the loss and the last logits are
    finite and the tree and the logits keep their shapes."""
    dev = resolve_device(device)
    params = tf.init_lm(torch.Generator(device=dev).manual_seed(0), cfg_small)
    opt = adamw_init(params)
    B, S = 2, 32
    tokens = torch.randint(0, cfg_small.vocab, (B, S), dtype=torch.int32, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
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
