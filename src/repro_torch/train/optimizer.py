"""AdamW with global-norm clipping and a warmup + cosine schedule: the
counterpart of `repro.train.optimizer` (`OptConfig`, `AdamWState`,
`schedule`, `adamw_init`, `global_norm`, `adamw_update`).

Over trees of tensors (`train.tree`).  Moments are f32 whatever the
parameters' dtype; decoupled weight decay applies to tensors of ndim >= 2
only; `grad_norm` in the metrics is taken before clipping.  The update is
out of place, as the reference's: it returns new parameters and moments,
so a caller that retries a step still holds the last good state; a caller
that cannot hold two copies of the state asks for `in_place`, the
counterpart of donating the state to the jitted step.  The
step, the learning rate and the bias corrections stay tensors on the
parameters' device (no host sync).  `zero1_specs` (the sharded moments)
waits for the distributed port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.train import tree as T

# elements a block of the in-place update touches at a time: its f32
# temporaries stay a few blocks in size whatever the leaf's
_BLOCK = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor     # () int32
    m: Any
    v: Any


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup to `lr` over `warmup_steps`, then a cosine decay to
    0.1 · lr at `total_steps`; f32."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * torch.clamp(t, 0, 1)))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, 0.1 + 0.9 * cos)


def adamw_init(params) -> AdamWState:
    leaves = T.leaves(params)
    if not leaves:
        raise ValueError("adamw_init needs at least one parameter")

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
                      m=T.tree_map(zeros, params), v=T.tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ x²), in f32, leaves in the reference's order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in T.leaves(tree)))


def adamw_update(cfg: OptConfig, grads, state: AdamWState, params, *, in_place: bool = False):
    """Returns (new_params, new_state, metrics {grad_norm, lr}).

    With `in_place` the new parameters and moments are written into
    `params` and `state`'s moments, which the caller gives up (as buffers
    donated to `jax.jit`), a block of `_BLOCK` elements at a time: the
    update then needs no second copy of the state, and its values are the
    same bits as the out-of-place update's."""
    gnorm = global_norm(grads)
    g_leaves, spec = T.flatten(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.float())
    b2c = 1 - torch.pow(cfg.b2, step.float())

    def upd(g, m, v, p, decay: bool):
        gf = (g if scale is None else g * scale).float()
        m2 = cfg.b1 * m + (1 - cfg.b1) * gf
        v2 = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps)
        if decay:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m2, v2

    def upd_into(g, m, v, p):
        flat = [g.reshape(-1), m.view(-1), v.view(-1), p.view(-1)]
        for lo in range(0, p.numel(), _BLOCK):
            gb, mb, vb, pb = (x[lo:lo + _BLOCK] for x in flat)
            p2, m2, v2 = upd(gb, mb, vb, pb, p.ndim >= 2)
            pb.copy_(p2)
            mb.copy_(m2)
            vb.copy_(v2)
        return p, m, v

    triples = [upd_into(g, m, v, p) if in_place else upd(g, m, v, p, p.ndim >= 2)
               for g, m, v, p in
               zip(g_leaves, T.leaves(state.m), T.leaves(state.v), T.leaves(params))]
    return (
        T.unflatten(spec, [t[0] for t in triples]),
        AdamWState(step=step, m=T.unflatten(spec, [t[1] for t in triples]),
                   v=T.unflatten(spec, [t[2] for t in triples])),
        {"grad_norm": gnorm, "lr": lr},
    )


def adamw_state_from_numpy(state, params_from_numpy: Callable,
                           device: DeviceLike = "cuda") -> AdamWState:
    """The reference's `AdamWState` with numpy leaves, as the port's, on
    `device`: `params_from_numpy` maps each moment tree as it maps the
    parameters (for DeepFM, `models.deepfm.deepfm_params_from_numpy`, which
    transposes the MLP weights; for the LM, `lm_params_from_numpy` of an
    f32 config)."""
    dev = resolve_device(device)

    def carry(tree):
        return T.tree_map(lambda v: v.to(dev), params_from_numpy(tree))

    return AdamWState(step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                                        device=dev),
                      m=carry(state.m), v=carry(state.v))
