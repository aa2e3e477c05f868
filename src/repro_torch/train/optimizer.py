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
parameters' device (no host sync).

Placed state (DTensor leaves, `dist.sharding.distribute`): `zero1_specs`
shards the moments over the batch axes (ZeRO-1), `adamw_init_placed`
makes them, and `adamw_update_placed` takes gradients as DTensors whose
placements say how they are spread (`Partial()` on a mesh dimension whose
ranks each hold a part of the sum).  Each gradient is reduced to its
moments' placement (a reduce-scatter for a ZeRO-1 shard, an all-reduce
for a replicated moment), the global norm sums every shard once and each
replica once, each rank updates its block of the moments and of the
parameter, and the new parameter is gathered back to its own placement.
A leaf may be split over 'model' (tensor parallel: its gradient is this
rank's block, `Shard` as the parameter), over the batch axes too (FSDP:
the step already reduce-scattered its gradient), replicated over 'model'
with the same gradient on every model rank (the tensor-parallel steps'
convention), or partial over any axis named in `partial_grads`' `over`.
On a one-rank mesh the values are the bits `adamw_update` gives.
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


class _Step(NamedTuple):
    """One update's coefficients, shared by every leaf."""
    cfg: OptConfig
    scale: Optional[torch.Tensor]
    lr: torch.Tensor
    b1c: torch.Tensor
    b2c: torch.Tensor

    @classmethod
    def make(cls, cfg: OptConfig, gnorm: torch.Tensor, step: torch.Tensor) -> "_Step":
        scale = None
        if cfg.clip_norm is not None:
            scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        return cls(cfg, scale, schedule(cfg, step), 1 - torch.pow(cfg.b1, step.float()),
                   1 - torch.pow(cfg.b2, step.float()))

    def update(self, g, m, v, p, decay: bool):
        """(new p, new m, new v) of one leaf (or block of one)."""
        cfg = self.cfg
        gf = (g if self.scale is None else g * self.scale).float()
        m2 = cfg.b1 * m + (1 - cfg.b1) * gf
        v2 = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        delta = (m2 / self.b1c) / (torch.sqrt(v2 / self.b2c) + cfg.eps)
        if decay:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - self.lr * delta).to(p.dtype), m2, v2

    def update_into(self, g, m, v, p, decay: bool):
        """`update` written into m, v and p, `_BLOCK` elements at a time."""
        flat = [g.reshape(-1), m.view(-1), v.view(-1), p.view(-1)]
        for lo in range(0, p.numel(), _BLOCK):
            gb, mb, vb, pb = (x[lo:lo + _BLOCK] for x in flat)
            p2, m2, v2 = self.update(gb, mb, vb, pb, decay)
            pb.copy_(p2)
            mb.copy_(m2)
            vb.copy_(v2)
        return p, m, v


def adamw_update(cfg: OptConfig, grads, state: AdamWState, params, *, in_place: bool = False):
    """Returns (new_params, new_state, metrics {grad_norm, lr}).

    With `in_place` the new parameters and moments are written into
    `params` and `state`'s moments, which the caller gives up (as buffers
    donated to `jax.jit`), a block of `_BLOCK` elements at a time: the
    update then needs no second copy of the state, and its values are the
    same bits as the out-of-place update's."""
    gnorm = global_norm(grads)
    g_leaves, spec = T.flatten(grads)
    step = state.step + 1
    co = _Step.make(cfg, gnorm, step)
    lr = co.lr
    upd = co.update_into if in_place else co.update
    triples = [upd(g, m, v, p, p.ndim >= 2) for g, m, v, p in
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


# --------------------------------------------------------------------------
# placed state: ZeRO-1 moments over the batch axes
# --------------------------------------------------------------------------

def zero1_specs(param_specs, params, mesh_axis="data", mesh_size: int = 1):
    """ZeRO-1: each moment's spec is its parameter's with `mesh_axis` (a
    name or a tuple of names) on the largest dim that divides by
    `mesh_size` and is not sharded yet; a spec that already uses one of
    those axes (an FSDP parameter) stays as it is."""
    from repro_torch.dist.sharding import P

    names = set(mesh_axis) if isinstance(mesh_axis, tuple) else {mesh_axis}

    def extend(spec, p):
        parts = list(spec)
        while len(parts) < len(p.shape):
            parts.append(None)
        used = set()
        for q in parts:
            if q is not None:
                used |= set(q) if isinstance(q, tuple) else {q}
        if used & names:
            return P(*parts)
        for i in sorted(range(len(p.shape)), key=lambda i: -p.shape[i]):
            if parts[i] is None and p.shape[i] % max(mesh_size, 1) == 0 and mesh_size > 1:
                parts[i] = mesh_axis
                break
        return P(*parts)

    return T.tree_map(extend, param_specs, params)


def adamw_init_placed(params, moment_specs, mesh) -> AdamWState:
    """Zero moments under `moment_specs` (a tree of P) for the placed
    `params`: each rank allocates only its block."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import Sharding, _strides

    def zeros(p, spec):
        sh = Sharding(mesh, spec)
        block = sh.block(torch.empty(p.shape, device="meta"))
        local = torch.zeros(block.shape, dtype=torch.float32, device=p.to_local().device)
        return DTensor.from_local(local, mesh, sh.placements, run_check=False,
                                  shape=p.shape, stride=_strides(p.shape))

    leaves = T.leaves(params)
    if not leaves:
        raise ValueError("adamw_init_placed needs at least one parameter")
    step = torch.zeros((), dtype=torch.int32, device=leaves[0].to_local().device)
    return AdamWState(step=step, m=T.tree_map(zeros, params, moment_specs),
                      v=T.tree_map(zeros, params, moment_specs))


def partial_grads(grads, params, mesh, over) -> Any:
    """Local gradients (plain tensors, each of its parameter's local block)
    as DTensors: `Partial()` on the mesh dimensions named in `over` where
    the parameter is replicated (each rank holds its part of the sum),
    the parameter's placement elsewhere."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    names = mesh.mesh_dim_names

    def place(g, p):
        pl = [Partial() if names[i] in over and isinstance(q, Replicate) else q
              for i, q in enumerate(p.placements)]
        return DTensor.from_local(g, mesh, pl, run_check=False, shape=p.shape,
                                  stride=p.stride())

    return T.tree_map(place, grads, params)


def _counted_once(placements, coord) -> bool:
    """Whether this rank's block counts in a global sum: it is the first
    replica on every mesh dimension the tensor is replicated over."""
    from torch.distributed.tensor import Replicate

    return all(c == 0 for q, c in zip(placements, coord) if isinstance(q, Replicate))


def adamw_update_placed(cfg: OptConfig, grads, state: AdamWState, params, *,
                        in_place: bool = False):
    """`adamw_update` over placed trees: `params`, `state.m` / `state.v`
    and `grads` of DTensors (the moments under `zero1_specs` or any
    placement without `Partial`; the gradients as `partial_grads` gives
    them) on one mesh.  Returns
    (new params, new state, metrics) placed as they came; with `in_place`
    the new values are written into the given blocks."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.collectives import mesh_all_reduce

    p_leaves, spec = T.flatten(params)
    m_leaves, v_leaves = T.leaves(state.m), T.leaves(state.v)
    mesh = m_leaves[0].device_mesh
    # each gradient reduced to its moments' placement
    g_blocks = [g.redistribute(mesh, m.placements).to_local()
                for g, m in zip(T.leaves(grads), m_leaves)]
    coord = mesh.get_coordinate()
    sq = sum(torch.sum(torch.square(g.float())) if _counted_once(m.placements, coord)
             else torch.zeros((), dtype=torch.float32, device=g.device)
             for g, m in zip(g_blocks, m_leaves))
    gnorm = torch.sqrt(mesh_all_reduce(sq, mesh))
    step = state.step + 1
    co = _Step.make(cfg, gnorm, step)

    def one(g, m, v, p):
        decay = p.ndim >= 2
        same = list(p.placements) == list(m.placements)
        p_block = p.to_local() if same else p.redistribute(mesh, m.placements).to_local()
        if in_place and same:
            co.update_into(g, m.to_local(), v.to_local(), p_block, decay)
            return p, m, v
        p2, m2, v2 = co.update(g, m.to_local(), v.to_local(), p_block, decay)

        def placed(x, like):
            return DTensor.from_local(x, mesh, like.placements, run_check=False,
                                      shape=like.shape, stride=like.stride())

        p2 = placed(p2, m)
        if not same:
            p2 = p2.redistribute(mesh, p.placements)
        if in_place:
            p.to_local().copy_(p2.to_local())
            m.to_local().copy_(m2)
            v.to_local().copy_(v2)
            return p, m, v
        return p2, placed(m2, m), placed(v2, v)

    triples = [one(g, m, v, p) for g, m, v, p in zip(g_blocks, m_leaves, v_leaves, p_leaves)]
    return (
        T.unflatten(spec, [t[0] for t in triples]),
        AdamWState(step=step, m=T.unflatten(spec, [t[1] for t in triples]),
                   v=T.unflatten(spec, [t[2] for t in triples])),
        {"grad_norm": gnorm, "lr": co.lr},
    )
