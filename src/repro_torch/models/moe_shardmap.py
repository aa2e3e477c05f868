"""Expert-parallel MoE with explicit communication (counterpart of
`repro.models.moe_shardmap`).

* tokens are sharded over the token axis and REPLICATED over the expert
  axis;
* each (token shard, expert rank j) rank routes its tokens, ranks their
  assignments against the capacity of ITS token shard (`moe.assign_slots`,
  the reference's `_slot_assignment`), selects the slots of its own
  E / n experts, runs their FFN and combines their contributions to its
  tokens;
* the ONLY collective is the sum of the (N_local, D) partial outputs over
  the expert axis (`dist.collectives.sum_over`: its backward is the
  identity), after which the shared experts, replicated, are added.

Semantics, as the reference's: capacity is per (token shard, expert), the
GShard convention, where `moe_ffn` ranks globally; with capacity that
does not bind the two are equal.

Gradients.  Each rank's backward of its tokens' loss gives, per leaf, a
part of the global gradient, and `moe_shardmap_grads` says how the parts
combine (as DTensors for `optimizer.adamw_update_placed`): an expert's
weights live on one expert rank and sum over the token shards; the
router reaches each rank's loss only through its own experts' combine
weights, so it sums over the expert ranks too; the shared experts run
after the sum, identically on every expert rank, so they sum over the
token shards and count once over the expert ranks.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.dist.collectives import sum_over
from repro_torch.dist.sharding import local
from repro_torch.models.lm_config import MoEConfig
from repro_torch.models.moe import (
    _expert_ffn,
    _shared_experts,
    assign_slots,
    expert_capacity,
    route_topk,
)


def moe_ffn_shardmap(params: Dict[str, Any], x, cfg: MoEConfig, act: str, mesh, *,
                     expert_axis: str = "model") -> torch.Tensor:
    """This rank's rows of the expert-parallel MoE FFN on `mesh` (a
    `DeviceMesh`).  `x` is this rank's token block (N_local, D), the same
    on every rank of its expert group; `params` hold the router and the
    shared experts whole and the expert stacks `we1` / `we3` / `we2` as
    this rank's E / n experts (leaves may be DTensors under those
    placements, or their local blocks).  The capacity follows from x's
    local block, `expert_capacity(N_local)`, as the reference's.  Returns
    (N_local, D)."""
    names = mesh.mesh_dim_names
    e_dim = names.index(expert_axis)
    n_shards = mesh.size(e_dim)
    E, k = cfg.n_experts, cfg.top_k
    if E % n_shards:
        raise ValueError(f"{E} experts do not divide over {n_shards} expert ranks")
    E_loc = E // n_shards
    p = {name: local(v) for name, v in params.items()}
    if p["we1"].shape[0] != E_loc:
        raise ValueError(f"we1 holds {p['we1'].shape[0]} experts, this rank owns {E_loc}")
    x_l = local(x)
    N_loc = x_l.shape[0]
    w, experts, _ = route_topk(x_l @ p["router"].to(x_l.dtype), cfg)
    plan = assign_slots(experts, E, expert_capacity(N_loc, cfg))
    lo = mesh.get_coordinate()[e_dim] * E_loc

    # ---- my experts' slots, their tokens gathered locally --------------------
    tok = plan.tok_for_slot[lo:lo + E_loc]
    valid = plan.slot_valid[lo:lo + E_loc]
    y_buf = _expert_ffn(p, x_l[tok] * valid[..., None].to(x_l.dtype), act)

    # ---- my experts' contributions to my tokens ------------------------------
    out = torch.zeros_like(x_l)
    for j in range(k):
        e = experts[:, j].long()
        own = (e >= lo) & (e < lo + E_loc) & plan.keep[:, j]
        y = y_buf[torch.clamp(e - lo, 0, E_loc - 1), plan.slot[:, j]]
        out = out + torch.where(own[:, None], y, 0) * w[:, j:j + 1].to(x_l.dtype)
    out = sum_over(out, mesh.get_group(expert_axis))      # the one collective
    if "ws1" in p:
        out = out + _shared_experts(p, x_l, act)
    return out


def moe_shardmap_grads(grads: Dict[str, torch.Tensor], params: Dict[str, Any], mesh, *,
                       token_axis="data", expert_axis: str = "model") -> Dict[str, Any]:
    """This rank's gradients of `moe_ffn_shardmap`'s leaves (local blocks)
    as DTensors whose placements combine them into the global gradient:
    `Partial()` over the token axes for every leaf and over the expert axis
    for the router.  `params` are the DTensors the step placed (experts
    `Shard(0)` over the expert axis, the rest replicated)."""
    from repro_torch.train.optimizer import partial_grads

    tokens = {token_axis} if isinstance(token_axis, str) else set(token_axis or ())
    out = {}
    for name, g in grads.items():
        over = tokens | {expert_axis} if name == "router" else tokens
        out[name] = partial_grads(g, params[name], mesh, over)
    return out
