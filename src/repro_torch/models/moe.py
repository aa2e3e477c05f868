"""Mixture-of-Experts layer (counterpart of `repro.models.moe`): top-k
routing with capacity-bounded dispatch.

Top-k routing keeps `jax.lax.top_k`'s tie rule (`top_k`): the bf16
router logits of the full configs tie often, and a tie broken otherwise
sends a token to other experts.

Dispatch is sort-based, as in the reference: flatten the (N, k)
assignments, sort them by expert id (stably, so a token keeps its place
within its expert's run), and read each assignment's rank within its
expert off the sorted order.  Assignments ranked past the capacity are
dropped (GShard semantics).  The dispatch and the combine are gathers: slot
c of expert e names the token that fills it.

The reference's `with_sharding_constraint` layout hints for the (E, C, D)
buffers over a mesh compute nothing and have no counterpart here.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.lm_config import MoEConfig


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor       # load-balance loss (scalar)
    drop_frac: torch.Tensor      # fraction of assignments dropped (scalar)


class ExpertSlots(NamedTuple):
    """Where each (token, choice) assignment goes, for E experts of C slots."""
    keep: torch.Tensor           # (N, k) bool — kept, not dropped for capacity
    slot: torch.Tensor           # (N, k) int64 — its slot in its expert's buffer
    tok_for_slot: torch.Tensor   # (E, C) int64 — the token filling each slot
    slot_valid: torch.Tensor     # (E, C) bool — the slot is filled


def _activation(h1, h3, act: str):
    if act == "swiglu":
        return F.silu(h1) * h3
    if act == "relu2":
        r = F.relu(h1)
        return r * r
    raise ValueError(act)


def expert_capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Static per-expert buffer size (rounded up to a multiple of 8)."""
    avg = n_tokens * cfg.top_k / cfg.n_experts
    cap = int(avg * cfg.capacity_factor) + 1
    return ((cap + 7) // 8) * 8


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row (last axis) and their indices, in
    `jax.lax.top_k`'s order: descending value, the lower index first among
    equal values (`torch.topk` breaks ties otherwise).  A stable descending
    sort of the row gives that order; the values are gathered from `x`, so
    they keep its gradient.  For router rows (E <= 256)."""
    idx = torch.sort(x.detach(), dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


def route_topk(
    logits: torch.Tensor, cfg: MoEConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, E) logits -> (weights (N,k), experts (N,k) int32, probs (N,E))."""
    if cfg.router == "softmax":
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        topv, topi = top_k(probs, cfg.top_k)
        w = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    elif cfg.router == "sigmoid":  # DeepSeek-V3 aux-loss-free style gates
        scores = torch.sigmoid(logits.to(torch.float32))
        topv, topi = top_k(scores, cfg.top_k)
        w = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
        probs = scores / torch.clamp_min(scores.sum(-1, keepdim=True), 1e-9)
    else:
        raise ValueError(cfg.router)
    return w, topi.to(torch.int32), probs


def load_balance_loss(probs: torch.Tensor, experts: torch.Tensor, n_experts: int):
    """Switch-style aux loss: E · Σ_e f_e · P_e."""
    N = probs.shape[0]
    f = torch.bincount(experts.reshape(-1).long(), minlength=n_experts).to(torch.float32)
    f = f / (N * experts.shape[-1])
    p = probs.mean(dim=0)
    return n_experts * torch.sum(f * p)


def assign_slots(experts: torch.Tensor, n_experts: int, capacity: int) -> ExpertSlots:
    """The reference's sort-based slot assignment for (N, k) expert ids."""
    N, k = experts.shape
    E, C = n_experts, capacity
    dev = experts.device
    flat_e = experts.reshape(-1).long()                        # (N*k,)
    order = torch.argsort(flat_e, stable=True)                  # grouped by expert
    sorted_e = flat_e[order]
    start = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    rank_sorted = torch.arange(N * k, device=dev) - start[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    keep = (rank < C).reshape(N, k)
    slot = torch.clamp(rank, 0, C - 1).reshape(N, k)
    end = torch.searchsorted(sorted_e, torch.arange(1, E + 1, device=dev))
    pos = start[:, None] + torch.arange(C, device=dev)[None, :]  # (E, C) sorted index
    slot_valid = pos < torch.minimum(end, start + C)[:, None]
    tok_for_slot = order[torch.clamp(pos, 0, N * k - 1)] // k
    return ExpertSlots(keep, slot, tok_for_slot, slot_valid)


def moe_ffn(
    params: dict,
    x: torch.Tensor,            # (N, D) flattened tokens
    cfg: MoEConfig,
    act: str,
) -> Tuple[torch.Tensor, MoEMetrics]:
    """Top-k routed expert FFN + optional shared experts.  Returns (N, D)."""
    N, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = expert_capacity(N, cfg)
    w, experts, probs = route_topk(x @ params["router"].to(x.dtype), cfg)
    plan = assign_slots(experts, E, C)
    e_nk = experts.long()

    # ---- dispatch: a gather of the token filling each slot ---------------
    buf = x[plan.tok_for_slot] * plan.slot_valid[..., None].to(x.dtype)   # (E, C, D)

    # ---- expert GEMMs ------------------------------------------------------
    h1 = torch.bmm(buf, params["we1"].to(x.dtype))
    h3 = torch.bmm(buf, params["we3"].to(x.dtype)) if act == "swiglu" else None
    h = _activation(h1, h3, act)
    y_buf = torch.bmm(h, params["we2"].to(x.dtype))                      # (E, C, D)

    # ---- combine: k gathers ------------------------------------------------
    out = torch.zeros((N, D), dtype=x.dtype, device=x.device)
    for j in range(k):
        y_j = y_buf[e_nk[:, j], plan.slot[:, j]]                         # (N, D)
        y_j = torch.where(plan.keep[:, j:j + 1], y_j, 0)
        out = out + y_j * w[:, j:j + 1].to(x.dtype)

    # ---- shared experts (DeepSeek): dense FFN on every token --------------
    if "ws1" in params:
        s1 = x @ params["ws1"].to(x.dtype)
        s3 = x @ params["ws3"].to(x.dtype) if act == "swiglu" else None
        out = out + _activation(s1, s3, act) @ params["ws2"].to(x.dtype)

    metrics = MoEMetrics(
        aux_loss=load_balance_loss(probs, experts, E),
        drop_frac=1.0 - plan.keep.to(torch.float32).mean(),
    )
    return out, metrics
