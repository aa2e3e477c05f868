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

Data parallel (`moe_ffn(dp=)`, a `dist.collectives.DataGroup` whose ranks
hold consecutive blocks of the global batch's tokens): the layer is the
global batch's, each rank computing its own tokens' rows.  The (N_local,
k) expert ids are all-gathered, so `assign_slots` ranks every assignment
of the global batch against the global capacity, as the one-device layer
does; each rank keeps its own tokens' slots and dispatches only its own
kept assignments, into a buffer of the largest count any expert holds of
them (one host read a layer), so its expert work is its share, not the
global (E, C) buffer.  The load-balance loss E·Σ f_e·P_e takes f from
the global ids and is linear in P, so each rank's part is E·Σ f_e·(Σ of
its own probabilities)_e / N and the parts sum to the global loss.

Tensor parallel (`moe_ffn(tp=)`, a `dist.collectives.ModelGroup`): the
expert stacks split over E where it divides by the model ranks (else
over d_expert), as `dist.sharding.lm_param_specs` places them.  Routing
is the same on every model rank (the router is replicated; under `dp` by
the global ids); each rank dispatches only to its experts, and the
routed and shared outputs are summed over the model ranks.  The tokens
and the combine weights enter that partial work through
`ModelGroup.copy`, so the router's gradient and the one it passes to x
are summed over the ranks, while the load-balance term, computed the same
on every rank, is counted once.

Sequence parallel (`moe_ffn(tp=, seq=(B, S))`): x is the whole of the
model ranks' blocks of S, all-gathered with `ModelGroup.gather_sum`, so
each rank's gradient of x is its part of the gradient.  Nothing enters
the partial work through `copy` then; the replicated leaves that code
computed the same on every rank reads (the router, experts or shared
experts that run whole) do (`_seq_leaves`), the load-balance term reads
the probabilities through `ModelGroup.part` (each rank's gradient of
them its block of the tokens), and the output leaves as this rank's
block of S: partial sums reduce-scattered (`scatter_sum`), an output
computed whole on every rank cut (`_leave`).

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


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) int64 counts of each id in [0, n): `torch.bincount(ids,
    minlength=n)`'s values at a shape known without reading the ids."""
    flat = ids.reshape(-1).long()
    return torch.zeros((n,), dtype=torch.int64, device=ids.device).index_add_(
        0, flat, torch.ones_like(flat))


def load_balance_loss(probs: torch.Tensor, experts: torch.Tensor, n_experts: int):
    """Switch-style aux loss: E · Σ_e f_e · P_e."""
    N = probs.shape[0]
    f = _counts(experts, n_experts).to(torch.float32)
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


def _shared_experts(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    s1 = x @ params["ws1"].to(x.dtype)
    s3 = x @ params["ws3"].to(x.dtype) if act == "swiglu" else None
    return _activation(s1, s3, act) @ params["ws2"].to(x.dtype)


def _expert_ffn(params: dict, buf: torch.Tensor, act: str) -> torch.Tensor:
    """(E, C, D) dispatched tokens through each expert's FFN."""
    h1 = torch.bmm(buf, params["we1"].to(buf.dtype))
    h3 = torch.bmm(buf, params["we3"].to(buf.dtype)) if act == "swiglu" else None
    return torch.bmm(_activation(h1, h3, act), params["we2"].to(buf.dtype))


def _expert_tp(params: dict, cfg: MoEConfig, tp):
    """(first expert, experts, tp) of this rank's routed work: under `tp`
    its E/m experts where E splits (expert parallel), else every expert
    on its block of d_expert (feature parallel); without either, every
    expert whole and tp None."""
    E = cfg.n_experts
    if tp is None:
        return 0, E, None
    if tp.splits(E):
        n = params["we1"].shape[0]
        return tp.rank * n, n, tp
    if tp.splits(cfg.d_expert):
        return 0, E, tp
    return 0, E, None


def _seq_leaves(params: dict, cfg: MoEConfig, tp) -> dict:
    """Under sequence parallelism (`moe_ffn(seq=)`) each rank computes a
    part of the gradient of every replicated leaf that code computed the
    same on every rank reads (the router; the experts or the shared
    experts where they run whole): they enter through `copy`."""
    p = dict(params)
    names = ["router"]
    if _expert_tp(params, cfg, tp)[2] is None:
        names += ["we1", "we2", "we3"]
    if "ws1" in p and not tp.splits(cfg.d_expert * cfg.n_shared):
        names += ["ws1", "ws2", "ws3"]
    for name in names:
        if name in p:
            p[name] = tp.copy(p[name])
    return p


def _leave(y: torch.Tensor, partial: bool, tp, seq) -> torch.Tensor:
    """The layer's output (N, D): partial sums over `tp` summed, or with
    `seq` ((B, S) of the N tokens) this rank's block of S of their sum
    (reduce-scattered) or of an output computed whole on every rank."""
    if seq is None:
        return tp.sum(y) if partial else y
    y = y.reshape(tuple(seq) + y.shape[1:])
    y = tp.scatter_sum(y, 1) if partial else tp.block(y, 1)
    return y.reshape((-1,) + y.shape[2:])


def _routed(params: dict, x: torch.Tensor, w: torch.Tensor, e_nk: torch.Tensor,
            keep: torch.Tensor, slot: torch.Tensor, tok: torch.Tensor, valid: torch.Tensor,
            cfg: MoEConfig, act: str, tp, seq=None) -> Tuple[torch.Tensor, object]:
    """The routed experts' combined output for x's tokens: slot c of expert
    e is filled by token tok[e, c] where valid[e, c]; token n's j-th choice
    e_nk[n, j] reads its expert's slot slot[n, j] where keep[n, j], weighed
    by w[n, j].  Returns (output, the tp it is partial over, or None)."""
    N, D = x.shape
    e_lo, n_e, tp = _expert_tp(params, cfg, tp)
    if tp is not None and seq is None:  # partial over the ranks: their gradients summed
        x, w = tp.copy(x), tp.copy(w)
    tok, valid = tok[e_lo:e_lo + n_e], valid[e_lo:e_lo + n_e]
    C = tok.shape[1]

    # ---- dispatch: a gather of the token filling each slot ---------------
    y_buf = _expert_ffn(params, x[tok] * valid[..., None].to(x.dtype), act)   # (E, C, D)

    # ---- combine: k gathers ------------------------------------------------
    out = torch.zeros((N, D), dtype=x.dtype, device=x.device)
    for j in range(e_nk.shape[1]):
        e = e_nk[:, j] - e_lo
        own = keep[:, j] & (e >= 0) & (e < n_e)
        y_j = y_buf[e.clamp(0, n_e - 1), slot[:, j].clamp(0, C - 1)]          # (N, D)
        y_j = torch.where(own[:, None], y_j, 0)
        out = out + y_j * w[:, j:j + 1].to(x.dtype)
    return out, tp


def _combine(params: dict, x: torch.Tensor, routed: torch.Tensor, routed_tp, cfg: MoEConfig,
             act: str, tp, seq=None) -> torch.Tensor:
    """The routed output plus the shared experts (DeepSeek: a dense FFN on
    every token; under `tp` column- then row-parallel where their hidden
    dim splits), the parts computed per rank summed over the ranks
    (`_leave`)."""
    if "ws1" not in params:
        return _leave(routed, routed_tp is not None, tp, seq)
    shared_tp = tp if (tp is not None and tp.splits(cfg.d_expert * cfg.n_shared)) else None
    xs = x if shared_tp is None or seq is not None else shared_tp.copy(x)
    shared = _shared_experts(params, xs, act)
    if (routed_tp is None) == (shared_tp is None):
        return _leave(routed + shared, routed_tp is not None, tp, seq)
    return (_leave(routed, routed_tp is not None, tp, seq)
            + _leave(shared, shared_tp is not None, tp, seq))


def moe_ffn(
    params: dict,
    x: torch.Tensor,            # (N, D) flattened tokens
    cfg: MoEConfig,
    act: str,
    *,
    dp=None,
    tp=None,
    seq=None,
) -> Tuple[torch.Tensor, MoEMetrics]:
    """Top-k routed expert FFN + optional shared experts.  Returns (N, D).
    With `dp`, x is this rank's block of the global batch's tokens (see
    the module docstring), the aux loss this rank's part and the drop
    fraction the global batch's.  With `tp` (the model ranks, `params`
    their blocks) each rank runs its experts (or its block of every
    expert's features) and the outputs are summed over the ranks; the
    routing, the aux loss and the drop fraction are the same on every
    rank.  With `seq` ((B, S): x holds B sequences of S tokens, gathered
    over the model ranks from their blocks of S by `gather_sum`), the
    output is this rank's block of S, (B·S/m, D), its partial sums
    reduce-scattered (see the module docstring)."""
    if tp is not None and seq is not None:
        params = _seq_leaves(params, cfg, tp)
    if dp is not None:
        return _moe_ffn_data_parallel(params, x, cfg, act, dp, tp, seq)
    N, D = x.shape
    E = cfg.n_experts
    C = expert_capacity(N, cfg)
    w, experts, probs = route_topk(x @ params["router"].to(x.dtype), cfg)
    plan = assign_slots(experts, E, C)
    routed, routed_tp = _routed(params, x, w, experts.long(), plan.keep, plan.slot,
                                plan.tok_for_slot, plan.slot_valid, cfg, act, tp, seq)
    out = _combine(params, x, routed, routed_tp, cfg, act, tp, seq)
    metrics = MoEMetrics(
        aux_loss=load_balance_loss(_aux_probs(probs, tp, seq), experts, E),
        drop_frac=1.0 - plan.keep.to(torch.float32).mean(),
    )
    return out, metrics


def _local_capacity(own_kept: torch.Tensor, capacity: int, ranks: int, static: bool) -> int:
    """Slots of this rank's expert buffer: the most kept assignments any of
    its experts has, up to a multiple of 8 (one host read).  With `static`
    (`MoEConfig.buf_pspec` set: the dry run, which reads no data) the
    bound the reference's buffer has on a device, its capacity split over
    the batch ranks (`buf_pspec`), up to a multiple of 8; an assignment
    past it is then dropped."""
    if static:
        return max(8, -(-(-(-capacity // ranks)) // 8) * 8)
    return max(8, -(-int(own_kept.max()) // 8) * 8)   # one host read


def _aux_probs(probs: torch.Tensor, tp, seq) -> torch.Tensor:
    """The router probabilities as the load-balance loss reads them: with
    `seq` each rank's gradient of them is its part (`ModelGroup.part`: its
    block of the tokens), as every other gradient that reaches x; the loss
    itself is computed whole on every rank."""
    return probs if tp is None or seq is None else tp.part(probs, 0)


def _moe_ffn_data_parallel(params: dict, x: torch.Tensor, cfg: MoEConfig, act: str, dp,
                           tp=None, seq=None) -> Tuple[torch.Tensor, MoEMetrics]:
    N_loc, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    w, experts, probs = route_topk(x @ params["router"].to(x.dtype), cfg)
    ids = dp.all_gather(experts)                                  # (N, k), rank-major
    N = ids.shape[0]
    C = expert_capacity(N, cfg)
    plan = assign_slots(ids, E, C)
    lo = dp.rank * N_loc
    keep, slot = plan.keep[lo:lo + N_loc], plan.slot[lo:lo + N_loc]
    e_nk = experts.long()

    # an expert's assignments rank in token order, so this rank's are a run
    # of its slots starting after the earlier ranks' assignments to it
    before = _counts(ids[:lo], E)
    own = _counts(e_nk, E)
    own_kept = torch.minimum(torch.clamp_min(C - before, 0), own)
    e_lo, n_e, _ = _expert_tp(params, cfg, tp)
    static = cfg.buf_pspec is not None
    C_loc = _local_capacity(own_kept[e_lo:e_lo + n_e], C, dp.size, static)
    local_slot = slot - before[e_nk]
    if static:                  # an assignment past the static bound is dropped
        keep = keep & (local_slot < C_loc)

    # ---- this rank's kept assignments, (E, C_loc) slots ----------------------
    # (the model rank's own experts: the others' may hold more than C_loc);
    # an assignment not kept writes to a spare column C_loc, cut off after
    e_flat = e_nk.reshape(-1)
    kept = keep.reshape(-1) & (e_flat >= e_lo) & (e_flat < e_lo + n_e)
    s_flat = torch.where(kept, local_slot.reshape(-1), C_loc)
    tok = torch.zeros((E, C_loc + 1), dtype=torch.long, device=x.device)
    valid = torch.zeros((E, C_loc + 1), dtype=torch.bool, device=x.device)
    tok[e_flat, s_flat] = torch.arange(N_loc, device=x.device).repeat_interleave(k)
    valid[e_flat, s_flat] = kept
    tok, valid = tok[:, :C_loc], valid[:, :C_loc]
    routed, routed_tp = _routed(params, x, w, e_nk, keep, local_slot, tok, valid, cfg, act, tp,
                                seq)
    out = _combine(params, x, routed, routed_tp, cfg, act, tp, seq)

    f = _counts(ids, E).to(torch.float32) / (N * k)
    aux = E * torch.sum(f * (_aux_probs(probs, tp, seq).sum(dim=0) / N))
    return out, MoEMetrics(aux_loss=aux,
                           drop_frac=1.0 - plan.keep.to(torch.float32).mean())
