"""DeepFM (Guo et al., arXiv:1703.04247): the counterpart of
`repro.models.deepfm` (`DeepFMConfig`, `deepfm_init`, `deepfm_logits`,
`deepfm_loss`, `retrieval_score`).

Layout as in the reference: the fields' vocabularies are packed into ONE
embedding table (and one first-order table) with per-field offsets.  The
two bag sums of a forward, the first-order term `Σ_f linear[id_f]` and the
FM field sum `Σ_f v_f`, run through the Hopper embedding-bag kernel
(`hopper.embedding_bag`); the reference computes the same sums as
gather-then-sum.  The per-field rows `v` for `Σ‖v‖²` and the deep tower
stay a plain gather, as in the reference, taken by the same bag call so
that their gradient joins the bag's.

FM pairwise term by the O(N·d) identity  Σ_{i<j}⟨v_i,v_j⟩ = ½(‖Σv‖² − Σ‖v‖²).

Training: `deepfm_loss` is the reference's binary cross-entropy on the
logits.  Its gradient reaches the tables through the bag's hand-written
backward kernel (`hopper.embedding_bag.embedding_bag_backward`) alone: one
launch per table, the `embed` one with the gather's gradient as its
per-slot `extra` term (the reference's jax.grad scatter-adds g_v + g_s per
slot), both over one sort of the slots (`SlotPlan`), so a step writes one
dense gradient per table; `configs.deepfm.train_step` takes one AdamW
step.

Data parallel (`configs.deepfm.train_step(mesh=)`): the tables' rows are
split over the ranks (`dist.sharding.deepfm_specs`) and the forward's
bags run through `VocabParallelBag`, the `bag=` hook's vocab-parallel
form: it all-gathers the fields, runs the bag kernel over this rank's
rows of the table for the global batch (a slot whose row lies elsewhere
weighs 0), and reduce-scatters the sums and gathered rows back to the
batch blocks; backward, the gradients are all-gathered and the backward
kernel writes this rank's rows.

`retrieval_score` scores one user context against N candidate items of
`item_field` as one matvec over the candidates' rows.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.hopper.embedding_bag import SlotPlan, embedding_bag
from repro_torch.models.gnn.common import MLP

Bag = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    field_vocabs: Tuple[int, ...]      # per-field vocabulary sizes (39 fields)
    embed_dim: int = 10
    mlp_dims: Tuple[int, ...] = (400, 400, 400)

    @property
    def n_fields(self) -> int:
        return len(self.field_vocabs)

    @property
    def total_vocab(self) -> int:
        return int(sum(self.field_vocabs))

    @property
    def offsets(self) -> torch.Tensor:
        """(F,) int32 exclusive cumsum of the vocabularies: field f's rows
        start at offsets[f] in the packed table."""
        return torch.tensor(np.cumsum((0,) + tuple(self.field_vocabs[:-1])),
                            dtype=torch.int32)

    def param_count(self) -> int:
        n = self.total_vocab * (self.embed_dim + 1)    # embeddings + linear
        d = self.n_fields * self.embed_dim
        for o in self.mlp_dims:
            n += d * o + o
            d = o
        n += d + 1
        return n


class DeepFM(nn.Module):
    """`embed` (V, d), `linear` (V,), `bias` () and the deep tower
    `mlp` (F·d → mlp_dims → 1, ReLU), all f32, drawn as the reference's
    `deepfm_init` draws them (normal · 0.01 tables, zero bias, He-scaled
    MLP) from a generator seeded with `seed` on `device` (the card unless
    the caller asks for the CPU)."""

    def __init__(self, cfg: DeepFMConfig, *, seed: int = 0, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(seed)
        V, d = cfg.total_vocab, cfg.embed_dim
        self.cfg = cfg

        def normal(shape):
            return torch.randn(shape, generator=generator, device=dev) * 0.01

        self.embed = nn.Parameter(normal((V, d)))
        self.linear = nn.Parameter(normal((V,)))
        self.bias = nn.Parameter(torch.zeros((), device=dev))
        self.mlp = MLP((cfg.n_fields * d,) + tuple(cfg.mlp_dims) + (1,),
                       generator=generator, device=dev, act=torch.relu)
        self.register_buffer("offsets", cfg.offsets.to(dev), persistent=False)

    def forward(self, fields: torch.Tensor, *, bag: Bag = embedding_bag) -> torch.Tensor:
        return deepfm_logits(self, fields, bag=bag)

    def retrieval_score(self, user_fields: torch.Tensor, cand_ids: torch.Tensor,
                        item_field: int = 0) -> torch.Tensor:
        return retrieval_score(self, user_fields, cand_ids, item_field)


def deepfm_logits(model: DeepFM, fields: torch.Tensor, *, bag: Bag = embedding_bag) -> torch.Tensor:
    """(B, F) int32 per-field ids -> (B,) f32 logits.  `bag` computes the
    two bag sums and the gather `v` (the kernel's wrapper; its plain
    version to hold the path against it): the table's gradient from `s`
    and from `v` is one backward launch, and both backwards share one sort
    of the slots."""
    B, F = fields.shape
    V, d = model.embed.shape
    flat = fields.to(torch.int32) + model.offsets[None, :]
    plan = SlotPlan(flat, V)            # one sort of the slots for both backwards
    lin = bag(model.linear.view(V, 1), flat, plan=plan)[:, 0]    # first order (B,)
    s, v = bag(model.embed, flat, plan=plan, gather=True)        # Σ_f v_f (B, d), v (B, F, d)
    fm = 0.5 * ((s * s).sum(dim=-1) - (v * v).sum(dim=(1, 2)))
    deep = model.mlp(v.reshape(B, F * d))[:, 0]
    return model.bias + lin + fm + deep


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    total: Optional[int] = None) -> torch.Tensor:
    """The reference's stable binary cross-entropy on (B,) logits and {0, 1}
    labels: mean(max(l, 0) − l·y + log1p(exp(−|l|))); with `total`, the
    sum of the terms over `total` (this block's part of a larger batch's
    mean)."""
    terms = (torch.clamp(logits, min=0) - logits * labels
             + torch.log1p(torch.exp(-logits.abs())))
    return torch.mean(terms) if total is None else terms.sum() / total


def deepfm_loss(model: DeepFM, fields: torch.Tensor, labels: torch.Tensor, *,
                bag: Bag = embedding_bag) -> torch.Tensor:
    """Binary cross-entropy of `deepfm_logits` on (B,) {0, 1} f32 labels."""
    return bce_with_logits(deepfm_logits(model, fields, bag=bag), labels)


def retrieval_score(model: DeepFM, user_fields: torch.Tensor, cand_ids: torch.Tensor,
                    item_field: int = 0, *, bag: Bag = embedding_bag) -> torch.Tensor:
    """Score ONE user context against N candidates of `item_field`:

        score(c) = const_user + ⟨v_c, Σ_user v⟩ + w_c

    with the deep tower on the user side only (the two-tower deployment of
    FM models).  The user sums are bags of one row whose weights are the
    user mask (0 on `item_field`).  user_fields (F,), with
    user_fields[item_field] ignored; cand_ids (N,) -> (N,) f32 scores."""
    V, d = model.embed.shape
    F = model.cfg.n_fields
    user_mask = torch.arange(F, device=model.embed.device) != item_field
    flat = (user_fields.to(torch.int32) + model.offsets)[None, :]     # (1, F)
    w = user_mask.float()[None, :]
    s_user = bag(model.embed, flat, w)[0]                                # (d,)
    lin_user = bag(model.linear.view(V, 1), flat, w)[0, 0]
    v_user = torch.where(user_mask[:, None], model.embed[flat[0]], 0.0)  # (F, d)
    fm_user = 0.5 * ((s_user * s_user).sum() - (v_user * v_user).sum())
    deep_user = model.mlp(v_user.reshape(1, F * d))[0, 0]
    const = model.bias + lin_user + fm_user + deep_user

    cand_rows = model.offsets[item_field] + cand_ids.to(torch.int32)
    v_c = model.embed[cand_rows]                                         # (N, d)
    w_c = model.linear[cand_rows]                                        # (N,)
    return const + v_c @ s_user + w_c


class VocabParallelBag:
    """The `bag=` of `deepfm_logits` when each rank of `dp` (a
    `dist.collectives.DataGroup`) holds rows [r·V_r, (r+1)·V_r) of the
    tables and block r of the batch.  A call takes this rank's table rows
    and its block of (global-row) indices and returns its block's sums
    (and gathered rows): the indices are all-gathered, `bag` (the kernel's
    wrapper, or its plain version) runs over the local rows for the
    global batch with weight 0 on every slot whose row lies on another
    rank (its index taken modulo V_r, a local row), and the results are
    reduce-scattered.  The bags over one index tensor share one slot plan
    over the local rows (made here: a `plan` given for the global rows is
    not used), so a train step sorts once."""

    def __init__(self, dp, bag: Bag = embedding_bag):
        self.dp, self.bag = dp, bag
        self._for, self._local = None, None

    def __call__(self, table: torch.Tensor, indices: torch.Tensor,
                 weights: Optional[torch.Tensor] = None, *, gather: bool = False, plan=None):
        dp, V_r = self.dp, table.shape[0]
        if self._for is not indices or self._local[0] != V_r:
            glob = dp.all_gather(indices)
            lo = dp.rank * V_r
            local = torch.remainder(glob, V_r).to(torch.int32)
            mask = ((glob >= lo) & (glob < lo + V_r)).to(torch.float32)
            self._for, self._local = indices, (V_r, local, mask, SlotPlan(local, V_r))
        _, local, mask, plan = self._local
        w = mask if weights is None else mask * dp.all_gather(weights)
        out = self.bag(table, local, w, gather=gather, plan=plan)
        if not gather:
            return dp.reduce_scatter(out)
        s, rows = out
        return dp.reduce_scatter(s), dp.reduce_scatter(rows * mask[..., None])


def deepfm_params_from_numpy(params) -> Dict[str, torch.Tensor]:
    """The reference's `deepfm_init` output, as numpy arrays
    ({embed, linear, bias, mlp: MLP(ws, bs)}), as a `DeepFM` state dict.
    The reference applies `ws[i]` (in, out) as `x @ w`; `nn.Linear` holds
    (out, in), so each weight is transposed."""
    ws, bs = params["mlp"]
    state = {k: torch.from_numpy(np.array(params[k], dtype=np.float32))
             for k in ("embed", "linear", "bias")}
    for i, (w, b) in enumerate(zip(ws, bs)):
        state[f"mlp.layers.{i}.weight"] = torch.from_numpy(
            np.array(np.asarray(w, dtype=np.float32).T, order="C"))
        state[f"mlp.layers.{i}.bias"] = torch.from_numpy(np.array(b, dtype=np.float32))
    return state
