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

Over a mesh (`configs.deepfm` steps with `mesh=`): the tables' rows are
split over every rank, data major (`dist.sharding.deepfm_specs`), and the
forward's bags run through `VocabParallelBag`, the `bag=` hook's
vocab-parallel form: it all-gathers the fields over the data ranks, runs
the bag kernel over this rank's rows of the table for the global batch (a
slot whose row lies elsewhere weighs 0), reduce-scatters the sums and
gathered rows back to the batch blocks and sums them over the model
ranks; backward, the gradients are all-gathered and the backward kernel
writes this rank's rows.  The deep tower (`tower(tp=)`) is
column-parallel over 'model' on each layer whose out features split,
gathered before the next; retrieval scores each candidate on the rank
that holds its rows.

`retrieval_score` scores one user context against N candidate items of
`item_field` as one matvec over the candidates' rows.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import prng
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
    `deepfm_init(key)` draws them under `split(key, 3)`: normal · 0.01
    tables (`embed`, then `linear`), zero bias, the He-scaled MLP under
    the third key, on `device` (the card unless the caller asks for the
    CPU; "meta" builds the shapes and draws nothing).  `key` defaults to
    `prng.key(seed)`."""

    def __init__(self, cfg: DeepFMConfig, *, seed: int = 0, key: Optional[prng.Key] = None,
                 device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        k1, k2, k3 = prng.split(prng.key(seed) if key is None else key, 3)
        V, d = cfg.total_vocab, cfg.embed_dim
        self.cfg = cfg
        self.embed = nn.Parameter(prng.normal_into(k1, torch.empty((V, d), device=dev), 0.01))
        self.linear = nn.Parameter(prng.normal_into(k2, torch.empty((V,), device=dev), 0.01))
        self.bias = nn.Parameter(torch.zeros((), device=dev))
        self.mlp = MLP((cfg.n_fields * d,) + tuple(cfg.mlp_dims) + (1,), key=k3, device=dev,
                       act=torch.relu)
        self.register_buffer("offsets", cfg.offsets.to(dev), persistent=False)

    def forward(self, fields: torch.Tensor, *, bag: Bag = embedding_bag, tp=None) -> torch.Tensor:
        return deepfm_logits(self, fields, bag=bag, tp=tp)

    def retrieval_score(self, user_fields: torch.Tensor, cand_ids: torch.Tensor,
                        item_field: int = 0) -> torch.Tensor:
        return retrieval_score(self, user_fields, cand_ids, item_field)


def _split(tp, n: int) -> bool:
    return tp is not None and tp.splits(n)


def tower(layers, x: torch.Tensor, tp=None) -> torch.Tensor:
    """The deep tower on x (B, F·d): `layers` [(weight (out, in), bias)],
    ReLU between them, each a matmul and then its bias.  Under `tp` (a
    `dist.collectives.ModelGroup`) a layer whose out features split over
    the model ranks holds this rank's rows of its weight
    (`dist.sharding.deepfm_specs`): column-parallel, its output gathered
    whole before the (replicated) bias; the rest run whole."""
    for i, (w, b) in enumerate(layers):
        if _split(tp, b.shape[0]):
            x = tp.gather(F.linear(tp.copy(x), w), -1) + b
        else:
            x = F.linear(x, w) + b
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def _layers(mlp) -> list:
    return [(layer.weight, layer.bias) for layer in mlp.layers]


def deepfm_logits(model: DeepFM, fields: torch.Tensor, *, bag: Bag = embedding_bag,
                  tp=None) -> torch.Tensor:
    """(B, F) int32 per-field ids -> (B,) f32 logits.  `bag` computes the
    two bag sums and the gather `v` (the kernel's wrapper; its plain
    version to hold the path against it): the table's gradient from `s`
    and from `v` is one backward launch, and both backwards share one sort
    of the slots.  `tp`: the tower's model ranks (`tower`)."""
    B, F = fields.shape
    V, d = model.embed.shape
    flat = fields.to(torch.int32) + model.offsets[None, :]
    plan = SlotPlan(flat, V)            # one sort of the slots for both backwards
    lin = bag(model.linear.view(V, 1), flat, plan=plan)[:, 0]    # first order (B,)
    s, v = bag(model.embed, flat, plan=plan, gather=True)        # Σ_f v_f (B, d), v (B, F, d)
    fm = 0.5 * ((s * s).sum(dim=-1) - (v * v).sum(dim=(1, 2)))
    deep = tower(_layers(model.mlp), v.reshape(B, F * d), tp)[:, 0]
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
                    item_field: int = 0, *, bag: Bag = embedding_bag, params=None,
                    tp=None, vp: Optional["VocabParallelBag"] = None) -> torch.Tensor:
    """Score ONE user context against N candidates of `item_field`:

        score(c) = (⟨v_c, Σ_user v⟩ + w_c) + const_user

    with the deep tower on the user side only (the two-tower deployment of
    FM models).  The user sums are bags of one row whose weights are the
    user mask (0 on `item_field`).  user_fields (F,), with
    user_fields[item_field] ignored; cand_ids (N,) -> (N,) f32 scores.
    `params`: the leaves to use by their state-dict names (the model's
    own by default).

    With `vp` (the step's `VocabParallelBag`) the leaves are this rank's
    blocks: the user's bags run over its rows and are summed over the
    ranks; `cand_ids` is its block of the candidates over every rank
    (flat), whose rows the ranks that hold them score; the scores are
    this rank's block.  `tp`: the tower's model ranks (`tower`)."""
    leaf = dict(model.named_parameters()) if params is None else params
    embed, linear = leaf["embed"], leaf["linear"]
    V_r, d = embed.shape
    F_ = model.cfg.n_fields
    lo = 0 if vp is None else vp.block * V_r
    user_mask = torch.arange(F_, device=embed.device) != item_field
    idx = (user_fields.to(torch.int32) + model.offsets)[None, :] - lo    # (1, F)
    own = user_mask & (idx[0] >= 0) & (idx[0] < V_r)
    idx = idx.clamp(0, V_r - 1)
    w = own.float()[None, :]
    s_user = bag(embed, idx, w)[0]                                       # (d,)
    lin_user = bag(linear.view(V_r, 1), idx, w)[0, 0]
    v_user = torch.where(own[:, None], embed[idx[0]], 0.0)               # (F, d)
    if vp is not None:
        s_user, lin_user, v_user = (vp.sum_rows(t) for t in (s_user, lin_user, v_user))
    fm_user = 0.5 * ((s_user * s_user).sum() - (v_user * v_user).sum())
    layers = [(leaf[f"mlp.layers.{i}.weight"], leaf[f"mlp.layers.{i}.bias"])
              for i in range(len(model.mlp.layers))]
    deep_user = tower(layers, v_user.reshape(1, F_ * d), tp)[0, 0]
    const = leaf["bias"] + lin_user + fm_user + deep_user

    if vp is not None:
        cand_ids = vp.gather_flat(cand_ids)
    rows = model.offsets[item_field] + cand_ids.to(torch.int32) - lo
    mine = (rows >= 0) & (rows < V_r)
    rows = rows.clamp(0, V_r - 1)
    part = torch.where(mine, embed[rows] @ s_user + linear[rows], 0.0)
    if vp is not None:
        part = vp.scatter_flat(part)
    return part + const


class VocabParallelBag:
    """The `bag=` of `deepfm_logits` when the tables' rows are split over a
    step's ranks (`dist.sharding.deepfm_specs`): over every rank, as block
    `dp.rank · m + tp.rank` of the flat (data, model) order, or, where the
    vocab does not split that far, over the model ranks alone
    (`over_data` False: block `tp.rank`).  The batch is split over the data
    ranks `dp` only, the same on every model rank.  A call takes this
    rank's table rows and its block of (global-row) indices and returns
    its block's sums (and gathered rows): where the rows are split over
    the data ranks the indices are all-gathered, `bag` (the kernel's
    wrapper, or its plain version) runs over the local rows with weight 0
    on every slot whose row lies on another rank (its index taken modulo
    V_r, a local row), and the results are reduce-scattered to the batch
    blocks and summed over the model ranks.  The bags over one index
    tensor share one slot plan over the local rows (made here: a `plan`
    given for the global rows is not used), so a train step sorts once."""

    def __init__(self, dp, tp=None, bag: Bag = embedding_bag, *, over_data: bool = True):
        self.dp, self.tp, self.bag, self.over_data = dp, tp, bag, over_data
        m, r = (1, 0) if tp is None else (tp.size, tp.rank)
        self.block = dp.rank * m + r if over_data else r
        self._for, self._local = None, None

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Partial sums over the rows' ranks -> this rank's batch block."""
        if self.over_data:
            x = self.dp.reduce_scatter(x)
        return x if self.tp is None else self.tp.sum(x)

    def sum_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Σ of x over the ranks that hold the rows (no gradient)."""
        if self.over_data:
            x = self.dp.all_reduce(x)
        return x if self.tp is None else self.tp.sum(x.detach())

    def gather_flat(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's block of a tensor split over all the ranks, data
        major (no gradient)."""
        if self.tp is not None:
            x = self.tp.gather(x.detach(), 0)
        return self.dp.all_gather(x)

    def scatter_flat(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's flat block of the sum over the rows' ranks of x."""
        if self.over_data:
            x = self.dp.reduce_scatter(x)
            return x if self.tp is None else self.tp.reduce_scatter(x)
        x = x if self.tp is None else self.tp.sum(x)
        n = x.shape[0] // (self.dp.size * (1 if self.tp is None else self.tp.size))
        flat = self.dp.rank * (1 if self.tp is None else self.tp.size) + (
            0 if self.tp is None else self.tp.rank)
        return x[flat * n:(flat + 1) * n]

    def __call__(self, table: torch.Tensor, indices: torch.Tensor,
                 weights: Optional[torch.Tensor] = None, *, gather: bool = False, plan=None):
        dp, V_r = self.dp, table.shape[0]
        if self._for is not indices or self._local[0] != V_r:
            glob = dp.all_gather(indices) if self.over_data else indices
            lo = self.block * V_r
            local = torch.remainder(glob, V_r).to(torch.int32)
            mask = ((glob >= lo) & (glob < lo + V_r)).to(torch.float32)
            self._for, self._local = indices, (V_r, local, mask, SlotPlan(local, V_r))
        _, local, mask, plan = self._local
        if weights is not None:
            weights = dp.all_gather(weights) if self.over_data else weights
        w = mask if weights is None else mask * weights
        out = self.bag(table, local, w, gather=gather, plan=plan)
        if not gather:
            return self._reduce(out)
        s, rows = out
        return self._reduce(s), self._reduce(rows * mask[..., None])


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
