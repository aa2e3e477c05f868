"""deepfm [arXiv:1703.04247]: 39 sparse fields (13 binned numerics + 26
categoricals, Criteo-style vocabulary skew, 33,889,984 rows in all),
embed_dim=10, MLP 400-400-400, FM interaction.  The counterpart of
`repro.configs.deepfm`: the same vocabularies, configs, shapes and FLOP
count, one step per serve shape, and the train_batch cell's train step
(`deepfm_loss`, its gradients, one AdamW update).

With `mesh=` (a `DeviceMesh` of one batch axis and a 'model' axis) the
train, serve and retrieval steps run under `deepfm_specs`, placed by
`place_deepfm_state` as the reference's cells place them (the moments as
the parameters): the tables' rows split over every rank (over
('data', 'model'), flat), their bags through
`models.deepfm.VocabParallelBag` on each rank's rows, the batch split
over the data ranks, the tower's first layers column-parallel over
'model' (`models.deepfm.tower`), the loss the global batch's mean; the
retrieval candidates split over every rank, scored by the ranks that
hold their rows.  Each computes the function of the step without a
mesh.

Shapes: train_batch 65 536 / serve_p99 512 / serve_bulk 262 144 /
retrieval_cand 1×1 000 000 candidates (padded to 1 000 448, a multiple of
512, as the reference's cell pads them).

The dry run's cells (`ARCH.cells`) build these steps with `mesh=` on
fake inputs: the state placed by `place_deepfm_state`, the batch by
`batch_spec(mesh, 1)` / `P(data_axes)`, the candidates over every rank.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.func import functional_call

from repro_torch.configs.common import ArchDef, Cell, placed, register
from repro_torch.core import prng
from repro_torch.device import DeviceLike
from repro_torch.dist.collectives import data_group
from repro_torch.dist.sharding import data_axes, deepfm_specs, distribute, local
from repro_torch.hopper.embedding_bag import embedding_bag
from repro_torch.models.deepfm import (
    Bag,
    DeepFM,
    DeepFMConfig,
    VocabParallelBag,
    bce_with_logits,
    retrieval_score,
)
from repro_torch.train.optimizer import (
    AdamWState,
    OptConfig,
    adamw_init_placed,
    adamw_update,
    adamw_update_placed,
    partial_grads,
)

# Criteo-style skewed vocabularies (sum ≈ 33.9M, padded per-field to /16)
_CAT = [10_000_000, 8_000_000, 5_000_000, 4_000_000, 2_000_000, 1_500_000,
        1_000_000, 800_000, 500_000, 400_000, 300_000, 200_000, 100_000,
        50_000, 20_000, 10_000, 5_000, 2_000, 1_000, 500, 200, 100, 100,
        100, 50, 16]
FIELD_VOCABS = tuple([64] * 13 + [(v + 15) // 16 * 16 for v in _CAT])

CONFIG = DeepFMConfig(field_vocabs=FIELD_VOCABS, embed_dim=10,
                      mlp_dims=(400, 400, 400))
SMOKE_CONFIG = DeepFMConfig(field_vocabs=tuple([32] * 39), embed_dim=10,
                            mlp_dims=(64, 64))

SHAPES = {
    "train_batch": dict(batch=65_536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262_144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, kind="serve"),
}
RETRIEVAL_CANDIDATES = -(-SHAPES["retrieval_cand"]["n_candidates"] // 512) * 512
TRAIN_OPT = OptConfig(total_steps=10000)     # the train_batch cell's

Params = Dict[str, torch.Tensor]


def _fwd_flops(cfg: DeepFMConfig, batch: int) -> float:
    d = cfg.n_fields * cfg.embed_dim
    f = 2.0 * batch * cfg.n_fields * cfg.embed_dim    # FM term
    for o in cfg.mlp_dims + (1,):
        f += 2.0 * batch * d * o
        d = o
    return f


def serve_step(model: DeepFM, fields: torch.Tensor, *, params: Optional[Params] = None,
               mesh=None) -> torch.Tensor:
    """serve_p99 / serve_bulk: (B, 39) int32 fields -> (B,) logits.  With
    `mesh`, `params` placed by `place_deepfm_state` and `fields` this
    rank's block (or its DTensor): this rank's block of the logits."""
    with torch.inference_mode():
        if mesh is None:
            return model(fields)
        _, tp, bag = _parallel(mesh, params)
        return functional_call(model, _locals(params), (local(fields),), {"bag": bag, "tp": tp})


def retrieval_step(model: DeepFM, user_fields: torch.Tensor, cand_ids: torch.Tensor,
                   item_field: int = 0, *, params: Optional[Params] = None,
                   mesh=None) -> torch.Tensor:
    """retrieval_cand: one user's (39,) fields against (N,) candidate ids of
    `item_field` -> (N,) scores.  With `mesh`, `params` placed by
    `place_deepfm_state`, `user_fields` whole and `cand_ids` this rank's
    block of them over every rank (a DTensor, or its block; P(flat), the
    candidates padded to a multiple of the ranks as `RETRIEVAL_CANDIDATES`
    is of 512): this rank's block of the scores."""
    with torch.inference_mode():
        if mesh is None:
            return model.retrieval_score(user_fields, cand_ids, item_field)
        _, tp, bag = _parallel(mesh, params)
        return retrieval_score(model, local(user_fields), local(cand_ids), item_field,
                               params=_locals(params), tp=tp,
                               vp=bag if isinstance(bag, VocabParallelBag) else None)


def train_params(model: DeepFM) -> Params:
    """The model's parameters as the plain dict `train_step` carries (the
    state-dict names: embed, linear, bias, mlp.layers.<i>.weight / .bias)."""
    return {k: v.detach() for k, v in model.named_parameters()}


def train_param_shapes(cfg: DeepFMConfig) -> Params:
    """`train_params`' names and shapes as "meta" tensors (no allocation),
    for the placement policies."""
    V, d = cfg.total_vocab, cfg.embed_dim
    shapes = {"embed": (V, d), "linear": (V,), "bias": ()}
    dims = (cfg.n_fields * d,) + tuple(cfg.mlp_dims) + (1,)
    for i, (n_in, n_out) in enumerate(zip(dims, dims[1:])):
        shapes[f"mlp.layers.{i}.weight"] = (n_out, n_in)
        shapes[f"mlp.layers.{i}.bias"] = (n_out,)
    return {k: torch.empty(s, device="meta") for k, s in shapes.items()}


def loss_and_grads(model: DeepFM, params: Params, fields: torch.Tensor,
                   labels: torch.Tensor, *, bag: Bag = embedding_bag, total: Optional[int] = None,
                   tp=None) -> Tuple[torch.Tensor, Params]:
    """`deepfm_loss` of `model`'s structure with `params`' values
    (`torch.func.functional_call`), and its gradient with respect to each
    parameter.  Each table's gradient is one launch of the bag's backward
    kernel, the gather's gradient included, over one sort of the slots
    (`bag`: its plain version, to hold the path against it).  With
    `total`, the loss is this block's part of the mean over `total`
    examples; `tp`: the tower's model ranks (`models.deepfm.tower`)."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    with torch.enable_grad():
        logits = functional_call(model, leaves, (fields,), {"bag": bag, "tp": tp})
        loss = bce_with_logits(logits, labels, total)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def train_step(model: DeepFM, params: Params, opt: AdamWState, fields: torch.Tensor,
               labels: torch.Tensor, *, opt_cfg: OptConfig = TRAIN_OPT,
               bag: Bag = embedding_bag, mesh=None) -> Tuple[Params, AdamWState, torch.Tensor]:
    """train_batch: the loss and gradients of `deepfm_loss` on (B, 39) int32
    fields and (B,) f32 labels, then one `adamw_update`.  Returns the new
    params, the new optimizer state and the loss; out of place, as the
    reference's step.

    With `mesh`, the state placed by `place_deepfm_state` and the batch by
    `shard_batch` (fields `batch_spec(mesh, 1)`, labels
    `P(data_axes(mesh))`): each rank's part of the global mean, `bag`
    through `VocabParallelBag` on the tables' row blocks, then
    `adamw_update_placed`; the loss returned is the global batch's."""
    if mesh is None:
        loss, grads = loss_and_grads(model, params, fields, labels, bag=bag)
        params, opt, _ = adamw_update(opt_cfg, grads, opt, params)
        return params, opt, loss
    dp, tp, vbag = _parallel(mesh, params, bag)
    labels = local(labels)
    loss, grads = loss_and_grads(model, _locals(params), local(fields), labels, bag=vbag,
                                 total=labels.shape[0] * dp.size, tp=tp)
    grads = partial_grads(grads, params, mesh, set(data_axes(mesh)))
    params, opt, _ = adamw_update_placed(opt_cfg, grads, opt, params)
    return params, opt, dp.all_reduce(loss)


def _locals(params: Params) -> Params:
    return {k: local(v) for k, v in params.items()}


def _parallel(mesh, params: Params, bag: Bag = embedding_bag):
    """(DataGroup, ModelGroup, the bag) of a step on `mesh`: the
    vocab-parallel bag where `deepfm_specs` splits the tables' rows (over
    every rank, or over 'model' alone), `bag` itself where they are
    whole."""
    from repro_torch.dist.sharding import _axis_size

    dp, tp = data_group(mesh, "the DeepFM step")
    V = params["embed"].shape[0]
    if V % _axis_size(mesh, tuple(mesh.mesh_dim_names)) == 0:
        return dp, tp, VocabParallelBag(dp, tp, bag)
    if tp is not None and tp.splits(V):
        return dp, tp, VocabParallelBag(dp, tp, bag, over_data=False)
    return dp, tp, bag


def place_deepfm_state(params: Params, mesh) -> Tuple[Params, AdamWState]:
    """`train_params` (whole, the same on every rank) placed by
    `deepfm_specs`, and zero AdamW moments placed as the parameters."""
    specs = deepfm_specs(params, mesh)
    placed = distribute(params, specs, mesh)
    return placed, adamw_init_placed(placed, specs, mesh)


def smoke_inputs(device: DeviceLike = "cuda"):
    """`smoke`'s model and batch under the reference's keys: the model from
    `key(0)`, fields (16, 39) `randint(key(1), .., 0, 32)`, labels
    `uniform(key(2), (16,)) > 0.5` as f32."""
    model = DeepFM(SMOKE_CONFIG, key=prng.key(0), device=device)
    dev = model.embed.device
    fields = prng.randint(prng.key(1), (16, 39), 0, 32, dev)
    labels = (prng.uniform(prng.key(2), 16, dev) > 0.5).float()
    return model, fields, labels


def smoke(device: DeviceLike = "cuda") -> None:
    """Forward, loss, gradients and retrieval of the smoke config: finite,
    of the right shapes."""
    model, fields, labels = smoke_inputs(device)
    dev = model.embed.device
    params = train_params(model)
    loss, grads = loss_and_grads(model, params, fields, labels)
    if not bool(torch.isfinite(loss)) or any(
            g.shape != params[k].shape or not bool(torch.isfinite(g).all())
            for k, g in grads.items()):
        raise AssertionError(f"smoke loss {float(loss)} or its gradients not finite")
    logits = serve_step(model, fields)
    if logits.shape != (16,) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"smoke logits: shape {tuple(logits.shape)}, not all finite")
    sc = retrieval_step(model, fields[0], torch.arange(32, dtype=torch.int32, device=dev))
    if sc.shape != (32,) or not bool(torch.isfinite(sc).all()):
        raise AssertionError(f"smoke retrieval: shape {tuple(sc.shape)}, not all finite")


# --------------------------------------------------------------------------
# the dry run's cells
# --------------------------------------------------------------------------

def _placed_model(mesh):
    """The CONFIG model with fake parameters on the mesh's device
    (`configs.common.fake_module`) and its state placed by
    `place_deepfm_state`, with the specs."""
    from repro_torch.configs.common import fake_module
    from repro_torch.dist.sharding import mesh_device

    model = fake_module(lambda: DeepFM(CONFIG, seed=0, device="meta"), mesh_device(mesh))
    whole = train_params(model)
    params, opt = place_deepfm_state(whole, mesh)
    return model, params, opt, deepfm_specs(whole, mesh)


def _fields(mesh, batch: int):
    from repro_torch.dist.sharding import batch_spec, mesh_device

    spec = batch_spec(mesh, 1)
    x = torch.empty((batch, CONFIG.n_fields), dtype=torch.int32, device=mesh_device(mesh))
    return placed(x, spec, mesh), spec


def _train_cell() -> Cell:
    B = SHAPES["train_batch"]["batch"]

    def build(mesh, variant: str = "memory"):
        from repro_torch.dist.sharding import P, mesh_device

        model, params, opt, p_specs = _placed_model(mesh)
        fields, f_spec = _fields(mesh, B)
        l_spec = P(data_axes(mesh))
        labels = placed(torch.empty((B,), device=mesh_device(mesh)), l_spec, mesh)

        def step(params, opt, fields, labels):
            return train_step(model, params, opt, fields, labels, mesh=mesh)

        return step, (params, opt, fields, labels), (
            p_specs, AdamWState(step=P(), m=p_specs, v=p_specs), f_spec, l_spec)

    return Cell(arch="deepfm", shape="train_batch", kind="train", build=build,
                model_flops=3.0 * _fwd_flops(CONFIG, B))


def _serve_cell(shape_name: str) -> Cell:
    B = SHAPES[shape_name]["batch"]

    def build(mesh, variant: str = "memory"):
        model, params, _, p_specs = _placed_model(mesh)
        fields, f_spec = _fields(mesh, B)

        def step(params, fields):
            return serve_step(model, fields, params=params, mesh=mesh)

        return step, (params, fields), (p_specs, f_spec)

    return Cell(arch="deepfm", shape=shape_name, kind="serve", build=build,
                model_flops=_fwd_flops(CONFIG, B))


def _retrieval_cell() -> Cell:
    NC = RETRIEVAL_CANDIDATES

    def build(mesh, variant: str = "memory"):
        from repro_torch.dist.sharding import P, mesh_device

        dev = mesh_device(mesh)
        model, params, _, p_specs = _placed_model(mesh)
        c_spec = P(tuple(mesh.mesh_dim_names))
        user = torch.empty((CONFIG.n_fields,), dtype=torch.int32, device=dev)
        cands = placed(torch.empty((NC,), dtype=torch.int32, device=dev), c_spec, mesh)

        def step(params, user_fields, cand_ids):
            return retrieval_step(model, user_fields, cand_ids, params=params, mesh=mesh)

        return step, (params, user, cands), (p_specs, P(), c_spec)

    return Cell(arch="deepfm", shape="retrieval_cand", kind="serve", build=build,
                model_flops=2.0 * NC * CONFIG.embed_dim,
                note="1 user × 1M candidates, factorised FM matvec")


ARCH = register(ArchDef(
    arch_id="deepfm", family="recsys",
    cells={
        "train_batch": _train_cell(),
        "serve_p99": _serve_cell("serve_p99"),
        "serve_bulk": _serve_cell("serve_bulk"),
        "retrieval_cand": _retrieval_cell(),
    },
    smoke=smoke,
    config=CONFIG,
))
