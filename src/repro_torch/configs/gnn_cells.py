"""The GNN family's cells (counterpart of `repro.configs.gnn_cells`): the
assigned shapes and the train steps the reference's cell builders wrap.

Each arch file (`gin_tu`, `pna`, `egnn`, `mace`) supplies a `GNNArch`:
  init(d_in, n_out, *, seed, key, device) -> nn.Module   (key: prng.key(seed) if None)
  node_logits(model, params, feats, coords, s, r, mask, split=None) -> (N, n_out)
  graph_energy(model, params, feats, coords, s, r, mask, n_graphs) -> (n_graphs,)
  fwd_flops(n_nodes, n_edges, d_feat) -> float
where `params` is a plain {state-dict name: tensor} dict run through the
model by `torch.func.functional_call` (None: the model's own), so that a
train step is out of place, as the reference's.

The steps: `full_graph_step` (cross-entropy over every vertex),
`minibatch_step` (the reference's inline sampler on the card: seeds, their
fanout[0] neighbours and those's fanout[1] neighbours, flattened to a tree;
cross-entropy over the seeds) and `molecule_step` (an energy MSE over a
batch of molecules).  Each is a loss, its gradients by autograd and one
`adamw_update` with the cells' `OptConfig(total_steps=1000)`.

A molecule batch runs as one block-diagonal graph of B·N vertices, where
the reference vmaps `graph_energy` over the molecules: the same function,
since every op is local to a vertex or an edge, with the energy summed per
molecule and PNA's δ taken per molecule (`n_graphs`).

`ogb_products` runs the full-graph step with the graph split over the
ranks of a mesh (`split=`, a `dist.graph.GraphSplit`): each rank holds a
block of the vertices and the half-edges into them, its part of the loss
is its vertices' cross-entropy over the global N, the gradients of the
replicated parameters are summed over the ranks and AdamW runs on the
state `place_gnn_state` places (`P()` everywhere, as the reference's
cell).  `products_inputs` / `products_part` build the shape's stand-in.

The dry run's cells (`gnn_cells`, `configs.common.Cell`) build these
steps on fake inputs of the reference cells' shapes (`_pad512`: padded
to shard over 512 ranks): full_graph_sm and ogb_products through
`full_graph_step(split=)` over the flat mesh, rank 0's vertex block and
its `_pad512(2E) / R` half-edges; minibatch_lg and molecule through
`minibatch_step(mesh=)` and `molecule_step(mesh=)` on this rank's block of
the seeds or molecules (the batch split over the batch axes, as the
reference's `P(d)`), the state placed by `place_gnn_state`, the gradients
summed over the batch axes before AdamW.  minibatch_lg's tables are placed
as the reference's: `indptr` whole (`P()`), `indices`, the features, the
coordinates and the labels split by rows over the flat mesh (`P(flat)`,
`P(flat, None)`), each rank holding its block and reading every row the
step needs through `dist.lookup.TableSplit.take` (`minibatch_step(tables=)`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.func import functional_call

from repro_torch.configs.common import Cell
from repro_torch.device import DeviceLike
from repro_torch.core import prng
from repro_torch.graphs.sampler import hop_draws, sample_neighbors
from repro_torch.train.optimizer import AdamWState, OptConfig, adamw_update

GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_out=7),
    "minibatch_lg": dict(
        n_nodes=232965, n_edges=114_615_892, d_feat=602, n_out=41,
        batch_nodes=1024, fanout=(15, 10),
    ),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100, n_out=47),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=16),
}
TRAIN_OPT = OptConfig(total_steps=1000)     # every GNN cell's


def _pad512(n: int) -> int:
    """The reference's dry-run shapes shard over up to 512 ranks: arrays
    zero-padded to a multiple of 512."""
    return -(-n // 512) * 512

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class GNNArch:
    arch_id: str
    init: Callable          # (d_in, n_out, *, seed, key, device) -> nn.Module
    node_logits: Callable   # (model, params, feats, coords, s, r, mask, split=None) -> (N, n_out)
    graph_energy: Callable  # (model, params, feats, coords, s, r, mask, n_graphs) -> (n_graphs,)
    fwd_flops: Callable     # (n_nodes, n_edges, d_feat) -> float


def call(model: torch.nn.Module, params: Optional[Params], *args, **kwargs):
    """model(*args, **kwargs) with `params`' values in place of its own."""
    if params is None:
        return model(*args, **kwargs)
    return functional_call(model, params, args, kwargs)


def per_graph_sum(x: torch.Tensor, n_graphs: int) -> torch.Tensor:
    """(N,) values -> (n_graphs,) sums over equal contiguous blocks."""
    return x.reshape(n_graphs, -1).sum(dim=1)


def _xent_terms(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each row's cross-entropy, in f32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return lse - tgt


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean(_xent_terms(logits, labels))


def train_params(model: torch.nn.Module) -> Params:
    """The model's parameters as the plain dict the steps carry."""
    return {k: v.detach() for k, v in model.named_parameters()}


def loss_and_grads(loss_fn: Callable[[Params], torch.Tensor], params: Params
                   ) -> Tuple[torch.Tensor, Params]:
    """loss_fn(params) and its gradient with respect to each parameter; a
    parameter the loss does not reach (MACE's first-layer residuals for
    l > 0) gets zeros, as jax.grad gives."""
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    with torch.enable_grad():
        loss = loss_fn(leaves)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(leaves.items(), grads)}


def _step(loss_fn, params: Params, opt: AdamWState, opt_cfg: OptConfig, mesh=None):
    """One AdamW step on loss_fn's gradients.  With `mesh`, data parallel:
    `params` and `opt` placed by `place_gnn_state`, loss_fn this rank's
    block of the batch (equal blocks over the batch ranks); its mean's
    gradients summed over the batch axes (`partial_grads`), then
    `adamw_update_placed`; the loss returned is the global batch's."""
    if mesh is None:
        loss, grads = loss_and_grads(loss_fn, params)
        params, opt, _ = adamw_update(opt_cfg, grads, opt, params)
        return params, opt, loss
    from repro_torch.dist.collectives import data_group
    from repro_torch.dist.sharding import data_axes, local
    from repro_torch.train.optimizer import adamw_update_placed, partial_grads

    dp, _ = data_group(mesh, "a GNN train step")
    loss, grads = loss_and_grads(lambda p: loss_fn(p) / dp.size,
                                 {k: local(v) for k, v in params.items()})
    grads = partial_grads(grads, params, mesh, set(data_axes(mesh)))
    params, opt, _ = adamw_update_placed(opt_cfg, grads, opt, params)
    return params, opt, dp.all_reduce(loss)


# --------------------------------------------------------------------------
# full graph
# --------------------------------------------------------------------------

def full_graph_loss(a: GNNArch, model, params: Optional[Params], feats, coords, senders,
                    receivers, mask, labels, *, split=None) -> torch.Tensor:
    """Mean cross-entropy of `node_logits` over every vertex.  With `split`
    (see `full_graph_step`): this rank's vertices' cross-entropy summed and
    divided by the global N, summed over the ranks (backward the identity),
    so every rank returns the whole graph's loss."""
    if split is None:
        return _xent(a.node_logits(model, params, feats, coords, senders, receivers, mask),
                     labels)
    logits = a.node_logits(model, params, feats, coords, senders, receivers, mask, split=split)
    return split.sum(torch.sum(_xent_terms(logits, labels)) / split.n_nodes)


def full_graph_step(a: GNNArch, model, params: Params, opt: AdamWState, feats, coords,
                    senders, receivers, mask, labels, *, opt_cfg: OptConfig = TRAIN_OPT,
                    split=None):
    """full_graph_sm / ogb_products: returns (params, opt, loss).

    With `split` (a `dist.graph.GraphSplit` of the graph over a mesh), the
    state placed by `place_gnn_state` on the split's mesh, feats, coords
    and labels this rank's vertex rows (`split.rows`) and the edges the
    split's (`*split.edges`): each rank's part of the loss and its
    gradients, the gradients summed over every rank of the mesh, then
    `adamw_update_placed` (its norm the summed gradient's); the loss
    returned is the whole graph's."""
    if split is None:
        return _step(lambda p: full_graph_loss(a, model, p, feats, coords, senders, receivers,
                                               mask, labels), params, opt, opt_cfg)
    from repro_torch.dist.sharding import local
    from repro_torch.train.optimizer import adamw_update_placed, partial_grads

    loss, grads = loss_and_grads(
        lambda p: full_graph_loss(a, model, p, feats, coords, senders, receivers, mask, labels,
                                  split=split), {k: local(v) for k, v in params.items()})
    grads = partial_grads(grads, params, split.mesh, set(split.mesh.mesh_dim_names))
    params, opt, _ = adamw_update_placed(opt_cfg, grads, opt, params)
    return params, opt, loss


def place_gnn_state(params: Params, mesh) -> Tuple[Params, AdamWState]:
    """`train_params` (whole, the same on every rank) replicated on `mesh`
    (`P()`, as the reference's full-graph cell places them) and zero AdamW
    moments placed alike."""
    from repro_torch.dist.sharding import P, distribute
    from repro_torch.train.optimizer import adamw_init_placed

    specs = {k: P() for k in params}
    placed = distribute(params, specs, mesh)
    return placed, adamw_init_placed(placed, specs, mesh)


def products_nodes(fraction: float = 1.0) -> int:
    """ogb_products' vertex count cut to `fraction` of it (rounded)."""
    return int(round(GNN_SHAPES["ogb_products"]["n_nodes"] * fraction))


def products_inputs(n_nodes: Optional[int] = None, *, seed: int = 0,
                    device: DeviceLike = "cuda"):
    """ogb_products' stand-in, whole, at its widths and average degree with
    `n_nodes` vertices (the shape's 2,449,029 by default): (senders,
    receivers, mask) of `erdos_renyi(n_nodes, 2E / N, seed)` on the host
    (no padding: every edge real), then features (N, 100) f32, coordinates
    (N, 3) f32 and labels (N,) int32 in [0, 47) on `device`, drawn in that
    order from one generator seeded with `seed` there."""
    from repro_torch.device import resolve_device
    from repro_torch.graphs.generators import erdos_renyi

    shape = GNN_SHAPES["ogb_products"]
    n = shape["n_nodes"] if n_nodes is None else int(n_nodes)
    dev = resolve_device(device)
    g = erdos_renyi(n, avg_deg=2 * shape["n_edges"] / shape["n_nodes"], seed=seed,
                    device="cpu")
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn((n, shape["d_feat"]), generator=gen, device=dev)
    coords = torch.randn((n, 3), generator=gen, device=dev)
    labels = torch.randint(0, shape["n_out"], (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    return g.senders, g.receivers, g.edge_mask, feats, coords, labels


def products_part(mesh, n_nodes: Optional[int] = None, *, seed: int = 0):
    """This rank's part of `products_inputs(n_nodes, seed=seed)` on the
    mesh's device: (split, feats, coords, labels), the rows this rank's.
    Every rank draws the whole stand-in the same and keeps its part."""
    from repro_torch.dist.graph import split_graph
    from repro_torch.dist.sharding import mesh_device

    senders, receivers, mask, *rows = products_inputs(n_nodes, seed=seed,
                                                      device=mesh_device(mesh))
    split = split_graph(senders, receivers, mask, rows[0].shape[0], mesh)
    del senders, receivers, mask
    return (split, *(split.rows(x) for x in rows))


# --------------------------------------------------------------------------
# sampled minibatch
# --------------------------------------------------------------------------

def minibatch_draws(key: prng.Key, batch: int, fanout, device, *, row0: int = 0):
    """The reference cell's inline sampler's draws (its `k1, k2 =
    split(key)`): (u1 (batch, f1), u2 (batch, f1, f2)) int32 in [0, 2^31 -
    1), rows row0 on of the global batch's draw."""
    k1, k2 = prng.split(key)
    f1, f2 = (int(f) for f in fanout)
    return (hop_draws(k1, (batch, f1), device, row0),
            hop_draws(k2, (batch, f1, f2), device, row0))


def minibatch_tree(indptr, indices, seeds, draws, tables=None):
    """The reference cell's inline sampler and tree flattening: (ids,
    senders, receivers, edge_mask) over B + B·f1 + B·f1·f2 slots.  Unlike
    `NeighborSampler`, a second-hop slot of a masked parent keeps its draw
    from vertex 0's row; only its edge is masked (m2 & m1).  With `tables`
    (a `dist.lookup.TableSplit`), `indices` is this rank's block."""
    u1, u2 = draws
    B, f1 = u1.shape
    f2 = u2.shape[-1]
    dev = seeds.device
    l1, m1 = sample_neighbors(indptr, indices, seeds, u1, tables)     # (B, f1)
    l1 = torch.where(m1, l1, 0)
    l2, m2 = sample_neighbors(indptr, indices, l1, u2, tables)        # (B, f1, f2)
    l2 = torch.where(m2, l2, 0)
    m2 = m2 & m1[..., None]
    ids = torch.cat([seeds, l1.reshape(-1), l2.reshape(-1)])
    off1, off2 = B, B + B * f1
    snd = torch.cat([off1 + torch.arange(B * f1, dtype=torch.int32, device=dev),
                     off2 + torch.arange(B * f1 * f2, dtype=torch.int32, device=dev)])
    rcv = torch.cat([torch.arange(B, dtype=torch.int32, device=dev).repeat_interleave(f1),
                     off1 + torch.arange(B * f1, dtype=torch.int32,
                                         device=dev).repeat_interleave(f2)])
    emask = torch.cat([m1.reshape(-1), m2.reshape(-1)])
    return ids, snd, rcv, emask


def minibatch_rows(tree, feats_tab, coords_tab, labels_tab, seeds, tables=None):
    """The tree's feature and coordinate rows and the seeds' labels, read
    from the whole tables or, with `tables` (a `dist.lookup.TableSplit`),
    from this rank's blocks of them."""
    ids = tree[0]
    if tables is None:
        idx = ids.long()
        return feats_tab[idx], coords_tab[idx], labels_tab[seeds.long()]
    return (tables.take(feats_tab, ids), tables.take(coords_tab, ids),
            tables.take(labels_tab, seeds))


def minibatch_loss(a: GNNArch, model, params: Optional[Params], tree, feats_tab, coords_tab,
                   labels_tab, seeds, tables=None) -> torch.Tensor:
    """Cross-entropy of the seeds' logits on the sampled tree."""
    _, snd, rcv, emask = tree
    feats, coords, labels = minibatch_rows(tree, feats_tab, coords_tab, labels_tab, seeds,
                                           tables)
    logits = a.node_logits(model, params, feats, coords, snd, rcv, emask)
    return _xent(logits[: seeds.shape[0]], labels)


def minibatch_step(a: GNNArch, model, params: Params, opt: AdamWState, key, indptr, indices,
                   feats_tab, coords_tab, labels_tab, seeds, *,
                   opt_cfg: OptConfig = TRAIN_OPT, mesh=None, tables=None):
    """minibatch_lg: sample the tree under `key` and take one step on it.
    `key` is a `prng.Key`, as the reference's step takes its key data
    (drawn at the shape's fanout), or the draws it gives
    (`minibatch_draws`) as (u1, u2).  With `mesh`,
    `seeds` (and given draws) are this rank's block of the batch (`_step`:
    equal blocks over the batch ranks), and a key draws this rank's rows
    of the global draw.  With
    `tables` (`dist.lookup.TableSplit.of(mesh)`), the tables are split over
    the mesh as the reference's cell places them: `indices`, `feats_tab`,
    `coords_tab` and `labels_tab` are this rank's blocks
    (`TableSplit.block`), `indptr` whole; every read of them is a
    `TableSplit.take`, which returns the table's own bits, so the step is
    the one on whole tables bit for bit."""
    if tables is not None and mesh is None:
        raise ValueError("tables split over a mesh need the step's mesh")
    draws = key
    if isinstance(key, prng.Key):
        b = seeds.shape[0]
        row0 = 0
        if mesh is not None:
            from repro_torch.dist.collectives import data_group

            row0 = data_group(mesh, "a GNN train step")[0].rank * b
        draws = minibatch_draws(key, b, GNN_SHAPES["minibatch_lg"]["fanout"], seeds.device,
                                row0=row0)
    tree = minibatch_tree(indptr, indices, seeds, draws, tables)
    return _step(lambda p: minibatch_loss(a, model, p, tree, feats_tab, coords_tab,
                                          labels_tab, seeds, tables), params, opt, opt_cfg, mesh)


# --------------------------------------------------------------------------
# molecules
# --------------------------------------------------------------------------

def molecule_energies(a: GNNArch, model, params: Optional[Params], feats, coords, senders,
                      receivers, mask) -> torch.Tensor:
    """(B, N, d), (B, N, 3), (B, E) int32 ×2, (B, E) bool -> (B,) energies,
    the B molecules as one block-diagonal graph."""
    B, N, _ = feats.shape
    offs = (torch.arange(B, device=feats.device, dtype=torch.int32) * N)[:, None]
    return a.graph_energy(model, params, feats.reshape(B * N, -1), coords.reshape(B * N, 3),
                          (senders + offs).reshape(-1), (receivers + offs).reshape(-1),
                          mask.reshape(-1), B)


def molecule_loss(a: GNNArch, model, params: Optional[Params], feats, coords, senders,
                  receivers, mask, energy) -> torch.Tensor:
    """Mean squared error of the molecules' energies."""
    e = molecule_energies(a, model, params, feats, coords, senders, receivers, mask)
    return torch.mean((e - energy) ** 2)


def molecule_step(a: GNNArch, model, params: Params, opt: AdamWState, feats, coords, senders,
                  receivers, mask, energy, *, opt_cfg: OptConfig = TRAIN_OPT, mesh=None):
    """molecule: returns (params, opt, loss).  With `mesh`, the molecules
    are this rank's block (`_step`)."""
    return _step(lambda p: molecule_loss(a, model, p, feats, coords, senders, receivers,
                                         mask, energy), params, opt, opt_cfg, mesh)


def smoke_inputs(n: int, device):
    """`gnn_smoke`'s features (n, 8), coordinates (n, 3) f32 and labels
    (n,) int32 in [0, 4), under the reference's keys 0, 1 and 2."""
    return (prng.normal(prng.key(0), (n, 8), device), prng.normal(prng.key(1), (n, 3), device),
            prng.randint(prng.key(2), n, 0, 4, device))


def gnn_smoke(a: GNNArch, device: DeviceLike = "cuda") -> None:
    """A reduced full-graph forward, loss, gradients and energy: finite,
    of the right shapes."""
    from repro_torch.graphs.generators import erdos_renyi

    g = erdos_renyi(120, avg_deg=5.0, seed=0, device=device)
    dev = g.device
    mask = g.edge_mask
    s = torch.where(mask, g.senders, 0)
    r = torch.where(mask, g.receivers, 0)
    feats, coords, labels = smoke_inputs(g.n_nodes, dev)
    model = a.init(8, 4, key=prng.key(3), device=dev)
    with torch.no_grad():
        logits = a.node_logits(model, None, feats, coords, s, r, mask)
    if logits.shape != (g.n_nodes, 4) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{a.arch_id} smoke logits: shape {tuple(logits.shape)}, "
                             "not all finite")
    loss, _ = loss_and_grads(
        lambda p: full_graph_loss(a, model, p, feats, coords, s, r, mask, labels),
        train_params(model))
    if not bool(torch.isfinite(loss)):
        raise AssertionError(f"{a.arch_id} smoke loss {float(loss)} not finite")
    with torch.no_grad():
        e = a.graph_energy(model, None, feats, coords, s, r, mask, 1)
    if not bool(torch.isfinite(e).all()):
        raise AssertionError(f"{a.arch_id} smoke energy {e.tolist()} not finite")


# --------------------------------------------------------------------------
# the dry run's cells
# --------------------------------------------------------------------------

def _fake_model(a: GNNArch, d_in: int, n_out: int, device):
    """The arch's module with fake parameters on `device`
    (`configs.common.fake_module`) and those as `train_params` gives them."""
    from repro_torch.configs.common import fake_module

    model = fake_module(lambda: a.init(d_in, n_out, seed=0, device="meta"), device)
    return model, train_params(model)


def _batch_block(mesh, n: int) -> int:
    """This rank's share of n examples split over the batch axes."""
    from repro_torch.dist.sharding import _axis_size, data_axes

    return -(-n // _axis_size(mesh, data_axes(mesh)))


def _full_graph_cell(a: GNNArch, shape_name: str) -> Cell:
    s = GNN_SHAPES[shape_name]
    N, E, DF, NO = s["n_nodes"], s["n_edges"], s["d_feat"], s["n_out"]
    E2 = 2 * E  # both directions

    def build(mesh, variant: str = "memory"):
        from repro_torch.dist.collectives import DataGroup
        from repro_torch.dist.graph import GraphSplit, _flat_group
        from repro_torch.dist.sharding import P, mesh_device

        dev = mesh_device(mesh)
        group = DataGroup(_flat_group(mesh))
        block = -(-N // group.size)
        n_edges = _pad512(E2) // group.size
        split = GraphSplit(mesh, group, N, 0, block, block,
                           torch.empty((n_edges,), dtype=torch.int64, device=dev),
                           torch.empty((n_edges,), dtype=torch.int64, device=dev),
                           torch.empty((n_edges,), dtype=torch.bool, device=dev))
        model, whole = _fake_model(a, DF, NO, dev)
        params, opt = place_gnn_state(whole, mesh)

        def step(params, opt, feats, coords, senders, receivers, mask, labels):
            return full_graph_step(a, model, params, opt, feats, coords, senders, receivers,
                                   mask, labels, split=split)

        inputs = (params, opt, torch.empty((block, DF), device=dev),
                  torch.empty((block, 3), device=dev), *split.edges,
                  torch.empty((block,), dtype=torch.int32, device=dev))
        flat = tuple(mesh.mesh_dim_names)
        p_specs = {k: P() for k in whole}
        specs = (p_specs, AdamWState(step=P(), m=p_specs, v=p_specs), P(flat, None),
                 P(flat, None), P(flat), P(flat), P(flat), P(flat))
        return step, inputs, specs

    return Cell(arch=a.arch_id, shape=shape_name, kind="train", build=build,
                model_flops=3.0 * a.fwd_flops(N, E2, DF))


def _minibatch_cell(a: GNNArch) -> Cell:
    s = GNN_SHAPES["minibatch_lg"]
    N, E, DF, NO = s["n_nodes"], s["n_edges"], s["d_feat"], s["n_out"]
    B, fanout = s["batch_nodes"], s["fanout"]
    # sampled tree size: B + B·f1 + B·f1·f2 nodes, B·f1 + B·f1·f2 edges
    n_tree = B * (1 + fanout[0] + fanout[0] * fanout[1])
    e_tree = B * (fanout[0] + fanout[0] * fanout[1])

    def build(mesh, variant: str = "memory"):
        from repro_torch.dist.lookup import TableSplit, block_rows
        from repro_torch.dist.sharding import P, data_axes, mesh_device

        dev = mesh_device(mesh)
        b = _batch_block(mesh, B)
        model, whole = _fake_model(a, DF, NO, dev)
        params, opt = place_gnn_state(whole, mesh)
        tables = TableSplit.of(mesh)
        NP, EP = _pad512(N + 1), _pad512(E)
        nb, eb = block_rows(NP, tables.group.size), block_rows(EP, tables.group.size)
        f1, f2 = fanout

        def step(params, opt, u1, u2, indptr, indices, feats_tab, coords_tab, labels_tab,
                 seeds):
            return minibatch_step(a, model, params, opt, (u1, u2), indptr, indices, feats_tab,
                                  coords_tab, labels_tab, seeds, mesh=mesh, tables=tables)

        def i32(*shape):
            return torch.empty(shape, dtype=torch.int32, device=dev)

        inputs = (params, opt, i32(b, f1), i32(b, f1, f2), i32(NP), i32(eb),
                  torch.empty((nb, DF), device=dev), torch.empty((nb, 3), device=dev), i32(nb),
                  i32(b))
        d = data_axes(mesh)
        flat = tuple(mesh.mesh_dim_names)
        p_specs = {k: P() for k in whole}
        specs = (p_specs, AdamWState(step=P(), m=p_specs, v=p_specs), P(d, None, None),
                 P(d, None, None, None), P(), P(flat), P(flat, None), P(flat, None), P(flat),
                 P(d))
        return step, inputs, specs

    return Cell(arch=a.arch_id, shape="minibatch_lg", kind="train", build=build,
                model_flops=3.0 * a.fwd_flops(n_tree, e_tree, DF),
                note="fixed-fanout 15×10 neighbour sampling on device")


def _molecule_cell(a: GNNArch) -> Cell:
    s = GNN_SHAPES["molecule"]
    N, E, B, DF = s["n_nodes"], s["n_edges"], s["batch"], s["d_feat"]

    def build(mesh, variant: str = "memory"):
        from repro_torch.dist.sharding import P, data_axes, mesh_device

        dev = mesh_device(mesh)
        b = _batch_block(mesh, B)
        model, whole = _fake_model(a, DF, 1, dev)
        params, opt = place_gnn_state(whole, mesh)

        def step(params, opt, feats, coords, senders, receivers, mask, energy):
            return molecule_step(a, model, params, opt, feats, coords, senders, receivers,
                                 mask, energy, mesh=mesh)

        inputs = (params, opt, torch.empty((b, N, DF), device=dev),
                  torch.empty((b, N, 3), device=dev),
                  torch.empty((b, E), dtype=torch.int32, device=dev),
                  torch.empty((b, E), dtype=torch.int32, device=dev),
                  torch.empty((b, E), dtype=torch.bool, device=dev),
                  torch.empty((b,), device=dev))
        d = data_axes(mesh)
        p_specs = {k: P() for k in whole}
        specs = (p_specs, AdamWState(step=P(), m=p_specs, v=p_specs), P(d, None, None),
                 P(d, None, None), P(d, None), P(d, None), P(d, None), P(d))
        return step, inputs, specs

    return Cell(arch=a.arch_id, shape="molecule", kind="train", build=build,
                model_flops=3.0 * B * a.fwd_flops(N, E, DF))


def gnn_cells(a: GNNArch) -> Dict[str, Cell]:
    return {
        "full_graph_sm": _full_graph_cell(a, "full_graph_sm"),
        "minibatch_lg": _minibatch_cell(a),
        "ogb_products": _full_graph_cell(a, "ogb_products"),
        "molecule": _molecule_cell(a),
    }
