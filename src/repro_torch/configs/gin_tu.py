"""gin-tu [arXiv:1810.00826]: 5 layers, d_hidden=64, sum aggregator,
learnable ε (counterpart of `repro.configs.gin_tu`).  Sum aggregation is
A × H, so this arch also runs the paper's tiled SpMM (`GIN(...,
backend="tiled")`); its cells train on the segment backend."""
from repro_torch.configs.common import ArchDef, register
from repro_torch.configs.gnn_cells import GNNArch, call, gnn_cells, gnn_smoke, per_graph_sum
from repro_torch.models.gnn.gin import GIN

D_HIDDEN, N_LAYERS = 64, 5


def _init(d_in, n_out, *, seed=0, key=None, device="cuda"):
    return GIN(d_in, d_hidden=D_HIDDEN, n_layers=N_LAYERS, n_out=n_out, seed=seed, key=key,
               device=device)


def _node_logits(model, params, feats, coords, s, r, mask, split=None):
    del coords
    _, logits = call(model, params, feats, s, r, mask, split=split)
    return logits


def _graph_energy(model, params, feats, coords, s, r, mask, n_graphs=1):
    return per_graph_sum(_node_logits(model, params, feats, coords, s, r, mask)[:, 0], n_graphs)


def _fwd_flops(n, e, d_feat):
    f = 2.0 * e * d_feat + 2.0 * n * (d_feat * D_HIDDEN + D_HIDDEN * D_HIDDEN)
    f += (N_LAYERS - 1) * (
        2.0 * e * D_HIDDEN + 4.0 * n * D_HIDDEN * D_HIDDEN
    )
    return f


GNN = GNNArch("gin-tu", _init, _node_logits, _graph_energy, _fwd_flops)
ARCH = register(ArchDef(arch_id=GNN.arch_id, family="gnn", cells=gnn_cells(GNN),
                        smoke=lambda device="cuda": gnn_smoke(GNN, device=device), config=GNN))
