"""egnn [arXiv:2102.09844]: 4 layers, d_hidden=64, E(n) equivariance
(counterpart of `repro.configs.egnn`)."""
from repro_torch.configs.common import ArchDef, register
from repro_torch.configs.gnn_cells import GNNArch, call, gnn_cells, gnn_smoke, per_graph_sum
from repro_torch.models.gnn.egnn import EGNN

D_HIDDEN, N_LAYERS = 64, 4


def _init(d_in, n_out, *, seed=0, key=None, device="cuda"):
    return EGNN(d_in, d_hidden=D_HIDDEN, n_layers=N_LAYERS, n_out=n_out, seed=seed, key=key,
                device=device)


def _node_logits(model, params, feats, coords, s, r, mask, split=None):
    _, _, logits = call(model, params, feats, coords, s, r, mask, split=split)
    return logits


def _graph_energy(model, params, feats, coords, s, r, mask, n_graphs=1):
    return per_graph_sum(_node_logits(model, params, feats, coords, s, r, mask).sum(-1),
                         n_graphs)


def _fwd_flops(n, e, d_feat):
    d = d_feat
    f = 0.0
    for _ in range(N_LAYERS):
        f += 2.0 * e * (2 * d + 1) * D_HIDDEN + 2.0 * e * D_HIDDEN * D_HIDDEN
        f += 2.0 * e * D_HIDDEN * D_HIDDEN            # phi_x
        f += 2.0 * n * (d + D_HIDDEN) * D_HIDDEN + 2.0 * n * D_HIDDEN * D_HIDDEN
        d = D_HIDDEN
    return f


GNN = GNNArch("egnn", _init, _node_logits, _graph_energy, _fwd_flops)
ARCH = register(ArchDef(arch_id=GNN.arch_id, family="gnn", cells=gnn_cells(GNN),
                        smoke=lambda device="cuda": gnn_smoke(GNN, device=device), config=GNN))
