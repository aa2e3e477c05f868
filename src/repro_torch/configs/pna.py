"""pna [arXiv:2004.05718]: 4 layers, d_hidden=75, aggregators
mean/max/min/std, scalers identity/amplification/attenuation (counterpart
of `repro.configs.pna`)."""
from repro_torch.configs.common import ArchDef, register
from repro_torch.configs.gnn_cells import GNNArch, call, gnn_cells, gnn_smoke, per_graph_sum
from repro_torch.models.gnn.pna import PNA

D_HIDDEN, N_LAYERS = 75, 4


def _init(d_in, n_out, *, seed=0, key=None, device="cuda"):
    return PNA(d_in, d_hidden=D_HIDDEN, n_layers=N_LAYERS, n_out=n_out, seed=seed, key=key,
               device=device)


def _node_logits(model, params, feats, coords, s, r, mask, split=None):
    del coords
    _, logits = call(model, params, feats, s, r, mask, split=split)
    return logits


def _graph_energy(model, params, feats, coords, s, r, mask, n_graphs=1):
    del coords
    _, logits = call(model, params, feats, s, r, mask, n_graphs=n_graphs)
    return per_graph_sum(logits[:, 0], n_graphs)


def _fwd_flops(n, e, d_feat):
    d = d_feat
    f = 0.0
    for _ in range(N_LAYERS):
        f += 2.0 * e * (2 * d) * D_HIDDEN          # edge message MLP
        f += 4.0 * e * D_HIDDEN                    # 4 segment reductions
        f += 2.0 * n * (12 * D_HIDDEN + d) * D_HIDDEN  # mix layer
        d = D_HIDDEN
    return f


GNN = GNNArch("pna", _init, _node_logits, _graph_energy, _fwd_flops)
ARCH = register(ArchDef(arch_id=GNN.arch_id, family="gnn", cells=gnn_cells(GNN),
                        smoke=lambda device="cuda": gnn_smoke(GNN, device=device), config=GNN))
