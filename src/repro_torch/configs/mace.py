"""mace [arXiv:2206.07697]: 2 layers, 128 channels, l_max=2, correlation
order 3, n_rbf=8, E(3)-ACE product basis (counterpart of
`repro.configs.mace`).  A classification cell (n_out != 1) widens the
readout to C -> 16 -> n_out, drawn under `fold_in(key, 99)` as the
reference draws its new readout."""
from repro_torch.configs.common import ArchDef, register
from repro_torch.configs.gnn_cells import GNNArch, call, gnn_cells, gnn_smoke, per_graph_sum
from repro_torch.models.gnn.mace import MACE, coupling_tensors

CHANNELS, N_LAYERS, N_RBF = 128, 2, 8


def _init(d_in, n_out, *, seed=0, key=None, device="cuda"):
    return MACE(d_in, channels=CHANNELS, n_layers=N_LAYERS, n_rbf=N_RBF, n_out=n_out,
                seed=seed, key=key, device=device)


def _node_logits(model, params, feats, coords, s, r, mask, split=None):
    _, logits = call(model, params, feats, coords, s, r, mask, split=split)
    return logits


def _graph_energy(model, params, feats, coords, s, r, mask, n_graphs=1):
    return per_graph_sum(_node_logits(model, params, feats, coords, s, r, mask).sum(-1),
                         n_graphs)


def _fwd_flops(n, e, d_feat):
    cts = coupling_tensors()
    path_flops = sum(
        2.0 * (2 * l1 + 1) * (2 * l2 + 1) * (2 * l3 + 1) for l1, l2, l3, _ in cts
    )
    f = 2.0 * n * d_feat * CHANNELS
    for _ in range(N_LAYERS):
        f += 2.0 * e * (N_RBF * 64 + 64 * len(cts) * CHANNELS)   # radial MLP
        f += e * path_flops * CHANNELS                           # interaction
        f += 2.0 * n * path_flops * CHANNELS                     # B2 + B3
        f += 2.0 * n * 9 * 3 * CHANNELS * CHANNELS               # mixes (Σ_l (2l+1)·3C·C)
    return f


GNN = GNNArch("mace", _init, _node_logits, _graph_energy, _fwd_flops)
ARCH = register(ArchDef(arch_id=GNN.arch_id, family="gnn", cells=gnn_cells(GNN),
                        smoke=lambda device="cuda": gnn_smoke(GNN, device=device), config=GNN))
