"""Model configurations and their steps (counterpart of `repro.configs`,
without the mesh and `Cell` machinery): `deepfm`, and the GNN family's
four archs by arch id in `GNN_ARCHS`, with their cells in `gnn_cells`."""
from repro_torch.configs import egnn, gin_tu, mace, pna

GNN_ARCHS = {m.GNN.arch_id: m.GNN for m in (gin_tu, pna, egnn, mace)}
