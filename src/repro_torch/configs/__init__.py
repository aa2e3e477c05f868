"""Model configurations and their steps (counterpart of `repro.configs`,
without the mesh and `Cell` machinery): `deepfm`; the GNN family's four
archs by arch id in `GNN_ARCHS`, with their cells in `gnn_cells`; the LM
family's five arch modules (each with its full `CONFIG` and its `SMOKE`)
by arch id in `LM_ARCHS`, with their cells in `lm_cells`."""
from repro_torch.configs import (
    deepseek_v3_671b,
    egnn,
    gin_tu,
    mace,
    mixtral_8x22b,
    nemotron4_340b,
    pna,
    qwen3_0_6b,
    qwen15_0_5b,
)

GNN_ARCHS = {m.GNN.arch_id: m.GNN for m in (gin_tu, pna, egnn, mace)}
LM_ARCHS = {m.ARCH_ID: m for m in (qwen15_0_5b, qwen3_0_6b, nemotron4_340b,
                                   mixtral_8x22b, deepseek_v3_671b)}
