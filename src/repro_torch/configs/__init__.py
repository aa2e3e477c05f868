"""Architecture registry (counterpart of `repro.configs`): importing this
package registers every assigned arch and the paper's own tcmis suite into
`REGISTRY` (`common.ArchDef`, each with its `common.Cell`s, which
`launch.dryrun` builds on fake tensors).

  from repro_torch.configs import REGISTRY
  REGISTRY["qwen3-0.6b"].cells["train_4k"].build(mesh)

Also: `deepfm`; the GNN family's four archs by arch id in `GNN_ARCHS`,
with their steps in `gnn_cells`; the LM family's five arch modules (each
with its full `CONFIG` and its `SMOKE`) by arch id in `LM_ARCHS`, with
their steps in `lm_cells`."""
from repro_torch.configs.common import REGISTRY, ArchDef, Cell

# importing each module registers its ArchDef, in the reference's order
from repro_torch.configs import (  # noqa: F401
    qwen15_0_5b,
    qwen3_0_6b,
    nemotron4_340b,
    mixtral_8x22b,
    deepseek_v3_671b,
    egnn,
    gin_tu,
    pna,
    mace,
    deepfm,
    tcmis,
)

ASSIGNED_ARCHS = [
    "qwen1.5-0.5b", "qwen3-0.6b", "nemotron-4-340b", "mixtral-8x22b",
    "deepseek-v3-671b", "egnn", "gin-tu", "pna", "mace", "deepfm",
]
GNN_ARCHS = {m.GNN.arch_id: m.GNN for m in (gin_tu, pna, egnn, mace)}
LM_ARCHS = {m.ARCH_ID: m for m in (qwen15_0_5b, qwen3_0_6b, nemotron4_340b,
                                   mixtral_8x22b, deepseek_v3_671b)}

__all__ = ["REGISTRY", "ArchDef", "Cell", "ASSIGNED_ARCHS", "GNN_ARCHS", "LM_ARCHS"]
