"""The GNN family (counterpart of `repro.models.gnn`): GIN, PNA, EGNN and
MACE over the shared edge-index segment substrate (`common`), and
`gnn_params_from_numpy`, which carries the reference's parameter trees
across.  GIN's sum aggregation also runs on the paper's BSR tiled SpMM
(`backend="tiled"`): A × H through the Hopper split SpMV with the feature
matrix as a multi-lane RHS.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.gnn.common import (
    MLP,
    degrees_from_edges,
    gather_scatter_sum,
    segment_max,
    segment_mean,
    segment_sum,
)
from repro_torch.models.gnn.egnn import EGNN
from repro_torch.models.gnn.gin import GIN
from repro_torch.models.gnn.mace import MACE
from repro_torch.models.gnn.pna import PNA

# the top-level keys of each arch's reference parameter tree
_TREE_KEYS = {
    "gin-tu": {"layers", "head"},
    "pna": {"layers", "head"},
    "egnn": {"layers", "head"},
    "mace": {"embed", "layers", "readout"},
}


def _carry(prefix: str, x, out: Dict[str, torch.Tensor]) -> None:
    if hasattr(x, "ws") and hasattr(x, "bs"):       # the reference's MLP(ws, bs)
        for i, (w, b) in enumerate(zip(x.ws, x.bs)):
            out[f"{prefix}layers.{i}.weight"] = torch.from_numpy(
                np.array(np.asarray(w, dtype=np.float32).T, order="C"))
            out[f"{prefix}layers.{i}.bias"] = torch.from_numpy(np.array(b, dtype=np.float32))
    elif isinstance(x, dict):
        for k, v in x.items():
            _carry(f"{prefix}{k}.", v, out)
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _carry(f"{prefix}{i}.", v, out)
    else:
        out[prefix[:-1]] = torch.from_numpy(np.array(x, dtype=np.float32))


def gnn_params_from_numpy(arch_id: str, tree) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree of `arch_id` (its `*_init` output, or
    an AdamW moment of the same structure), with numpy leaves, as the
    port's state dict: MLP weights transposed (the reference's (in, out)
    against `nn.Linear`'s (out, in)), MACE's int-keyed `mix` / `res` under
    str(l)."""
    if arch_id not in _TREE_KEYS:
        raise ValueError(f"unknown GNN arch {arch_id!r}; valid: {sorted(_TREE_KEYS)}")
    if set(tree) != _TREE_KEYS[arch_id]:
        raise ValueError(f"{arch_id} tree has keys {sorted(tree)}, "
                         f"expected {sorted(_TREE_KEYS[arch_id])}")
    out: Dict[str, torch.Tensor] = {}
    _carry("", tree, out)
    return out


__all__ = [
    "MLP", "segment_sum", "segment_max", "segment_mean", "gather_scatter_sum",
    "degrees_from_edges", "GIN", "PNA", "EGNN", "MACE", "gnn_params_from_numpy",
]
