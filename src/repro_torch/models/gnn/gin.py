"""GIN (Xu et al., arXiv:1810.00826), the counterpart of
`repro.models.gnn.gin`: config gin-tu is 5 layers, d_hidden=64, sum
aggregator, learnable ε.

    h_i' = MLP((1+ε)·h_i + Σ_{j∈N(i)} h_j)

The sum aggregation is A × H, so GIN has two backends:
  "segment"  edge gather + segment sum (the one training runs);
  "tiled"    the paper's BSR tiled SpMM, `spmv_tiled(backend="pallas")`
             (the Hopper split SpMV, `hopper.tc_spmv`, on CUDA tensors; its
             plain version on CPU tensors) with the feature matrix as the
             multi-lane RHS: one launch a layer.
The kernel launch has no gradient, and neither has the reference's Pallas
backend, so the tiled backend raises where autograd would need one rather
than return a detached result.

The reference's `gin_apply(params, ...)` is `GIN.__call__` here (`forward`:
nn.Module's own `apply` recursively applies a function to submodules).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.core import prng
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.gnn.common import MLP, gather_scatter_sum

BACKENDS = ("segment", "tiled")


class GINLayer(nn.Module):
    def __init__(self, d_in: int, d_hidden: int, *, key: prng.Key, device: torch.device):
        super().__init__()
        self.mlp = MLP((d_in, d_hidden, d_hidden), key=key, device=device)
        self.eps = nn.Parameter(torch.zeros((), device=device))


class GIN(nn.Module):
    """`layers[i]` (`mlp`, `eps`) and `head`, f32, drawn as `gin_init(key)`
    draws them (He-scaled MLPs, ε = 0; layer i under the i-th key of
    `split(key, n_layers + 1)`, the head under the last) on `device`.
    `key` defaults to `prng.key(seed)`."""

    def __init__(self, d_in: int, d_hidden: int = 64, n_layers: int = 5, n_out: int = 7,
                 *, seed: int = 0, key: Optional[prng.Key] = None,
                 device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        ks = prng.split(prng.key(seed) if key is None else key, n_layers + 1)
        dims = [d_in] + [d_hidden] * n_layers
        self.layers = nn.ModuleList(
            GINLayer(d, d_hidden, key=k, device=dev) for k, d in zip(ks, dims[:-1]))
        self.head = MLP((d_hidden, n_out), key=ks[-1], device=dev)

    def forward(self, h: torch.Tensor, senders: torch.Tensor, receivers: torch.Tensor,
                mask: torch.Tensor, *, tiled=None, backend: str = "segment", split=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """h (N, d_in) -> (node embeddings (N, d_hidden), head output (N,
        n_out)).  `tiled`: the graph's `BlockTiledGraph`, for "tiled".
        `split`: a `dist.graph.GraphSplit`, h and the outputs this rank's
        vertex rows, the edges the split's (segment backend only)."""
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; valid: {BACKENDS}")
        if split is not None and backend != "segment":
            raise ValueError('a split graph runs on backend="segment"')
        n = h.shape[0]
        for layer in self.layers:
            if backend == "tiled":
                agg = _tiled_sum(tiled, h)
            else:
                agg = gather_scatter_sum(h, senders, receivers, mask, n, split)
            h = layer.mlp((1.0 + layer.eps) * h + agg)
        return h, self.head(h)


def _tiled_sum(tiled, h: torch.Tensor) -> torch.Tensor:
    """A × h through the split SpMV: h padded to whole tiles, in f32."""
    from repro_torch.core.spmv import spmv_tiled

    if tiled is None:
        raise ValueError('backend="tiled" needs the graph\'s tiling (tiled=)')
    if torch.is_grad_enabled() and h.requires_grad:
        raise RuntimeError(
            'GIN backend="tiled" has no gradient (the kernel launch is not '
            'differentiable); train on backend="segment" or run under torch.no_grad()')
    n = h.shape[0]
    pad = tiled.n_padded - n
    hp = torch.nn.functional.pad(h, (0, 0, 0, pad)) if pad else h
    return spmv_tiled(tiled, hp.to(torch.float32).contiguous(), backend="pallas")[:n].to(h.dtype)
