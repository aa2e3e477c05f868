"""EGNN, E(n)-Equivariant GNN (Satorras et al., arXiv:2102.09844): the
counterpart of `repro.models.gnn.egnn`.  Config: 4 layers, d_hidden=64.

    m_ij  = φ_e(h_i, h_j, ‖x_i − x_j‖²)
    x_i'  = x_i + (1/deg_i) Σ_j (x_i − x_j) · φ_x(m_ij)
    h_i'  = φ_h(h_i, Σ_j m_ij)

Invariant features interact only through squared distances, and the
coordinate updates are linear combinations of relative vectors, so
rotations and translations commute with the model.

As in the reference, an edge from a vertex to itself (the molecule batches'
masked self-loops) has ‖x_i − x_j‖ = 0, where the gradient of the square
root is infinite: once the coordinates depend on the parameters (from layer
2 on) the gradients are not finite.  The port computes what the reference
computes and adds no epsilon of its own.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.core import prng
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.gnn.common import MLP, segment_sum


class EGNNLayer(nn.Module):
    def __init__(self, d_in: int, d_hidden: int, *, keys, device: torch.device):
        super().__init__()
        self.phi_e = MLP((2 * d_in + 1, d_hidden, d_hidden), key=keys[0], device=device)
        self.phi_x = MLP((d_hidden, d_hidden, 1), key=keys[1], device=device)
        self.phi_h = MLP((d_in + d_hidden, d_hidden, d_hidden), key=keys[2], device=device)


class EGNN(nn.Module):
    """`layers[i]` (`phi_e`, `phi_x`, `phi_h`) and `head`, f32, He-scaled
    as `egnn_init(key)` draws them (layer i's MLPs under keys 3i to 3i + 2
    of `split(key, 3 n_layers + 2)`, the head under the last) on `device`.
    `key` defaults to `prng.key(seed)`."""

    def __init__(self, d_in: int, d_hidden: int = 64, n_layers: int = 4, n_out: int = 1,
                 *, seed: int = 0, key: Optional[prng.Key] = None,
                 device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        ks = prng.split(prng.key(seed) if key is None else key, 3 * n_layers + 2)
        dims = [d_in] + [d_hidden] * n_layers
        self.layers = nn.ModuleList(
            EGNNLayer(d, d_hidden, keys=ks[3 * i:3 * i + 3], device=dev)
            for i, d in enumerate(dims[:-1]))
        self.head = MLP((d_hidden, n_out), key=ks[-1], device=dev)

    def forward(self, h: torch.Tensor, x: torch.Tensor, senders: torch.Tensor,
                receivers: torch.Tensor, mask: torch.Tensor, *, split=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """h (N, d_in) invariants, x (N, 3) coordinates -> (h', x', head
        output (N, n_out)); the reference's energy is the head output's
        sum over the graph.  `split`: a `dist.graph.GraphSplit`, h, x and
        the outputs this rank's vertex rows, the edges the split's; the
        senders' h and x (which moves every layer and carries gradient)
        are gathered together once a layer."""
        n = h.shape[0]
        s, r = senders.long(), receivers.long()
        w = mask.to(h.dtype)[:, None]
        deg = segment_sum(w[:, 0], receivers, n)
        inv_deg = (1.0 / torch.clamp(deg, min=1.0))[:, None]

        for layer in self.layers:
            h_src, x_src = h, x
            if split is not None:
                hx = split.gather(torch.cat([h, x], dim=-1))
                h_src, x_src = hx[:, :h.shape[-1]], hx[:, h.shape[-1]:]
            rel = x[r] - x_src[s]                               # (E, 3)
            d2 = torch.sum(rel * rel, dim=-1, keepdim=True)
            m = layer.phi_e(torch.cat([h[r], h_src[s], d2], dim=-1)) * w
            # a tanh-bounded coefficient and a distance-normalised direction
            # keep the 4-layer coordinate recursion stable
            coef = torch.tanh(layer.phi_x(m))                   # (E, 1)
            rel_n = rel / (torch.sqrt(d2) + 1.0)
            x = x + segment_sum(rel_n * coef * w, receivers, n) * inv_deg
            agg = segment_sum(m, receivers, n)
            h = layer.phi_h(torch.cat([h, agg], dim=-1))
        return h, x, self.head(h)
