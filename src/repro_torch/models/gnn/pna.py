"""PNA, Principal Neighbourhood Aggregation (Corso et al., arXiv:2004.05718):
the counterpart of `repro.models.gnn.pna`.  Config: 4 layers, d_hidden=75,
aggregators {mean, max, min, std}, scalers {identity, amplification,
attenuation}.

Per layer: messages m_ij = MLP([h_i ‖ h_j]); the 4 aggregations of m over
N(i) are scaled by the 3 degree scalers (12 concatenated views) and mixed
by a linear layer.  δ, the mean log-degree, comes from the graph, as in the
paper; a block-diagonal batch of `n_graphs` equal graphs takes it per graph
(what the reference's vmap over molecules computes).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.core import prng
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.gnn.common import MLP, degrees_from_edges, segment_max, segment_sum

_NEG = -1e9


class PNALayer(nn.Module):
    def __init__(self, d_in: int, d_hidden: int, *, keys, device: torch.device):
        super().__init__()
        self.msg = MLP((2 * d_in, d_hidden), key=keys[0], device=device)
        self.mix = MLP((12 * d_hidden + d_in, d_hidden), key=keys[1], device=device)


class PNA(nn.Module):
    """`layers[i]` (`msg`, `mix`) and `head`, f32, He-scaled as
    `pna_init(key)` draws them (layer i's MLPs under keys 2i and 2i + 1 of
    `split(key, 2 n_layers + 2)`, the head under the last) on `device`.
    `key` defaults to `prng.key(seed)`."""

    def __init__(self, d_in: int, d_hidden: int = 75, n_layers: int = 4, n_out: int = 7,
                 *, seed: int = 0, key: Optional[prng.Key] = None,
                 device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        ks = prng.split(prng.key(seed) if key is None else key, 2 * n_layers + 2)
        dims = [d_in] + [d_hidden] * n_layers
        self.layers = nn.ModuleList(
            PNALayer(d, d_hidden, keys=ks[2 * i:2 * i + 2], device=dev)
            for i, d in enumerate(dims[:-1]))
        self.head = MLP((d_hidden, n_out), key=ks[-1], device=dev)

    def forward(self, h: torch.Tensor, senders: torch.Tensor, receivers: torch.Tensor,
                mask: torch.Tensor, *, n_graphs: int = 1, split=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """h (N, d_in) -> (node embeddings, head output (N, n_out)).  The N
        vertices are `n_graphs` equal blocks with no edge between them.
        `split`: a `dist.graph.GraphSplit` of one graph, h and the outputs
        this rank's vertex rows, the edges the split's: degrees and the
        aggregations stay on the rank (every in-edge of a vertex is on its
        rank), δ is the mean over the whole graph (Σ over the ranks / N)."""
        n = h.shape[0]
        deg = degrees_from_edges(receivers, mask, n)
        log_deg = torch.log1p(deg)
        if split is None:
            delta = log_deg.reshape(n_graphs, -1).mean(dim=1).repeat_interleave(n // n_graphs)
        elif n_graphs == 1:
            delta = (split.all_sum(log_deg.sum()) / split.n_nodes).expand(n)
        else:
            raise ValueError("a split graph is one graph (n_graphs=1)")
        delta = torch.maximum(delta, delta.new_tensor(1e-6))[:, None]
        log_deg = log_deg[:, None]
        s_amp = log_deg / delta                                          # amplification
        s_att = delta / torch.maximum(log_deg, log_deg.new_tensor(1e-6))  # attenuation
        s_att = torch.where(deg[:, None] > 0, s_att, 0.0)

        s, r = senders.long(), receivers.long()
        for layer in self.layers:
            src = h if split is None else split.gather(h)
            m = layer.msg(torch.cat([h[r], src[s]], dim=-1))
            mean, mx, mn, std, _ = aggregate(m, receivers, mask, n)
            aggs = torch.cat([mean, mx, mn, std], dim=-1)                # (N, 4d)
            scaled = torch.cat([aggs, aggs * s_amp, aggs * s_att], dim=-1)  # (N, 12d)
            h = layer.mix(torch.cat([scaled, h], dim=-1))
        return h, self.head(h)


def aggregate(m: torch.Tensor, receivers: torch.Tensor, mask: torch.Tensor, n: int):
    """mean / max / min / std of the messages into each vertex, masked
    slots neutral, and the count; 0 for a vertex with none (the
    reference's `_aggregate`)."""
    w = mask[:, None].to(m.dtype)
    s = segment_sum(m * w, receivers, n)
    cnt = segment_sum(w[:, 0], receivers, n)
    cnt1 = torch.clamp(cnt, min=1.0)[:, None]
    mean = s / cnt1
    some = cnt[:, None] > 0
    mx = segment_max(torch.where(mask[:, None], m, _NEG), receivers, n)
    mx = torch.where(some, mx, 0.0)
    mn = -segment_max(torch.where(mask[:, None], -m, _NEG), receivers, n)
    mn = torch.where(some, mn, 0.0)
    sq = segment_sum(m * m * w, receivers, n)
    # maximum, not clamp: at var == 0 (every one-message vertex) jax's max
    # passes half the gradient, as torch.maximum does
    var = torch.maximum(sq / cnt1 - mean * mean, sq.new_zeros(()))
    std = torch.sqrt(var + 1e-8)
    return mean, mx, mn, std, cnt
