"""Shared GNN substrate: the MLP (counterpart of `repro.models.gnn.common`'s
`MLP`, `mlp_init` and `mlp_apply`).

The reference keeps an MLP as weights `ws[i]` of shape (in, out) applied as
`x @ w + b`; here each layer is an `nn.Linear`, whose weight is (out, in),
so carried weights are transposed (`models.deepfm.deepfm_params_from_numpy`).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device


class MLP(nn.Module):
    """f32 linear layers with ReLU between them and none after the last (the
    deep tower DeepFM uses).  Initialised as the reference does: weights
    normal with the He scale (2 / in)^0.5, biases zero, drawn from
    `generator`."""

    def __init__(self, dims: Sequence[int], *, generator: torch.Generator,
                 device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.layers = nn.ModuleList()
        for i, o in zip(dims[:-1], dims[1:]):
            layer = nn.utils.skip_init(nn.Linear, i, o, device=dev)
            with torch.no_grad():
                layer.weight.copy_(torch.randn((o, i), generator=generator, device=dev)
                                   * (2.0 / i) ** 0.5)
                layer.bias.zero_()
            self.layers.append(layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *hidden, last = self.layers
        for layer in hidden:
            x = torch.relu(layer(x))
        return last(x)
