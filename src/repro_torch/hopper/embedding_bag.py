"""Embedding bag on Hopper (the DeepFM lookup): wrapper, plain version,
launch count.

  embedding_bag  out[b] = Σ_k w[b, k] · table[idx[b, k]]; replaces the
                 Pallas `_bag_kernel` (wrapper `ops.embedding_bag`)

The kernel lives in `csrc/embedding_bag.cu`.  On CUDA tensors the wrapper
launches it on the current stream, or raises; on CPU tensors it runs the
plain-torch version below (what the CPU tests use and `chip_smoke.py`
holds the kernel against).  `embedding_bag.launches` counts the launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.hopper.launch import check, entry, on_cpu, ptr, raise_on_error, stream

_P, _I = ctypes.c_void_p, ctypes.c_int
TABLE_DTYPES = (torch.float32, torch.bfloat16)


def embedding_bag_plain(table: torch.Tensor, indices: torch.Tensor,
                        weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain-torch bag sum in the Pallas kernel's order: from zeros,
    `out += w[:, k] · float(table[idx[:, k]])` for k = 0 .. K-1."""
    B, K = indices.shape
    if weights is None:
        weights = torch.ones((B, K), dtype=torch.float32, device=table.device)
    w = weights.float()
    out = torch.zeros((B, table.shape[1]), dtype=torch.float32, device=table.device)
    for k in range(K):
        out += w[:, k, None] * table[indices[:, k]].float()
    return out


def _launch(table: torch.Tensor, indices: torch.Tensor,
            weights: Optional[torch.Tensor]) -> torch.Tensor:
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"the Hopper kernel needs CUDA tensors, got {dev}")
    if table.ndim != 2 or indices.ndim != 2:
        raise ValueError(f"table must be (V, D) and indices (B, K), got shapes "
                         f"{tuple(table.shape)} and {tuple(indices.shape)}")
    (V, D), (B, K) = table.shape, indices.shape
    check("table", table, TABLE_DTYPES, (V, D), dev)
    check("indices", indices, torch.int32, (B, K), dev)
    if weights is not None:
        check("weights", weights, torch.float32, (B, K), dev)
    if torch.is_grad_enabled() and (table.requires_grad or (
            weights is not None and weights.requires_grad)):
        raise RuntimeError("embedding_bag has no backward kernel: call it under "
                           "torch.no_grad() or torch.inference_mode()")
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    fn = entry("embedding_bag", "embedding_bag_launch",
               [_P, _I, _P, _P, _P, ctypes.c_int64, _I, _I, _P])
    raise_on_error("embedding_bag", fn(
        ptr(table), int(table.dtype == torch.bfloat16), ptr(indices), ptr(weights),
        ptr(out), B, K, D, stream(dev),
    ))
    return out


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ_k weights[b, k] · table[indices[b, k]] -> (B, D) float32.

    `table` (V, D) f32 or bf16 (summed in f32), `indices` (B, K) int32,
    `weights` (B, K) f32, or None for ones; a weight of 0 masks its slot.
    Indices must lie in [0, V): the kernel does not check them, since a
    check on the card would cost a host sync per call.  The kernel has no
    backward: on the card, call it with gradients off."""
    if on_cpu(table, indices, weights):
        return embedding_bag_plain(table, indices, weights)
    out = _launch(table, indices, weights)
    if out.numel():                       # the kernel launches nothing for an empty output
        embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
