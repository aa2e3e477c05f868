"""Gradient compression for the data-parallel all-reduce: top-k with error
feedback.  The counterpart of `repro.train.compression` (`CompressedLeaf`,
`compress_leaf`, `decompress_leaf`, `compress_tree`, `decompress_tree`,
`ef_init`, `compress_with_error_feedback`, `compressed_bytes`), over trees
of tensors (`train.tree`):

    comp, ef = compress_tree(grads + ef_residual, ratio)
    grads'   = decompress_tree(comp)          # what gets all-reduced
    ef'      = (grads + ef_residual) - grads' # stays local

The top k of |g| follow `jax.lax.top_k`: descending |g|, the lower
position first among equal values, so the kept positions and their order
are the reference's, ties included (`torch.topk` breaks ties otherwise).
The selection is O(n) in the leaf's size: the k-th largest value, every
position above it, and the lowest-positioned ties to make up k; only the k
kept entries are sorted.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.train import tree as T


class CompressedLeaf(NamedTuple):
    values: torch.Tensor    # (k,) kept values
    indices: torch.Tensor   # (k,) int32 flat positions
    size: int               # original flat size


def _is_compressed(x) -> bool:
    return isinstance(x, CompressedLeaf)


def top_k_positions(a: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the k largest entries of the flat tensor `a`, in
    `jax.lax.top_k`'s order (descending value, lower position first)."""
    kth = torch.kthvalue(a, a.numel() - k + 1).values          # the k-th largest
    above = torch.nonzero(a > kth).view(-1)
    ties = torch.nonzero(a == kth).view(-1)[:k - above.numel()]
    idx = torch.sort(torch.cat([above, ties])).values           # position order
    return idx[torch.sort(a[idx], descending=True, stable=True).indices]


def compress_leaf(g: torch.Tensor, ratio: float) -> CompressedLeaf:
    flat = g.reshape(-1).float()
    k = max(1, int(flat.numel() * ratio))
    idx = top_k_positions(flat.abs(), k)
    return CompressedLeaf(values=flat[idx], indices=idx.to(torch.int32), size=flat.numel())


def decompress_leaf(c: CompressedLeaf, shape) -> torch.Tensor:
    out = torch.zeros((c.size,), dtype=torch.float32, device=c.values.device)
    out[c.indices.long()] = c.values
    return out.reshape(shape)


def compress_tree(grads: Any, ratio: float) -> Any:
    return T.tree_map(lambda g: compress_leaf(g, ratio), grads)


def decompress_tree(comp: Any, like: Any) -> Any:
    return T.tree_map(lambda c, g: decompress_leaf(c, g.shape).to(g.dtype), comp, like,
                      is_leaf=_is_compressed)


def ef_init(grads_like: Any) -> Any:
    return T.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                      grads_like)


def compress_with_error_feedback(grads: Any, ef: Any, ratio: float) -> Tuple[Any, Any]:
    """Returns (dense decompressed grads to reduce and apply, new EF residual)."""
    corrected = T.tree_map(lambda g, e: g.float() + e, grads, ef)
    comp = compress_tree(corrected, ratio)
    dense = decompress_tree(comp, corrected)
    new_ef = T.tree_map(lambda c, d: c - d, corrected, dense)
    applied = T.tree_map(lambda d, g: d.to(g.dtype), dense, grads)
    return applied, new_ef


def compressed_bytes(comp: Any) -> int:
    """Wire bytes of a compressed tree (values f32 + indices int32)."""
    return sum(leaf.values.numel() * 4 + leaf.indices.numel() * 4
               for leaf in T.leaves(comp, is_leaf=_is_compressed) if _is_compressed(leaf))
