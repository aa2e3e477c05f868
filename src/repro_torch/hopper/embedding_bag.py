"""Embedding bag on Hopper (the DeepFM lookup) and its gradient: wrappers,
plain versions, launch counts, and the autograd function that joins them.

  embedding_bag           out[b] = Σ_k w[b, k] · table[idx[b, k]]; replaces
                          the Pallas `_bag_kernel` (wrapper
                          `ops.embedding_bag`)
  embedding_bag_backward  grad_table[r] = Σ_{idx[b, k] = r} w[b, k] ·
                          grad_out[b], dense (V, D); the reference has no
                          Pallas backward (jax.grad of its gathers is XLA's
                          scatter-add)

Both kernels live in `csrc/embedding_bag.cu`.  On CUDA tensors a wrapper
launches its kernel on the current stream, or raises; on CPU tensors it
runs its plain-torch version below (what the CPU tests use and
`chip_smoke.py` holds each kernel against).  `embedding_bag.launches` and
`embedding_bag_backward.launches` count the launches.

Where a gradient of the table is wanted, `embedding_bag` (and
`embedding_bag_plain`, with both plain versions) runs as a
`torch.autograd.Function` whose backward is `embedding_bag_backward`.  A
gradient of the weights, or of a bf16 table, is refused: no path trains
them, and the reference trains f32 tables.  With gradients off (serving
runs under `torch.inference_mode()`) the bag is one forward launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.hopper.launch import check, entry, on_cpu, ptr, raise_on_error, stream

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
TABLE_DTYPES = (torch.float32, torch.bfloat16)


def _bag_sum_plain(table: torch.Tensor, indices: torch.Tensor,
                   weights: Optional[torch.Tensor]) -> torch.Tensor:
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
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    fn = entry("embedding_bag", "embedding_bag_launch",
               [_P, _I, _P, _P, _P, _I64, _I, _I, _P])
    raise_on_error("embedding_bag", fn(
        ptr(table), int(table.dtype == torch.bfloat16), ptr(indices), ptr(weights),
        ptr(out), B, K, D, stream(dev),
    ))
    return out


def _forward(table: torch.Tensor, indices: torch.Tensor,
             weights: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel on CUDA tensors (counted), the plain sum on CPU ones."""
    if on_cpu(table, indices, weights):
        return _bag_sum_plain(table, indices, weights)
    out = _launch(table, indices, weights)
    if out.numel():                       # the kernel launches nothing for an empty output
        embedding_bag.launches += 1
    return out


# positions a segment of the backward's sum spans at most: kSegment in
# csrc/embedding_bag.cu, which the plain version's order must match
SEGMENT = 32


def _fold(acc: torch.Tensor, dest: torch.Tensor, terms: torch.Tensor,
          step: torch.Tensor) -> None:
    """acc[dest[i]] += terms[i], the terms of step 0 first, then step 1, ...;
    within one step the destinations are distinct, so each add is one
    rounding.  One host sync for the steps' sizes."""
    by_step = torch.argsort(step, stable=True)
    at = 0
    for count in torch.bincount(step).tolist():
        take = by_step[at:at + count]
        at += count
        d = dest[take]
        acc[d] = acc[d] + terms[take]


def embedding_bag_backward_plain(grad_out: torch.Tensor, indices: torch.Tensor,
                                 weights: Optional[torch.Tensor], n_rows: int) -> torch.Tensor:
    """Plain-torch gradient of the bag sum with respect to the table, in
    the kernel's order.  The flat slots b·K + k, stably sorted by row, are
    cut into segments at every multiple of SEGMENT and wherever the row
    changes; each segment sums its terms `w · g` (one rounding each) in slot
    order from 0, then each row sums its segments in order from 0."""
    B, K = indices.shape
    D = grad_out.shape[1]
    dev = grad_out.device
    out = torch.zeros((n_rows, D), dtype=torch.float32, device=dev)
    if B * K == 0 or D == 0:
        return out
    rows, order = torch.sort(indices.reshape(-1), stable=True)
    terms = grad_out.float()[order // K]
    if weights is not None:
        terms = weights.reshape(-1).float()[order, None] * terms
    pos = torch.arange(rows.numel(), device=dev)
    run_open = torch.ones_like(rows, dtype=torch.bool)
    run_open[1:] = rows[1:] != rows[:-1]
    seg_open = run_open | (pos % SEGMENT == 0)
    seg_first = torch.cummax(torch.where(seg_open, pos, 0), 0).values
    part = torch.zeros_like(terms)
    _fold(part, seg_first, terms, pos - seg_first)
    starts = pos[seg_open]
    k = torch.arange(starts.numel(), device=dev)
    run_first = torch.cummax(torch.where(run_open[starts], k, 0), 0).values
    _fold(out, rows[starts].long(), part[starts], k - run_first)
    return out


def _launch_backward(grad_out: torch.Tensor, indices: torch.Tensor,
                     weights: Optional[torch.Tensor], n_rows: int) -> torch.Tensor:
    dev = grad_out.device
    if dev.type != "cuda":
        raise ValueError(f"the Hopper kernel needs CUDA tensors, got {dev}")
    if grad_out.ndim != 2 or indices.ndim != 2:
        raise ValueError(f"grad_out must be (B, D) and indices (B, K), got shapes "
                         f"{tuple(grad_out.shape)} and {tuple(indices.shape)}")
    (B, K), D = indices.shape, grad_out.shape[1]
    check("grad_out", grad_out, torch.float32, (B, D), dev)
    check("indices", indices, torch.int32, (B, K), dev)
    if weights is not None:
        check("weights", weights, torch.float32, (B, K), dev)
    if n_rows < 0:
        raise ValueError(f"n_rows must be >= 0, got {n_rows}")
    # the sort only arranges the slots; the kernels sum each row in this order
    rows, order = torch.sort(indices.reshape(-1), stable=True)
    part = torch.empty((B * K, D), dtype=torch.float32, device=dev)    # segment sums
    out = torch.empty((n_rows, D), dtype=torch.float32, device=dev)
    fn = entry("embedding_bag", "embedding_bag_backward_launch",
               [_P, _P, _P, _P, _P, _P, _I64, _I64, _I, _I, _P])
    raise_on_error("embedding_bag_backward", fn(
        ptr(rows), ptr(order), ptr(weights), ptr(grad_out), ptr(part), ptr(out), n_rows,
        B * K, K, D, stream(dev),
    ))
    return out


def embedding_bag_backward(grad_out: torch.Tensor, indices: torch.Tensor,
                           weights: Optional[torch.Tensor], n_rows: int) -> torch.Tensor:
    """Gradient of `embedding_bag(table, indices, weights)` with respect to
    a table of `n_rows` rows, given `grad_out` (B, D) f32: dense (n_rows, D)
    f32, rows no slot touches 0.  Deterministic: each row sums its slots in
    one fixed order (see the plain version), so two calls give the same
    bits, equal to the plain version's.  One call launches the kernel pair
    of `csrc/embedding_bag.cu` (segment sums, then runs) and counts one."""
    if on_cpu(grad_out, indices, weights):
        return embedding_bag_backward_plain(grad_out, indices, weights, n_rows)
    out = _launch_backward(grad_out, indices, weights, n_rows)
    if indices.numel() and out.numel():   # else the entry only clears the output
        embedding_bag_backward.launches += 1
    return out


embedding_bag_backward.launches = 0


class _Bag(torch.autograd.Function):
    """The bag sum with the hand-written backward (or, `plain`, both plain
    versions), differentiable in the table only."""

    @staticmethod
    def forward(ctx, table, indices, weights, plain: bool):
        ctx.save_for_backward(indices, weights)
        ctx.n_rows, ctx.plain = table.shape[0], plain
        return (_bag_sum_plain if plain else _forward)(table, indices, weights)

    @staticmethod
    def backward(ctx, grad_out):
        indices, weights = ctx.saved_tensors
        backward = embedding_bag_backward_plain if ctx.plain else embedding_bag_backward
        return backward(grad_out.contiguous(), indices, weights, ctx.n_rows), None, None, None


def _wants_grad(table: torch.Tensor, weights: Optional[torch.Tensor]) -> bool:
    """Whether autograd needs the table's gradient; raises where it would
    need one that no kernel computes."""
    if not torch.is_grad_enabled():
        return False
    if weights is not None and weights.requires_grad:
        raise RuntimeError("embedding_bag has no backward for its weights: pass weights "
                           "that do not require grad")
    if table.requires_grad and table.dtype != torch.float32:
        raise RuntimeError(f"embedding_bag trains f32 tables only, got a {table.dtype} "
                           "table that requires grad")
    return table.requires_grad


def embedding_bag_plain(table: torch.Tensor, indices: torch.Tensor,
                        weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of `embedding_bag`, on any device: the plain sum,
    and where the table's gradient is wanted, the plain backward."""
    if _wants_grad(table, weights):
        return _Bag.apply(table, indices, weights, True)
    return _bag_sum_plain(table, indices, weights)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ_k weights[b, k] · table[indices[b, k]] -> (B, D) float32.

    `table` (V, D) f32 or bf16 (summed in f32), `indices` (B, K) int32,
    `weights` (B, K) f32, or None for ones; a weight of 0 masks its slot.
    Indices must lie in [0, V): the kernels do not check them, since a
    check on the card would cost a host sync per call.  Where the f32
    table requires grad, the backward is `embedding_bag_backward`."""
    if _wants_grad(table, weights):
        return _Bag.apply(table, indices, weights, False)
    return _forward(table, indices, weights)


embedding_bag.launches = 0
