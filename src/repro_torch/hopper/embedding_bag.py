"""Embedding bag on Hopper (the DeepFM lookup) and its gradient: wrappers,
plain versions, launch counts, and the autograd function that joins them.

  embedding_bag           out[b] = Σ_k w[b, k] · table[idx[b, k]]; replaces
                          the Pallas `_bag_kernel` (wrapper
                          `ops.embedding_bag`)
  embedding_bag_backward  grad_table[r] = Σ_{idx[b, k] = r} (w[b, k] ·
                          grad_out[b] + extra[b, k]), dense (V, D), where
                          `extra` is the gradient of a gather table[idx];
                          the reference has no Pallas backward (jax.grad of
                          its gathers is XLA's scatter-add)
  sort_slots              the backward's slot plan: the flat slots sorted
                          by row and their runs (CUB in `csrc/slot_sort.cu`)

The kernels live in `csrc/embedding_bag.cu`.  On CUDA tensors a wrapper
launches its kernel on the current stream, or raises; on CPU tensors it
runs its plain-torch version below (what the CPU tests use and
`chip_smoke.py` holds each kernel against).  `embedding_bag.launches` and
`embedding_bag_backward.launches` count the launches, `sort_slots.calls`
the sorts.  On fake tensors (the dry run's) each of the three has a fake
branch: empty outputs of its kernel's shapes, the launch reported
(`hopper.launch.report`), nothing launched or counted, no plain version.

Where a gradient of the table is wanted, `embedding_bag` (and
`embedding_bag_plain`, with both plain versions) runs as a
`torch.autograd.Function` whose backward is `embedding_bag_backward`.  With
`gather=True` it also returns the gathered rows table[idx], and their
gradient enters the same backward launch as `extra`.  Bags over one index
array share a `SlotPlan`, so one sort serves all their backwards.  A
gradient of the weights, or of a bf16 table, is refused: no path trains
them, and the reference trains f32 tables.  With gradients off (serving
runs under `torch.inference_mode()`) the bag is one forward launch.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from repro_torch.hopper.launch import (
    check,
    entry,
    fake,
    on_cpu,
    ptr,
    raise_on_error,
    report,
    stream,
)

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


def _fake_forward(table: torch.Tensor, indices: torch.Tensor,
                  weights: Optional[torch.Tensor]) -> torch.Tensor:
    """The bag's fake branch: an empty (B, D) f32 output; reported by the
    bound's arithmetic (`chip_smoke.py` `bound_bag`) with every gathered
    row distinct, at most V (a fake tensor holds no indices): those rows,
    the indices and weights read once, the output written once; an add
    (and a multiply) per gathered element."""
    (V, D), (B, K) = table.shape, indices.shape
    nbytes = (min(B * K, V) * D * table.element_size() + indices.numel() * 4
              + (0 if weights is None else weights.numel() * 4) + B * D * 4)
    report("embedding_bag", nbytes, B * K * D * (1 if weights is None else 2))
    return torch.empty((B, D), dtype=torch.float32, device=table.device)


def _forward(table: torch.Tensor, indices: torch.Tensor,
             weights: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel on CUDA tensors (counted), the plain sum on CPU ones, the
    fake branch on fake ones."""
    if fake(table, indices, weights):
        return _fake_forward(table, indices, weights)
    if on_cpu(table, indices, weights):
        return _bag_sum_plain(table, indices, weights)
    out = _launch(table, indices, weights)
    if out.numel():                       # the kernel launches nothing for an empty output
        embedding_bag.launches += 1
    return out


# positions a segment of the backward's sum spans at most: kSegment in
# csrc/embedding_bag.cu, which the plain version's order must match
SEGMENT = 32
# floats of output a dense-write CTA builds in shared memory: kTileFloats in
# csrc/embedding_bag.cu
TILE_FLOATS = 8192


def dense_rows(dim: int) -> int:
    """The rows one CTA of the backward's dense write owns at width `dim`:
    a multiple of 4 (its tile starts 16-byte aligned), at least 4."""
    return max(4, TILE_FLOATS // dim // 4 * 4)


@dataclasses.dataclass(frozen=True)
class SortedSlots:
    """The slot plan of a (B, K) index array: its B·K flat slots b·K + k
    stably sorted by row, and the runs of equal rows.  All int32, on the
    indices' device; entries of `run_rows` and `starts` past `n_runs` are
    unspecified."""
    rows: torch.Tensor       # (n,) the sorted rows
    order: torch.Tensor      # (n,) the flat slot at each sorted position
    run_rows: torch.Tensor   # (n,) run j's row, j < n_runs (ascending)
    starts: torch.Tensor     # (n + 1,) run j's first position; starts[n_runs] = n
    n_runs: torch.Tensor     # (1,) the number of runs


def _check_indices(indices: torch.Tensor, dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"the Hopper kernel needs CUDA tensors, got {dev}")
    if indices.ndim != 2:
        raise ValueError(f"indices must be (B, K), got shape {tuple(indices.shape)}")
    check("indices", indices, torch.int32, tuple(indices.shape), dev)
    if indices.numel() >= 2 ** 31 - 1:
        raise ValueError(f"{indices.numel()} slots: the slot plan holds int32 positions")


def sort_slots_plain(indices: torch.Tensor, n_rows: int) -> SortedSlots:
    """The slot plan in plain torch: a stable `torch.sort` of the flat
    indices, the runs from where the sorted row changes (a host sync)."""
    rows, order = torch.sort(indices.reshape(-1), stable=True)
    n, dev = rows.numel(), rows.device
    run_open = torch.ones((n,), dtype=torch.bool, device=dev)
    run_open[1:] = rows[1:] != rows[:-1]
    first = torch.nonzero(run_open).reshape(-1)
    n_runs = first.numel()
    run_rows = torch.zeros((n,), dtype=torch.int32, device=dev)
    run_rows[:n_runs] = rows[first]
    starts = torch.full((n + 1,), n, dtype=torch.int32, device=dev)
    starts[:n_runs] = first
    return SortedSlots(rows.to(torch.int32), order.to(torch.int32), run_rows, starts,
                       torch.tensor([n_runs], dtype=torch.int32, device=dev))


def sort_slots(indices: torch.Tensor, n_rows: int) -> SortedSlots:
    """The slot plan of `indices` (B, K) int32 into `n_rows` rows (every
    index in [0, n_rows)).  On CUDA tensors csrc/slot_sort.cu (CUB's radix
    sort on the key bits n_rows needs, 32-bit slots, run-length encoding;
    no host sync), counted in `sort_slots.calls`; on CPU tensors
    `sort_slots_plain`.  Both give the same arrays up to `n_runs`.  On fake
    indices: an empty plan, reported as the indices read once and the plan
    written once (a sort counts no operations here)."""
    if fake(indices):
        n, dev = indices.numel(), indices.device

        def i32(size):
            return torch.empty((size,), dtype=torch.int32, device=dev)

        report("sort_slots", n * 4 + 3 * n * 4 + (n + 1) * 4 + 4, 0.0)
        return SortedSlots(i32(n), i32(n), i32(n), i32(n + 1), i32(1))
    if on_cpu(indices):
        return sort_slots_plain(indices, n_rows)
    dev = indices.device
    _check_indices(indices, dev)
    n = indices.numel()
    end_bit = max(1, (max(n_rows, 1) - 1).bit_length())

    def i32(size):
        return torch.empty((size,), dtype=torch.int32, device=dev)

    slots = SortedSlots(i32(n), i32(n), i32(n), i32(n + 1), i32(1))
    scratch = i32(n + 1)
    temp_bytes = ctypes.c_int64(0)
    raise_on_error("slot_sort", entry("slot_sort", "slot_sort_temp_bytes", [_I64, _I, _P])(
        n, end_bit, ctypes.byref(temp_bytes)))
    temp = torch.empty((max(temp_bytes.value, 1),), dtype=torch.uint8, device=dev)
    fn = entry("slot_sort", "slot_sort_launch", [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                                                 _I, _P])
    raise_on_error("slot_sort", fn(
        ptr(indices), ptr(slots.rows), ptr(slots.order), ptr(slots.run_rows), ptr(slots.starts),
        ptr(slots.n_runs), ptr(scratch), ptr(temp), temp_bytes.value, n, end_bit, stream(dev),
    ))
    sort_slots.calls += 1
    return slots


sort_slots.calls = 0


class SlotPlan:
    """The slot plan of one index array, made on first use and kept: the
    backward launches over the same indices (DeepFM's two bags) share one
    sort.  `sorted(plain)` gives `sort_slots`' plan, or with `plain` the
    plain version's, so a path through the plain versions sorts in plain
    torch alone."""

    def __init__(self, indices: torch.Tensor, n_rows: int):
        self.indices, self.n_rows = indices, n_rows
        self._made = {}

    def sorted(self, plain: bool = False) -> SortedSlots:
        if plain not in self._made:
            make = sort_slots_plain if plain else sort_slots
            self._made[plain] = make(self.indices, self.n_rows)
        return self._made[plain]


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
                                 weights: Optional[torch.Tensor], n_rows: int, *,
                                 extra: Optional[torch.Tensor] = None,
                                 slots: Optional[SortedSlots] = None) -> torch.Tensor:
    """Plain-torch gradient of the bag sum (and of a gather `table[indices]`
    whose gradient is `extra` (B, K, D)) with respect to the table, in the
    kernel's order.  Each slot's term is `w · g[b] + extra[b, k]` (each
    product and add rounded once).  The flat slots b·K + k, stably sorted
    by row (`slots`, or `sort_slots_plain`), are cut into segments at every
    multiple of SEGMENT and wherever the row changes; each segment sums its
    terms in slot order from 0, then each row sums its segments in order
    from 0."""
    B, K = indices.shape
    D = grad_out.shape[1]
    dev = grad_out.device
    out = torch.zeros((n_rows, D), dtype=torch.float32, device=dev)
    if B * K == 0 or D == 0:
        return out
    slots = slots if slots is not None else sort_slots_plain(indices, n_rows)
    rows, order = slots.rows, slots.order.long()
    terms = grad_out.float()[order // K]
    if weights is not None:
        terms = weights.reshape(-1).float()[order, None] * terms
    if extra is not None:
        terms = terms + extra.reshape(-1, D).float()[order]
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
                     weights: Optional[torch.Tensor], n_rows: int,
                     extra: Optional[torch.Tensor], slots: Optional[SortedSlots]) -> torch.Tensor:
    dev = grad_out.device
    _check_indices(indices, dev)
    if grad_out.ndim != 2:
        raise ValueError(f"grad_out must be (B, D), got shape {tuple(grad_out.shape)}")
    (B, K), D = indices.shape, grad_out.shape[1]
    check("grad_out", grad_out, torch.float32, (B, D), dev)
    if weights is not None:
        check("weights", weights, torch.float32, (B, K), dev)
    if extra is not None:
        check("extra", extra, torch.float32, (B, K, D), dev)
    if n_rows < 0:
        raise ValueError(f"n_rows must be >= 0, got {n_rows}")
    if slots is None:
        slots = sort_slots(indices, n_rows)
    n = B * K
    for name, shape in (("rows", n), ("order", n), ("run_rows", n), ("starts", n + 1),
                        ("n_runs", 1)):
        check(f"slots.{name}", getattr(slots, name), torch.int32, (shape,), dev)
    part = torch.empty((n, D), dtype=torch.float32, device=dev)      # segment sums
    run_sum = torch.empty((n, D), dtype=torch.float32, device=dev)   # one row per run
    # each dense-write CTA's first run, and the count of runs at the end
    tile_first = torch.empty((-(-n_rows // dense_rows(max(D, 1))) + 1,), dtype=torch.int32,
                             device=dev)
    out = torch.empty((n_rows, D), dtype=torch.float32, device=dev)
    fn = entry("embedding_bag", "embedding_bag_backward_launch",
               [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P, _I64, _I64, _I, _I, _P])
    raise_on_error("embedding_bag_backward", fn(
        ptr(slots.rows), ptr(slots.order), ptr(slots.run_rows), ptr(slots.starts),
        ptr(slots.n_runs), ptr(weights), ptr(grad_out), ptr(extra), ptr(part), ptr(run_sum),
        ptr(tile_first), tile_first.numel(), ptr(out), n_rows, n, K, D, stream(dev),
    ))
    return out


def embedding_bag_backward(grad_out: torch.Tensor, indices: torch.Tensor,
                           weights: Optional[torch.Tensor], n_rows: int, *,
                           extra: Optional[torch.Tensor] = None,
                           slots: Optional[SortedSlots] = None) -> torch.Tensor:
    """Gradient of `embedding_bag(table, indices, weights)` with respect to
    a table of `n_rows` rows, given `grad_out` (B, D) f32, plus that of a
    gather `table[indices]` given `extra` (B, K, D) f32: dense (n_rows, D)
    f32, rows no slot touches 0.  `slots` is the indices' slot plan
    (`sort_slots`, or a `SlotPlan`'s), made here when not given.
    Deterministic: each row sums its slots in one fixed order (see the
    plain version), so two calls give the same bits, equal to the plain
    version's.  One call launches the kernels of `csrc/embedding_bag.cu`
    (segment sums, run sums, each dense-write CTA's first run, the dense
    write) and counts one.  On fake tensors: an empty gradient, reported by
    the bound's arithmetic (`chip_smoke.py` `bound_bag_backward`): the
    dense gradient written once, the indices, weights, grad_out and
    `extra` read once; an add (a multiply, the gather term's add) per slot
    and element."""
    if fake(grad_out, indices, weights, extra):
        (B, K), D = indices.shape, grad_out.shape[1]
        nbytes = (n_rows * D * 4 + indices.numel() * 4 + grad_out.numel() * 4
                  + (0 if weights is None else weights.numel() * 4)
                  + (0 if extra is None else extra.numel() * 4))
        report("embedding_bag_backward", nbytes,
               B * K * D * (1 + (weights is not None) + (extra is not None)))
        return torch.empty((n_rows, D), dtype=torch.float32, device=grad_out.device)
    if on_cpu(grad_out, indices, weights, extra):
        return embedding_bag_backward_plain(grad_out, indices, weights, n_rows, extra=extra,
                                            slots=slots)
    out = _launch_backward(grad_out, indices, weights, n_rows, extra, slots)
    if out.numel():                       # the entry launches nothing for an empty output
        embedding_bag_backward.launches += 1
    return out


embedding_bag_backward.launches = 0


class _Bag(torch.autograd.Function):
    """The bag sum, and with `gather` the rows `table[indices]` too, with
    the hand-written backward taking both gradients in one launch (or,
    `plain`, the plain versions), differentiable in the table only.  The
    backward sorts through `plan` (a `SlotPlan` shared with other bags over
    the same indices) or, without one, on its own."""

    @staticmethod
    def forward(ctx, table, indices, weights, plain: bool, plan, gather: bool):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(indices, weights)
        ctx.n_rows, ctx.dim, ctx.plain, ctx.plan = table.shape[0], table.shape[1], plain, plan
        out = (_bag_sum_plain if plain else _forward)(table, indices, weights)
        return (out, table[indices]) if gather else out

    @staticmethod
    def backward(ctx, grad_out, grad_rows=None):
        indices, weights = ctx.saved_tensors
        if grad_out is None:
            grad_out = torch.zeros((indices.shape[0], ctx.dim), dtype=torch.float32,
                                   device=indices.device)
        slots = None if ctx.plan is None else ctx.plan.sorted(ctx.plain)
        backward = embedding_bag_backward_plain if ctx.plain else embedding_bag_backward
        extra = None if grad_rows is None else grad_rows.contiguous()
        grad = backward(grad_out.contiguous(), indices, weights, ctx.n_rows, extra=extra,
                        slots=slots)
        return grad, None, None, None, None, None


def _plan_for(plan: Optional[SlotPlan], indices: torch.Tensor) -> Optional[SlotPlan]:
    if plan is not None and plan.indices is not indices:
        raise ValueError("the SlotPlan was made for another index tensor")
    return plan


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
                        weights: Optional[torch.Tensor] = None, *, gather: bool = False,
                        plan: Optional[SlotPlan] = None):
    """The plain version of `embedding_bag`, on any device: the plain sum
    (and gather), and where the table's gradient is wanted, the plain
    backward over the plan's plain sort."""
    if _wants_grad(table, weights):
        return _Bag.apply(table, indices, weights, True, _plan_for(plan, indices), gather)
    out = _bag_sum_plain(table, indices, weights)
    return (out, table[indices]) if gather else out


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: Optional[torch.Tensor] = None, *, gather: bool = False,
                  plan: Optional[SlotPlan] = None):
    """Σ_k weights[b, k] · table[indices[b, k]] -> (B, D) float32; with
    `gather`, also the rows `table[indices]` (B, K, D), a plain gather.

    `table` (V, D) f32 or bf16 (summed in f32), `indices` (B, K) int32,
    `weights` (B, K) f32, or None for ones; a weight of 0 masks its slot.
    Indices must lie in [0, V): the kernels do not check them, since a
    check on the card would cost a host sync per call.  Where the f32
    table requires grad, the backward is one `embedding_bag_backward`
    launch for the sum's gradient and the gathered rows' together, over
    `plan`'s sort (a `SlotPlan` of `indices` shared with other bags over
    them) or a sort of its own."""
    if _wants_grad(table, weights):
        return _Bag.apply(table, indices, weights, False, _plan_for(plan, indices), gather)
    out = _forward(table, indices, weights)
    return (out, table[indices]) if gather else out


embedding_bag.launches = 0
