"""The collectives the data- and expert-parallel steps run, over a
`torch.distributed` group.

`DataGroup` is the data-parallel group a step passes down to the model
(`transformer.lm_loss(..., dp=)`, `moe.moe_ffn(..., dp=)`,
`deepfm.VocabParallelBag`): its ranks hold consecutive blocks of the
global batch, rank r block r.  Its non-differentiable collectives carry
the global terms of a loss (counts, expert ids, fields); its
`reduce_scatter` is differentiable, with an all-gather as its backward.
`data_group(mesh, what)` gives it for a mesh whose batch axes are the
whole group, and refuses a 'model' axis larger than 1, which no step of
this package executes yet.

`mesh_barrier(mesh)` blocks the host until every rank of a mesh has
reached it (a placed `checkpoint.save` ends with it).

`sum_over(x, group)` is the expert-parallel MoE's one collective: a sum
over the expert ranks whose backward is the identity (each rank's partial
output enters the sum once, so its gradient is the sum's).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import _axes, mesh_device

# the newer spellings where this torch has them
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

# ROADMAP.md's items for what the steps refuse
MODEL_AXIS_ITEM = "ROADMAP.md Queue 1 [19].5 (the LM's model axis and FSDP)"
DEEPFM_MODEL_ITEM = "ROADMAP.md Queue 1 [19].7 (DeepFM's MLP tower under 'model' > 1)"


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """(n, ...) on each rank -> (world · n, ...) in rank order, on every rank."""
    size = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather(out, x, group=group)
    return out


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        size = dist.get_world_size(group)
        if x.shape[0] % size:
            raise ValueError(f"{x.shape[0]} rows do not split over {size} ranks")
        out = x.new_empty((x.shape[0] // size,) + tuple(x.shape[1:]))
        _reduce_scatter(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return gather_rows(grad, ctx.group), None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over `group`'s ranks of x; backward the identity."""
    return _SumOver.apply(x, group)


class DataGroup:
    """The data-parallel ranks of a step (`group` None: the default group)."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's block of rows, in rank order (no gradient)."""
        return gather_rows(x.detach(), self.group)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks, as a new tensor (no gradient)."""
        out = x.detach().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """(size · n, ...) partial sums on each rank -> rank r's block of
        their sum over ranks; its backward all-gathers the gradient."""
        return _ReduceScatter.apply(x, self.group)


def data_group(mesh, what: str, item: str = MODEL_AXIS_ITEM) -> DataGroup:
    """The DataGroup of a data-parallel step on `mesh`: every axis but
    'model' is a batch axis and 'model' must be 1 (else the step would run
    another layout: it raises, naming the ROADMAP item).  The group is the
    one batch axis larger than 1 (or the first, if none is); a step over
    several such axes ('pod' and 'data' both > 1) raises.  A CUDA mesh
    needs an NCCL group."""
    mesh_device(mesh)
    sizes = dict(_axes(mesh))
    if sizes.get("model", 1) > 1:
        raise NotImplementedError(
            f"{what} runs data-parallel only; a mesh with 'model' = {sizes['model']} "
            f"waits for {item}")
    batch = [a for a in sizes if a != "model"]
    split = [a for a in batch if sizes[a] > 1]
    if len(split) > 1:
        raise NotImplementedError(f"{what} runs over one batch axis; {split} are all > 1")
    return DataGroup(mesh.get_group((split or batch)[0]))


def mesh_all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    """Σ over every rank of `mesh`, in place: one all-reduce per mesh
    dimension over its group (on a one-rank mesh, none)."""
    for i in range(mesh.ndim):
        if mesh.size(i) > 1:
            dist.all_reduce(x, group=mesh.get_group(i))
    return x


def mesh_barrier(mesh) -> None:
    """Return once every rank of `mesh` has reached this call.  The host
    reads the all-reduced count back, so it waits on NCCL too, where a
    collective alone only orders the device's stream."""
    n = int(mesh_all_reduce(torch.ones(1, device=mesh_device(mesh)), mesh).item())
    if n != mesh.size():
        raise RuntimeError(f"mesh barrier counted {n} of {mesh.size()} ranks")
