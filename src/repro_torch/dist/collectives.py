"""The collectives the data-, tensor- and expert-parallel steps run, over
`torch.distributed` groups.

`DataGroup` is the data-parallel group a step passes down to the model
(`transformer.lm_loss(..., dp=)`, `moe.moe_ffn(..., dp=)`,
`deepfm.VocabParallelBag`): its ranks hold consecutive blocks of the
global batch, rank r block r.  Its non-differentiable collectives carry
the global terms of a loss (counts, expert ids, fields); its
`reduce_scatter` is differentiable, with an all-gather as its backward,
and `gather_leaf` is FSDP's: an all-gather of a parameter's blocks whose
backward reduce-scatters the gradient back to this rank's block.

`ModelGroup` is the tensor-parallel group, the ranks of a mesh's 'model'
axis (`tp=`).  Its ops are Megatron's pair and what a vocab-parallel
softmax needs, each differentiable where the model differentiates it:
`copy` (the identity, whose backward sums the gradient over the group: a
replicated tensor entering a parallel region), `sum` (the sum over the
group, whose backward is the identity: a parallel region's partial
outputs leaving it), `gather` (an all-gather along a dim whose backward
takes this rank's slice: a split tensor that replicated code reads
whole) and `max` (no gradient).  A tensor computed the same way on every
rank of the group gets the same gradient on every rank, so a leaf
replicated over 'model' needs no reduction of its gradient over it.
Sequence parallelism (Megatron's) adds the pair that replaces `copy` and
`sum` at a layer's blocks: `gather_sum` (an all-gather along a dim whose
backward reduce-scatters the gradient: each rank's code after it
computes its part of it) and `scatter_sum` (a reduce-scatter whose
backward all-gathers); with them `block` (this rank's block of a dim, a
view) and `part` (the identity, whose backward keeps this rank's block
of the gradient: a value every rank computes whole entering code where
gradients are parts).  Every sum over the ranks of a bf16 tensor runs
in f32 and rounds once, so that on one rank each op is the identity.

`data_group(mesh, what)` gives the (DataGroup, ModelGroup) pair of a mesh
with one batch axis larger than 1 (or none) and an optional 'model' axis
(None without one); a mesh with two batch axes larger than 1 raises.

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

def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """(n, ...) on each rank -> (world · n, ...) in rank order, on every rank."""
    size = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather(out, x, group=group)
    return out


def _gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's x concatenated along `dim` in rank order, contiguous."""
    blocks = gather_rows(x.reshape((1,) + tuple(x.shape)), group)
    return torch.cat(blocks.unbind(0), dim=dim)


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype a sum over ranks of `dtype` runs in: f32 for bf16 and f16."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def _reduce_scatter_dim(x: torch.Tensor, dim: int, group, wide: bool = False) -> torch.Tensor:
    """This rank's block along `dim` of the sum over the group's ranks of x;
    with `wide` a bf16 or f16 x is summed in f32 and rounded once."""
    size = dist.get_world_size(group)
    if x.shape[dim] % size:
        raise ValueError(f"{x.shape[dim]} entries of dim {dim} do not split over {size} ranks")
    rows = x.movedim(dim, 0)
    if wide:
        rows = rows.to(_wide(x.dtype), memory_format=torch.contiguous_format)
    rows = rows.contiguous()
    out = rows.new_empty((rows.shape[0] // size,) + tuple(rows.shape[1:]))
    _reduce_scatter(out, rows, group=group)
    return out.movedim(0, dim).to(x.dtype).contiguous()


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter_dim(x, 0, group)

    @staticmethod
    def backward(ctx, grad):
        return gather_rows(grad, ctx.group), None


class _GatherLeaf(torch.autograd.Function):
    """All-gather along `dim`; backward reduce-scatter along it (`wide`:
    a bf16 gradient summed in f32)."""

    @staticmethod
    def forward(ctx, x, dim, group, wide=False):
        ctx.dim, ctx.group, ctx.wide = dim, group, wide
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter_dim(grad, ctx.dim, ctx.group, ctx.wide), None, None, None


class _ScatterSum(torch.autograd.Function):
    """Reduce-scatter along `dim` (a bf16 x summed in f32); backward
    all-gather along it."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter_dim(x, dim, group, wide=True)

    @staticmethod
    def backward(ctx, grad):
        return _gather_dim(grad, ctx.dim, ctx.group), None, None


class _Part(torch.autograd.Function):
    """The identity; backward this rank's block of the gradient along
    `dim`, zeros elsewhere."""

    @staticmethod
    def forward(ctx, x, dim, rank, size):
        ctx.dim, ctx.rank, ctx.size = dim, rank, size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        n = grad.shape[ctx.dim] // ctx.size
        out = torch.zeros_like(grad)
        out.narrow(ctx.dim, ctx.rank * n, n).copy_(grad.narrow(ctx.dim, ctx.rank * n, n))
        return out, None, None, None


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over the group's ranks of x, as a new tensor; a bf16 or f16 x is
    summed in f32 and rounded once, as one device's matmul rounds its
    f32 sum once, not after each step of the collective's ring."""
    out = x.to(_wide(x.dtype), copy=True, memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Copy(torch.autograd.Function):
    """The identity; backward the sum of the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _Gather(torch.autograd.Function):
    """All-gather along `dim`; backward this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(), None, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over `group`'s ranks of x; backward the identity."""
    return _SumOver.apply(x, group)


class _Group:
    """A step's group of ranks (`group` None: the default group)."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """(size · n, ...) partial sums on each rank -> rank r's block of
        their sum over ranks; its backward all-gathers the gradient."""
        return _ReduceScatter.apply(x, self.group)


class DataGroup(_Group):
    """The data-parallel ranks of a step."""

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's block of rows, in rank order (no gradient)."""
        return gather_rows(x.detach(), self.group)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks, as a new tensor (no gradient)."""
        out = x.detach().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def gather_leaf(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """FSDP: a parameter's blocks along `dim` gathered whole; backward
        each rank's gradient (its part of the batch's) reduce-scattered
        to its block, summed over the ranks."""
        return _GatherLeaf.apply(x, dim, self.group)


class ModelGroup(_Group):
    """The tensor-parallel ranks of a step: a mesh's 'model' axis."""

    def splits(self, n: int) -> bool:
        """Whether a dim of n entries splits evenly over the ranks: the
        placement rule's test (`sharding._spec_with`), which on one rank
        splits every dim into one block."""
        return n % self.size == 0

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """x; backward Σ over the ranks of the gradient."""
        return _Copy.apply(x, self.group)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks of x; backward the identity."""
        return _SumOver.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's x concatenated along `dim`; backward this rank's
        slice of the gradient (the code after it runs the same on every
        rank)."""
        return _Gather.apply(x, dim, self.group)

    def gather_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's x concatenated along `dim`; backward the sum over
        the ranks of the gradient, this rank's block of it (a
        reduce-scatter, bf16 summed in f32): each rank's code after it
        computes its part of the gradient."""
        return _GatherLeaf.apply(x, dim, self.group, True)

    def scatter_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block along `dim` of Σ over the ranks of x (a
        reduce-scatter; a bf16 x summed in f32 and rounded once, so that
        on one rank it is x); backward all-gathers the gradient."""
        return _ScatterSum.apply(x, dim, self.group)

    def block(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of x along `dim` (a view; no collective)."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)

    def part(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """x; backward this rank's block of the gradient along `dim`, zeros
        elsewhere: a value computed whole on every rank, whose gradient
        each rank computes in full, handed to code where each rank's
        gradient is its part."""
        return _Part.apply(x, dim, self.rank, self.size)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the ranks, as a new tensor (no gradient)."""
        out = x.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out


def data_group(mesh, what: str):
    """(DataGroup, ModelGroup or None) of a step on `mesh`: every axis but
    'model' is a batch axis, and the data group is the one batch axis
    larger than 1 (or the first, if none is); a step over several such
    axes ('pod' and 'data' both > 1) raises.  The model group is the
    'model' axis's, of any size (None if the mesh has no such axis).  A
    CUDA mesh needs an NCCL group."""
    mesh_device(mesh)
    sizes = dict(_axes(mesh))
    batch = [a for a in sizes if a != "model"]
    split = [a for a in batch if sizes[a] > 1]
    if len(split) > 1:
        raise NotImplementedError(f"{what} runs over one batch axis; {split} are all > 1")
    tp = ModelGroup(mesh.get_group("model")) if "model" in sizes else None
    return DataGroup(mesh.get_group((split or batch)[0])), tp


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
