"""Partition-spec policies (counterpart of `repro.dist.sharding`): how each
parameter and activation family maps onto a mesh, and how a spec becomes a
DTensor placement.

Axis convention, as the reference's: the mesh has a 'model' axis (tensor
parallelism) and one or more batch axes, 'data', optionally preceded by
'pod'.  `data_axes` returns the batch axes as a tuple; specs place that
tuple on batch-like dimensions, so one policy serves (data, model) and
(pod, data, model) meshes unchanged.  Every rule is divisibility-guarded:
a dimension that does not divide by its target axis size stays
replicated.

`P` is the port's spec: one entry per tensor dimension,
None (replicated), an axis name, or a tuple of axis names (sharded over
their product, the first name major), as `jax.sharding.PartitionSpec`.
The policies read only axis names and sizes, so they take a
`torch.distributed.device_mesh.DeviceMesh` or a `MeshShape` (names and
sizes, no group: the counterpart of `jax.sharding.AbstractMesh`).  Their
trees are the port's: `transformer.param_shapes` / `init_lm` for the LM
(leaves with a `.shape`: tensors, "meta" tensors included) and
`configs.deepfm.train_params` for DeepFM, whose MLP weights are
`nn.Linear`'s (out, in), the transpose of the reference's (in, out).

`placements(spec, mesh)` gives the DTensor placements of a spec (per mesh
dimension, `Shard(d)` or `Replicate()`); `distribute(tree, specs, mesh)`
is the counterpart of `jax.device_put` under NamedShardings: every rank
holds the same host tree and keeps its own block of each leaf, with
`DTensor.from_local` (no rank scatters from another).  A block is the
mesh coordinate's chunk along each sharded dimension, the mesh
dimensions taken in order, which is jax's major-to-minor order for a
multi-axis entry; an entry whose names are out of mesh order has no
DTensor placement and raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.train import tree as T

Axes = Union[str, Tuple[str, ...], None]


class P:
    """A partition spec: P('data', None) shards dim 0 over 'data'.  It
    iterates and indexes as the tuple of its entries, but is not a tuple,
    so a tree of specs is a tree of leaves to `train.tree`."""

    __slots__ = ("parts",)

    def __init__(self, *parts: Axes):
        self.parts = parts

    def __iter__(self):
        return iter(self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.parts == other.parts

    def __hash__(self) -> int:
        return hash(self.parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self.parts) + ")"


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices or group: what the
    policies read of a `DeviceMesh`."""
    mesh_dim_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def size(self, dim: int) -> int:
        return self.sizes[dim]


def _axes(mesh) -> List[Tuple[str, int]]:
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh needs named dimensions (mesh_dim_names)")
    return [(a, int(mesh.size(i))) for i, a in enumerate(names)]


def data_axes(mesh) -> Tuple[str, ...]:
    """The batch axes: every mesh axis except 'model'."""
    return tuple(a for a, _ in _axes(mesh) if a != "model")


def _axis_size(mesh, axes: Axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = dict(_axes(mesh))
    return int(math.prod(shape[a] for a in axes)) if axes else 1


def batch_spec(mesh, extra_dims: int = 0) -> P:
    """Batch-sharded leading dim + `extra_dims` replicated trailing dims."""
    return P(data_axes(mesh), *([None] * extra_dims))


def _model_size(mesh) -> int:
    return dict(_axes(mesh)).get("model", 1)


# --------------------------------------------------------------------------
# LM params: Megatron-style tensor parallelism on 'model', optional FSDP
# --------------------------------------------------------------------------

# leaf name -> the dim (counted from the END, so stacked leaves with a
# leading layer axis share the rule with unstacked ones) that carries 'model'
_TP_FROM_END = {
    # column-parallel projections: output features sharded
    "wq": 1, "wk": 1, "wv": 1, "wqkv": 1, "bq": 1, "bk": 1, "bv": 1,
    "w1": 1, "w3": 1, "w13": 1, "ws1": 1, "ws3": 1,
    "w_dq": 1, "w_uq": 1,
    "head": 1, "proj": 1,
    # row-parallel projections: input features sharded
    "wo": 2, "w2": 2, "ws2": 2,
    # MLA per-head factors: the head dim
    "w_uk": 3, "w_uv": 3,
    # vocab-parallel embedding
    "embed": 2,
}
# expert stacks: expert parallelism on E, else feature TP on the second dim
_EXPERT_FROM_END = {"we1": (3, 1), "we3": (3, 1), "we2": (3, 2)}


def _leaf_name(path: tuple) -> str:
    """The last dict key or field name of a path (indices skipped)."""
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def _spec_with(leaf, dim_from_end, axis, axis_size: int) -> P:
    """P placing `axis` at ndim - dim_from_end if that dim divides; else P()."""
    nd = len(leaf.shape)
    if (dim_from_end is None or axis_size <= 1 or dim_from_end > nd
            or leaf.shape[nd - dim_from_end] % axis_size != 0):
        return P()
    parts: list = [None] * nd
    parts[nd - dim_from_end] = axis
    return P(*parts)


def fsdp_dim(spec: P, shape, dp_size: int) -> Optional[int]:
    """The dim FSDP shards over the batch axes: the largest one `spec`
    leaves replicated that divides by `dp_size` (None if none does).  On
    one batch rank every dim divides: the step gathers that dim from one
    block."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i in sorted(range(len(parts)), key=lambda i: -shape[i]):
        if parts[i] is None and shape[i] % dp_size == 0:
            return i
    return None


def _fsdp_extend(spec: P, leaf, dp: Tuple[str, ...], dp_size: int) -> P:
    """ZeRO-3-style: shard the largest still-replicated dim over the batch
    axes (the rule of `optimizer.zero1_specs`)."""
    if dp_size <= 1:
        return spec
    i = fsdp_dim(spec, leaf.shape, dp_size)
    if i is None:
        return spec
    parts = list(spec) + [None] * (len(leaf.shape) - len(spec))
    parts[i] = dp
    return P(*parts)


def lm_param_specs(params: Any, mesh, *, fsdp: bool = False) -> Any:
    """The spec tree of an LM parameter tree (`init_lm`'s, or "meta"
    tensors of `param_shapes`).  `fsdp` also shards each leaf over the
    batch axes."""
    msz = _model_size(mesh)
    dp = data_axes(mesh)
    dp_size = _axis_size(mesh, dp)

    def rule(path, leaf):
        name = _leaf_name(path)
        if name in _EXPERT_FROM_END:
            expert_dim, feat_dim = _EXPERT_FROM_END[name]
            nd = len(leaf.shape)
            if msz > 1 and expert_dim <= nd and leaf.shape[nd - expert_dim] % msz == 0:
                spec = _spec_with(leaf, expert_dim, "model", msz)
            else:
                spec = _spec_with(leaf, feat_dim, "model", msz)
        else:
            spec = _spec_with(leaf, _TP_FROM_END.get(name), "model", msz)
        if fsdp:
            spec = _fsdp_extend(spec, leaf, dp, dp_size)
        return spec

    return T.tree_map_with_path(rule, params)


def cache_specs(cfg, mesh, batch: int, length: int):
    """The decode cache's specs (`transformer.DecodeCache` of P): batch over
    the data axes, KV heads over 'model'; MLA's latent caches have no head
    dim and stay replicated over 'model'."""
    from repro_torch.models.transformer import DecodeCache

    dp = data_axes(mesh)
    b_axes = dp if batch % max(_axis_size(mesh, dp), 1) == 0 else None
    msz = _model_size(mesh)
    if cfg.mla is not None:
        latent = P(None, b_axes, None, None)
        data = {"ckv": latent, "krope": latent}
    else:
        h_axes = "model" if (msz > 1 and cfg.n_kv_heads % msz == 0) else None
        kv = P(None, b_axes, None, h_axes, None)
        data = {"k": kv, "v": kv}
    return DecodeCache(data=data, pos=P(), length=length)


# --------------------------------------------------------------------------
# DeepFM: vocab-parallel tables over the WHOLE mesh
# --------------------------------------------------------------------------

def _is_mlp_weight(name: str) -> bool:
    parts = name.split(".")
    return len(parts) == 4 and parts[:2] == ["mlp", "layers"] and parts[3] == "weight"


def deepfm_specs(params: Any, mesh) -> Any:
    """DeepFM (`train_params`' names): the tables' vocab dim over every
    mesh axis; the MLP's weights over 'model' on their output features,
    dim 0 of `nn.Linear`'s (out, in); the rest replicated."""
    flat = tuple(a for a, _ in _axes(mesh))
    full = _axis_size(mesh, flat)
    msz = _model_size(mesh)

    def rule(path, leaf):
        name = _leaf_name(path)
        if name in ("embed", "linear"):
            if leaf.shape[0] % max(full, 1) == 0:
                return P(flat, *([None] * (len(leaf.shape) - 1)))
            return _spec_with(leaf, len(leaf.shape), "model", msz)
        if _is_mlp_weight(name):
            return _spec_with(leaf, 2, "model", msz)
        return P()

    return T.tree_map_with_path(rule, params)


# --------------------------------------------------------------------------
# placements and blocks
# --------------------------------------------------------------------------

def _entry_axes(entry: Axes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: P, mesh) -> list:
    """The DTensor placements of `spec` on `mesh`: for each mesh dimension,
    `Shard(d)` where tensor dim d's entry names it, else `Replicate()`."""
    from torch.distributed.tensor import Replicate, Shard

    names = [a for a, _ in _axes(mesh)]
    where = {}
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        unknown = set(axes) - set(names)
        if unknown:
            raise ValueError(f"{spec}: axes {sorted(unknown)} are not in the mesh "
                             f"{tuple(names)}")
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"{spec}: entry {entry} names its axes out of mesh order "
                             f"{tuple(names)}; DTensor shards nested dims in mesh order")
        for a in axes:
            if a in where:
                raise ValueError(f"{spec}: axis {a!r} appears twice")
            where[a] = d
    return [Shard(where[a]) if a in where else Replicate() for a in names]


def _chunk(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    """Chunk i of n along `dim`, torch.chunk's sizes (DTensor's Shard)."""
    size = -(-t.shape[dim] // n)
    lo = min(i * size, t.shape[dim])
    return t.narrow(dim, lo, min(size, t.shape[dim] - lo))


_BACKEND_FOR = {"cuda": "nccl", "cpu": "gloo"}


def mesh_device(mesh) -> torch.device:
    """This rank's device on `mesh`.  Raises unless the default group's
    backend takes its tensors: a CUDA mesh needs NCCL, a CPU one gloo; the
    dry run's "fake" group takes either (its CUDA device is "cuda:0")."""
    import torch.distributed as dist

    backend = str(dist.get_backend())
    if backend == "fake":       # the dry run's group: fake tensors, no card needed
        return torch.device(mesh.device_type, 0) if mesh.device_type == "cuda" \
            else torch.device(mesh.device_type)
    if mesh.device_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device(mesh.device_type)
    if _BACKEND_FOR[dev.type] not in backend:
        raise ValueError(f"the process group's backend {backend!r} cannot take tensors on "
                         f"{dev}: it needs {_BACKEND_FOR[dev.type]!r}")
    return dev


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a `DeviceMesh`: the counterpart of a NamedSharding."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)

    def block(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the whole tensor `full` (a view)."""
        from torch.distributed.tensor import Shard

        coord = self.mesh.get_coordinate()
        out = full
        for i, pl in enumerate(self.placements):
            if isinstance(pl, Shard):
                out = _chunk(out, pl.dim, self.mesh.size(i), coord[i])
        return out

    def place(self, full: torch.Tensor, device=None):
        """The DTensor of `full` under this sharding, its block on `device`
        (the mesh's by default), in storage of its own, so the rank holds
        only its block once the caller drops `full`.  A leaf already there
        whose block is the whole is not copied."""
        from torch.distributed.tensor import DTensor

        dev = mesh_device(self.mesh) if device is None else device
        local = self.block(full).to(dev).contiguous()
        if local.untyped_storage().nbytes() != local.numel() * local.element_size():
            local = local.clone()       # a block of the whole: its own storage
        return DTensor.from_local(local, self.mesh, self.placements, run_check=False,
                                  shape=full.shape, stride=_strides(full.shape))


def _strides(shape: Sequence[int]) -> tuple:
    out, acc = [], 1
    for s in reversed(shape):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


def distribute(tree: Any, specs: Any, mesh) -> Any:
    """`tree` (whole tensors, the same on every rank) as DTensors under
    `specs` (a tree of P of the same structure) on `mesh`: every rank keeps
    its own block on its device."""
    dev = mesh_device(mesh)
    return T.tree_map(lambda x, s: Sharding(mesh, s).place(x, dev), tree, specs)


def shardings(specs: Any, mesh) -> Any:
    """A tree of P as a tree of `Sharding`s (what `checkpoint.restore`
    takes as `placements`)."""
    return T.tree_map(lambda s: Sharding(mesh, s), specs)


def local(x):
    """A DTensor's local block; anything else as it is."""
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x
