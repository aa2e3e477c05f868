"""What a step costs, counted from the ops it dispatches: the port's own
source of the counts the reference reads from XLA's compiled module
(`cost_analysis`, `memory_analysis` and the collectives of its HLO text).

`CountingMode` is a `TorchDispatchMode`.  Entered around a step (on fake
tensors in the dry run, or on real ones), it counts

* FLOPs, by `torch.utils.flop_counter`'s registered formulas (matrix
  products, convolutions, attention);
* bytes: Σ bytes of the tensor inputs and outputs of every aten op, where
  views, metadata ops and allocations without a write (`empty`) count 0;
* collectives, by `c10d` and `_c10d_functional` op type under the
  reference's names (all-reduce, all-gather, reduce-scatter, all-to-all,
  broadcast), as the payload bytes of their output, each with the ranks of
  its group;
* live bytes (`LiveBytes`): every storage an op makes is followed by a
  weak reference until it is freed, so the mode knows the bytes alive at
  each op and their peak over the step;
* kernel records: a Hopper kernel's wrapper, given fake tensors, reports
  the bytes and FLOPs of the launch it stands for (`record_kernel`), and
  they count in the totals.

The steps compute on the local blocks of their DTensors; an aten op on a
DTensor itself raises, since DTensor would first run it on global-shape
tensors to learn its output's metadata, ops the counts could not tell from
the step's.  A redistribution (`DTensor.redistribute`) runs functional
collectives on the blocks, which are counted.

With `fake_mode`, fake tensors of another `FakeTensorMode` are not
counted.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.hopper.launch import fake
from repro_torch.train import tree as T

_aten = torch.ops.aten

# allocations that write nothing: their output costs no bytes of traffic
_NO_WRITE = {_aten.empty.memory_format, _aten.empty_strided.default,
             _aten.empty_like.default, _aten.new_empty.default,
             _aten.new_empty_strided.default}

# collective op (overload packet name) -> (the reference's name, index of the
# output payload among the args or None for the op's result, index of the
# group among the args)
_C10D = {
    "allreduce_": ("all-reduce", 0, 1),
    "_allgather_base_": ("all-gather", 0, 2),
    "allgather_": ("all-gather", 0, 2),
    "allgather_into_tensor_coalesced_": ("all-gather", 0, 2),
    "_reduce_scatter_base_": ("reduce-scatter", 0, 2),
    "reduce_scatter_": ("reduce-scatter", 0, 2),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0, 2),
    "alltoall_base_": ("all-to-all", 0, 2),
    "alltoall_": ("all-to-all", 0, 2),
    "broadcast_": ("broadcast", 0, 1),
}
_FUNCTIONAL = {
    "all_reduce": ("all-reduce", 2),
    "all_reduce_": ("all-reduce", 2),
    "all_reduce_coalesced": ("all-reduce", 2),
    "all_gather_into_tensor": ("all-gather", 2),
    "all_gather_into_tensor_out": ("all-gather", 2),
    "all_gather_into_tensor_coalesced": ("all-gather", 2),
    "reduce_scatter_tensor": ("reduce-scatter", 3),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 3),
    "all_to_all_single": ("all-to-all", 3),
    "broadcast": ("broadcast", 2),
}

# ranks of one node: a group whose ranks all lie in one block of NODE_RANKS
# consecutive ranks talks over NVLink, any other over the network
NODE_RANKS = 8


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in T.leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_ranks(group) -> Tuple[int, ...]:
    """The global ranks of a process group given as an object, the boxed
    object a `c10d` op carries, or a name."""
    import torch.distributed as dist

    if isinstance(group, torch.ScriptObject):
        group = dist.ProcessGroup.unbox(group)
    elif isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group

        group = _resolve_process_group(group)
    return tuple(dist.get_process_group_ranks(group))


def within_node(ranks: Iterable[int]) -> bool:
    """Whether every rank lies on one node of NODE_RANKS consecutive ranks."""
    nodes = {r // NODE_RANKS for r in ranks}
    return len(nodes) <= 1


@dataclasses.dataclass
class KernelRecord:
    """What a kernel's fake branch reported: its launches, bytes and FLOPs."""
    launches: int = 0
    bytes: float = 0.0
    flops: float = 0.0


class LiveBytes:
    """Bytes of the storages alive, by weak references on them, and their
    peak.  `argument` storages are the step's inputs; the others are the
    step's own."""

    def __init__(self):
        self._sizes: Dict[int, int] = {}
        self.arguments: Dict[int, int] = {}
        self.live = 0
        self.peak = 0

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def add(self, t: torch.Tensor, argument: bool = False) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return
        n = st.nbytes()
        self._sizes[key] = n
        if argument:
            self.arguments[key] = n
        weakref.finalize(st, self._free, key)
        self.live += n
        self.peak = max(self.peak, self.live)

    @property
    def argument_bytes(self) -> int:
        return sum(self.arguments.values())


_ACTIVE: List["CountingMode"] = []


def record_kernel(name: str, nbytes: float, flops: float) -> None:
    """A kernel's fake branch reports the launch it stands for to the
    innermost active `CountingMode` (none: nothing is recorded)."""
    if _ACTIVE:
        _ACTIVE[-1]._kernel(name, nbytes, flops)


class CountingMode(TorchDispatchMode):
    """Counts what the ops dispatched inside it cost (see the module
    docstring).  `track(tensors)` registers the step's inputs before it
    runs; `finish(outputs)` sorts the step's outputs into new storage and
    storage aliasing an input, and returns the memory record."""

    def __init__(self, fake_mode=None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.fake_mode = fake_mode
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, int] = {}
        self.collective_links: Dict[str, int] = {"nvlink": 0, "net": 0}
        self.kernels: Dict[str, KernelRecord] = {}
        self.memory = LiveBytes()

    # ---- enter / exit -----------------------------------------------------
    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)

    # ---- inputs and outputs -------------------------------------------------
    def track(self, tensors) -> None:
        """Register the step's inputs (local blocks of DTensors) as arguments."""
        for t in _tensors(tensors):
            self.memory.add(_local(t), argument=True)

    def finish(self, outputs) -> dict:
        """The step's memory record: argument, output, temp and alias bytes
        and their total, the reference's `memory_analysis` keys."""
        seen, out_bytes, alias_bytes = set(), 0, 0
        for t in _tensors(outputs):
            t = _local(t)
            key = id(t.untyped_storage())
            if key in seen:
                continue
            seen.add(key)
            n = t.untyped_storage().nbytes()
            out_bytes += n
            if key in self.memory.arguments:
                alias_bytes += n
        arg = self.memory.argument_bytes
        total = self.memory.peak
        return dict(argument_bytes=arg, output_bytes=out_bytes,
                    temp_bytes=total - arg - out_bytes + alias_bytes,
                    alias_bytes=alias_bytes, total_per_device=total)

    # ---- counting -----------------------------------------------------------
    def _kernel(self, name: str, nbytes: float, flops: float) -> None:
        rec = self.kernels.setdefault(name, KernelRecord())
        rec.launches += 1
        rec.bytes += nbytes
        rec.flops += flops
        self.bytes += nbytes
        self.flops += flops

    def _foreign(self, tensors) -> bool:
        if self.fake_mode is None:
            return False
        return any(fake(t) and t.fake_mode is not self.fake_mode for t in tensors)

    def _collective(self, func, args, kwargs, out) -> bool:
        ns, name = func.namespace, func._overloadpacket.__name__
        if ns == "c10d" and name in _C10D:
            kind, payload, group = _C10D[name]
            nbytes = sum(_nbytes(t) for t in _tensors(args[payload]))
            group = args[group]
        elif ns == "_c10d_functional" and name in _FUNCTIONAL:
            kind, group = _FUNCTIONAL[name]
            nbytes = sum(_nbytes(t) for t in _tensors(out))
            group = args[group] if len(args) > group else kwargs["group_name"]
        elif ns in ("c10d", "_c10d_functional"):
            return True                 # wait_tensor, barriers: no payload
        else:
            return False
        ranks = _group_ranks(group)
        self.collectives[kind] = self.collectives.get(kind, 0) + nbytes
        self.collective_links["nvlink" if within_node(ranks) else "net"] += nbytes
        return True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            raise NotImplementedError(
                f"{func} on a DTensor: DTensor would run the op on global-shape tensors to "
                "learn its output's metadata, which these counts cannot tell from the "
                "step's own ops; compute on the local blocks (`dist.sharding.local`)")
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if self._foreign(ins + outs):
            return out
        for t in outs:
            self.memory.add(t)
        if self._collective(func, args, kwargs, out):
            return out
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.flops += self._flop_registry[packet](*args, **kwargs, out_val=out)
        if (func.is_view or func in _NO_WRITE or func.namespace == "prim"
                or _metadata_only(func)):
            return out
        self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        return out


def _metadata_only(func) -> bool:
    """Ops that read no tensor data (sizes, strides, devices)."""
    return func._overloadpacket.__name__ in (
        "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
        "is_nonzero", "_local_scalar_dense")


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t
