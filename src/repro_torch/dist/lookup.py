"""Tables split by rows over the ranks of a mesh, and an exact row lookup
from them: the placement of the reference's minibatch cell
(`minibatch_lg`), where the CSR's `indices` is `P(flat)`, the feature and
coordinate tables `P(flat, None)` and the labels `P(flat)`, `flat` every
axis of the mesh.

Rank r of the flat group (`dist.graph._flat_group`) holds rows
[r · block, (r + 1) · block) of a table of n rows, block = ceil(n / R):
torch.chunk's blocks, the last ones padded with zero rows so that every
rank holds `block` rows (`row_block`, `TableSplit.block`).

`TableSplit.take(block, ids)` is `table[ids]` for ids in [0, R · block),
read on the card with static shapes and no value read back to the host, as
GSPMD lowers a gather from an operand split along the gathered dimension:

1. the ids of every rank are all-gathered over the flat group;
2. each rank reads the rows it holds of them from its block, and zeros
   where another rank holds the row;
3. a reduce-scatter that sums returns each rank the rows of its own ids.

The sum runs on the rows' bits as integers (f32 as int32, f64 as int64),
where x + 0 is x for every x: a float sum would turn -0.0 into +0.0.  So
the rows that come back are the table's own bits, NaN payloads too.

Ranks that hold the same ids need not all gather them.  The GNN steps
split the batch over the batch axes, so the ranks of the mesh's 'model'
axis hold the same ids: each of them looks up a 1/m share of its ids, and
the shares are all-gathered over the axis at the end.  The flat group then
carries the global batch's ids once, and each rank's working set is those
ids' rows: (Σ ids over the batch ranks) × (a row's bytes), whatever R is.

No gradient flows through a lookup: the tables are inputs, not parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.dist.collectives import DataGroup, _reduce_scatter_dim, gather_rows
from repro_torch.dist.sharding import mesh_device

# a row's dtype -> the integer dtype its bits are summed in
_BITS = {torch.float32: torch.int32, torch.float64: torch.int64, torch.bool: torch.uint8}
_INTS = (torch.uint8, torch.int8, torch.int32, torch.int64)


def block_rows(n: int, ranks: int) -> int:
    """The rows each rank holds of a table of n rows split over `ranks`."""
    return -(-int(n) // int(ranks))


def row_block(x: torch.Tensor, ranks: int, rank: int) -> torch.Tensor:
    """Rank `rank` of `ranks`'s block of a whole table `x`: its rows
    [rank · block, (rank + 1) · block), zero rows after the table's end, so
    that every block has `block_rows(len(x), ranks)` rows, in storage of
    its own."""
    n = int(x.shape[0])
    blk = block_rows(n, ranks)
    lo = min(rank * blk, n)
    hi = min(lo + blk, n)
    out = x.new_zeros((blk,) + tuple(x.shape[1:]))
    out[: hi - lo] = x[lo:hi]
    return out


def _bits_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype in _INTS:
        return dtype
    if dtype in _BITS:
        return _BITS[dtype]
    raise ValueError(f"a split table of {dtype} has no lookup: its rows are summed as "
                     "integers of 1, 4 or 8 bytes")


@dataclasses.dataclass(eq=False)
class TableSplit:
    """Tables split by rows over every rank of `mesh` (`take`, `block`)."""
    mesh: object
    group: DataGroup                 # the flat group: every rank of the mesh
    shares: Optional[DataGroup]      # the 'model' axis's ranks (same ids), or None

    @classmethod
    def of(cls, mesh) -> "TableSplit":
        """The split of `mesh`: over its flat group, the ids shared over its
        'model' axis when that axis has more than one rank."""
        from repro_torch.dist.graph import _flat_group

        names = tuple(mesh.mesh_dim_names or ())
        shares = None
        if "model" in names and mesh.size(names.index("model")) > 1:
            shares = DataGroup(mesh.get_group("model"))
        return cls(mesh, DataGroup(_flat_group(mesh)), shares)

    def block(self, x) -> torch.Tensor:
        """This rank's block of a whole table (the same on every rank; host
        array or tensor), on the mesh's device."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return row_block(x, self.group.size, self.group.rank).to(mesh_device(self.mesh))

    def rows(self, block: torch.Tensor) -> int:
        """The rows of the whole table `block` is this rank's block of,
        padding included: ids in [0, rows) can be looked up."""
        return self.group.size * int(block.shape[0])

    def take(self, block: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """table[ids] of the table whose block this rank holds: ids any
        integer tensor of global row ids in [0, `rows(block)`), the same on
        the ranks of the 'model' axis; (ids.shape + a row's shape), the
        table's dtype and bits.  Every rank of the mesh calls it at once."""
        flat = ids.reshape(-1)
        n = flat.shape[0]
        if self.shares is not None:            # this rank's 1/m share of the ids
            m = self.shares.size
            c = -(-n // m)
            flat = torch.nn.functional.pad(flat, (0, c * m - n))
            flat = flat[self.shares.rank * c:(self.shares.rank + 1) * c]
        every = gather_rows(flat, self.group.group)            # (R · c,)
        nb = block.shape[0]
        local = every.long() - self.group.rank * nb
        held = (local >= 0) & (local < nb)
        bits = block.view(_bits_dtype(block.dtype))[local.clamp_(0, nb - 1)]
        bits.masked_fill_(~held.view((-1,) + (1,) * (bits.dim() - 1)), 0)
        out = _reduce_scatter_dim(bits, 0, self.group.group)   # (c, ...): Σ = the one holder's
        del bits
        if self.shares is not None:
            out = gather_rows(out, self.shares.group)[:n]
        return out.view(block.dtype).reshape(tuple(ids.shape) + tuple(block.shape[1:]))
