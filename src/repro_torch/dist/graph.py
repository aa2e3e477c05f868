"""A full graph's vertices and edges split over the ranks of a mesh: the
placement of the reference's full-graph GNN cell (`ogb_products`), where
vertex rows are `P(flat, None)` and edge arrays `P(flat)`, `flat` every
axis of the mesh.

Each rank owns a contiguous block `[lo, hi)` of the vertices over the flat
order of the mesh's ranks (`graphs.partition.partition_rows`: a (2, 2) mesh
splits over four ranks as (4, 1) does) and the half-edges into them
(`graphs.partition.partition_edges`, receiver-owner), so every aggregation
into a vertex (sum, mean, max, min, std, degree) runs on its rank with no
collective.  What an edge reads of its sender comes from `gather(x)`: every
rank's block of rows gathered whole, once a layer, through
`DataGroup.gather_leaf`, whose backward reduce-scatters each rank's
gradient back to the owner's block.

The layout of one rank (`split_edges`, host numpy):

* the gathered rows are R blocks of `block = ceil(N / R)` rows, block r
  holding rank r's `hi - lo` rows and zero padding after them
  (`all_gather_into_tensor` takes equal blocks; `partition_rows` balances
  the blocks only to within one vertex);
* `senders` index the gathered rows (vertex v of rank o's block at row
  o · block + v - lo_o), `receivers` the rank's own rows;
* a rank keeps only its real edges.  The slots `partition_edges` pads each
  rank's edges with hold its sentinel `n_nodes`, out of range for the
  segment ops; routed to a vertex, masked, as the cells route masked
  edges to vertex 0, a slot on rank 0 would be a masked self-loop, whose
  square root gives EGNN a non-finite gradient that the whole graph does
  not have.  So they are dropped: a rank with no edge holds empty arrays
  and still takes part in every collective.  The input's own masked edges
  are kept, each on its receiver's rank.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist.collectives import DataGroup, sum_over
from repro_torch.dist.sharding import mesh_device
from repro_torch.graphs.partition import partition_edges, partition_rows


def split_edges(senders, receivers, mask, n_nodes: int, ranks: int, rank: int
                ) -> Tuple[int, int, int, np.ndarray, np.ndarray, np.ndarray]:
    """Rank `rank` of `ranks`'s part of a graph's edge list (whole, host
    arrays; every id in [0, n_nodes), masked edges included): (lo, hi,
    block, senders as rows of the gathered blocks (int64), receivers as
    local rows (int64), mask), the real edges of the rank's
    `partition_edges` shard in the order it deals them."""
    if n_nodes < ranks:
        raise ValueError(f"{n_nodes} vertices do not split over {ranks} ranks")
    senders, receivers, mask = (np.asarray(x) for x in (senders, receivers, mask))
    bounds = partition_rows(n_nodes, ranks)
    lo, hi = int(bounds[rank]), int(bounds[rank + 1])
    block = -(-n_nodes // ranks)
    # deal edge ids by receiver owner: the ids then index every per-edge array
    ids, _, real = partition_edges(np.arange(senders.shape[0], dtype=np.int32), receivers,
                                   n_nodes, ranks)
    ids = ids[rank][real[rank]]
    snd = senders[ids].astype(np.int64)
    owner = np.clip(np.searchsorted(bounds, snd, side="right") - 1, 0, ranks - 1)
    rows = owner * block + snd - bounds[owner]
    return lo, hi, block, rows, receivers[ids].astype(np.int64) - lo, mask[ids].astype(bool)


def _flat_group(mesh):
    """The group of every rank of `mesh` in its flat (row-major) order: the
    default group when the mesh holds ranks 0 .. world - 1 in order, else
    the group of a one-dimensional mesh."""
    from repro_torch.hopper.launch import outside_fake_mode

    with outside_fake_mode():           # the rank table is real, in the dry run too
        flat = mesh.mesh.flatten().tolist()
    if flat == list(range(dist.get_world_size())):
        return None
    if mesh.ndim == 1:
        return mesh.get_group(0)
    raise NotImplementedError(
        f"a graph splits over a mesh of ranks 0 .. world - 1 in order or over a "
        f"one-dimensional mesh; this mesh holds {flat}")


@dataclasses.dataclass(eq=False)
class GraphSplit:
    """This rank's vertex block and half-edges on `mesh` (`split_graph`)."""
    mesh: object
    group: DataGroup
    n_nodes: int              # the whole graph's vertex count
    lo: int
    hi: int
    block: int                # rows of each rank's block in `gather`'s output
    senders: torch.Tensor     # (E_r,) int64 rows of `gather`'s output
    receivers: torch.Tensor   # (E_r,) int64 rows of this rank's block
    mask: torch.Tensor        # (E_r,) bool

    @property
    def n_local(self) -> int:
        return self.hi - self.lo

    @property
    def edges(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(senders, receivers, mask): the edge arguments of a placed step."""
        return self.senders, self.receivers, self.mask

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole per-vertex tensor, as its own copy."""
        return x[self.lo:self.hi].clone()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(hi - lo, ...) rows on each rank -> (ranks · block, ...): every
        rank's block, padded to `block` rows, in rank order.  Backward: the
        gradient of each block summed over the ranks onto its owner."""
        pad = self.block - x.shape[0]
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        return self.group.gather_leaf(x, 0)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks of x, as a new tensor (no gradient)."""
        return self.group.all_reduce(x)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks of x; backward the identity (each rank's part
        of a loss enters the sum once)."""
        return sum_over(x, self.group.group)


def split_graph(senders, receivers, mask, n_nodes: int, mesh) -> GraphSplit:
    """This rank's `GraphSplit` of a whole edge list (the same on every rank;
    tensors or numpy arrays), its edges on the mesh's device."""
    group = DataGroup(_flat_group(mesh))
    host = [x.cpu().numpy() if isinstance(x, torch.Tensor) else x
            for x in (senders, receivers, mask)]
    lo, hi, block, s, r, m = split_edges(*host, n_nodes, group.size, group.rank)
    dev = mesh_device(mesh)
    return GraphSplit(mesh, group, int(n_nodes), lo, hi, block, torch.from_numpy(s).to(dev),
                      torch.from_numpy(r).to(dev), torch.from_numpy(m).to(dev))
