"""The roofline terms of a step and the hybrid tile-routing cost model
(counterpart of `repro.perf.roofline`).

`RooflineTerms` holds a step's three terms, in seconds, per device:

    compute    = FLOPs            / PEAK_FLOPS
    memory     = bytes accessed   / HBM_BW
    collective = Σ collective bytes over NVLINK_BW within one 8-card node,
                 over NET_BW across nodes

`roofline_from_counts` makes them from a `perf.counting.CountingMode`'s
counts, where the reference reads XLA's compiled module
(`roofline_from_compiled`, `parse_collective_bytes`).

A dense tile costs the same whatever it holds, a COO-tail edge costs a
fixed number of bytes; `hybrid_density_threshold` is the nnz per tile at
which the two are equal, the cut `core.tiling.attach_partition` routes by.

The hardware constants are the NVIDIA H100 SXM data sheet's (and a DGX
H100's network), stated as inputs and not as measurements: the dense bf16
tensor-core rate, the HBM3 bandwidth, NVLink 4's 900 GB/s a GPU (both
directions together, so 450e9 each way) and one 400 Gb/s NDR link a GPU.  Both the dense tile and the tail edge are memory-bound
at every tile size the planner picks, so the bandwidth cancels out of the
threshold and only the byte counts set it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989.4e12    # bf16 dense tensor-core FLOP/s (H100 SXM data sheet)
HBM_BW = 3.35e12         # HBM3 bytes/s (H100 SXM data sheet)
NVLINK_BW = 450e9        # NVLink 4, bytes/s each way a GPU (900 GB/s both ways)
NET_BW = 50e9            # one 400 Gb/s NDR link a GPU (DGX H100), bytes/s

@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_accessed: float
    collective_bytes: int
    collectives: Dict[str, int]
    model_flops: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three overlappable terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flop_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs per device."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs / (peak × step_time) per device."""
        t = self.step_time_s
        return self.model_flops / (PEAK_FLOPS * t) if t > 0 else 0.0

    def as_dict(self) -> dict:
        return dict(
            compute_s=self.compute_s,
            memory_s=self.memory_s,
            collective_s=self.collective_s,
            dominant=self.dominant,
            flops=self.flops,
            bytes_accessed=self.bytes_accessed,
            collective_bytes=self.collective_bytes,
            collectives=self.collectives,
            model_flops=self.model_flops,
            useful_flop_fraction=self.useful_flop_fraction,
            step_time_s=self.step_time_s,
            mfu=self.mfu,
        )


def roofline_from_counts(counts: dict, n_devices: int,
                         model_flops_global: float) -> RooflineTerms:
    """The three terms of one device's step from its counts: `flops`,
    `bytes_accessed`, `collectives` ({kind: bytes}) and `collective_links`
    ({"nvlink": bytes, "net": bytes}, the same bytes by the link they
    cross)."""
    links = counts.get("collective_links", {})
    colls = {k: int(v) for k, v in counts["collectives"].items()}
    return RooflineTerms(
        compute_s=counts["flops"] / PEAK_FLOPS,
        memory_s=counts["bytes_accessed"] / HBM_BW,
        collective_s=links.get("nvlink", 0) / NVLINK_BW + links.get("net", 0) / NET_BW,
        flops=float(counts["flops"]),
        bytes_accessed=float(counts["bytes_accessed"]),
        collective_bytes=sum(colls.values()),
        collectives=colls,
        model_flops=model_flops_global / max(n_devices, 1),
    )


# Bytes one tail nnz moves through HBM: two int32 coordinates plus a
# gathered operand word and its scattered contribution.
_SPARSE_BYTES_PER_EDGE = 16


def dense_tile_cost_s(tile_size: int, storage: str = "int8", lanes: int = 8) -> float:
    """Roofline cost of one tile on the dense path, at any occupancy: the
    larger of its phase-② multiply-adds over `lanes` RHS columns at the
    tensor-core rate, and its payload (bitpack is 8x smaller), RHS slab
    and output share at the HBM rate."""
    if tile_size <= 0:
        raise ValueError(f"tile_size must be positive, got {tile_size}")
    t = int(tile_size)
    flops = 2.0 * t * t * lanes
    payload = t * max(t // 32, 1) * 4 if storage == "bitpack" else t * t
    rhs_bytes = t * lanes * 4
    out_bytes = t * lanes * 4
    return max(flops / PEAK_FLOPS, (payload + rhs_bytes + out_bytes) / HBM_BW)


def sparse_edge_cost_s() -> float:
    """Roofline cost of one nnz on the COO tail (a gather and a scatter)."""
    return _SPARSE_BYTES_PER_EDGE / HBM_BW


def predicted_round_cost_s(
    dense_tiles: float,
    sparse_edges: float = 0.0,
    *,
    tile_size: int,
    storage: str = "int8",
    lanes: int = 8,
) -> float:
    """Model cost of one solver round (seconds): `dense_tiles` tiles on the
    dense path (telemetry's tiles_dense) plus `sparse_edges` half-edges on
    the tail.  Fractional counts (per-round means) are fine."""
    dense = max(float(dense_tiles), 0.0)
    edges = max(float(sparse_edges), 0.0)
    return (dense * dense_tile_cost_s(tile_size, storage, lanes)
            + edges * sparse_edge_cost_s())


def round_cost_attribution(
    *,
    dense_tiles: float,
    sparse_edges: float,
    tile_size: int,
    storage: str,
    measured_s: float,
    lanes: int = 8,
) -> Dict[str, float]:
    """Predicted against measured cost of one round: `error_pct` =
    (measured − predicted) / predicted × 100, 0 when nothing is predicted."""
    predicted = predicted_round_cost_s(
        dense_tiles, sparse_edges, tile_size=tile_size, storage=storage, lanes=lanes,
    )
    measured = max(float(measured_s), 0.0)
    error_pct = (measured - predicted) / predicted * 100.0 if predicted > 0 else 0.0
    return dict(
        predicted_us=round(predicted * 1e6, 3),
        measured_us=round(measured * 1e6, 3),
        error_pct=round(error_pct, 1),
    )


def hybrid_density_threshold(tile_size: int, storage: str = "int8", lanes: int = 8) -> int:
    """Break-even nnz per tile between the dense path and the COO tail: a
    tile with fewer nnz is cheaper as scattered edges.  Clamped to [1, T²]."""
    thr = int(dense_tile_cost_s(tile_size, storage, lanes) / sparse_edge_cost_s())
    return max(1, min(thr, int(tile_size) * int(tile_size)))
