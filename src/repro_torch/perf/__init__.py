"""repro_torch.perf — the roofline terms of a step, the counts behind
them (`counting.CountingMode`) and the hybrid-routing cost model
(counterpart of `repro.perf`)."""
from repro_torch.perf.roofline import (
    HBM_BW,
    NET_BW,
    NVLINK_BW,
    PEAK_FLOPS,
    RooflineTerms,
    dense_tile_cost_s,
    hybrid_density_threshold,
    predicted_round_cost_s,
    roofline_from_counts,
    round_cost_attribution,
    sparse_edge_cost_s,
)

__all__ = [
    "HBM_BW", "NET_BW", "NVLINK_BW", "PEAK_FLOPS", "RooflineTerms", "dense_tile_cost_s",
    "hybrid_density_threshold", "predicted_round_cost_s", "roofline_from_counts",
    "round_cost_attribution", "sparse_edge_cost_s",
]
