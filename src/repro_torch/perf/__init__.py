"""repro_torch.perf — the hybrid-routing cost model (counterpart of
`repro.perf`; the XLA roofline terms are not ported, ROADMAP.md Queue 1
item 17)."""
from repro_torch.perf.roofline import (
    HBM_BW,
    PEAK_FLOPS,
    dense_tile_cost_s,
    hybrid_density_threshold,
    predicted_round_cost_s,
    round_cost_attribution,
    sparse_edge_cost_s,
)

__all__ = [
    "HBM_BW", "PEAK_FLOPS", "dense_tile_cost_s", "hybrid_density_threshold",
    "predicted_round_cost_s", "round_cost_attribution", "sparse_edge_cost_s",
]
