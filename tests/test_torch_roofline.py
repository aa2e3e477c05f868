"""The port's hybrid cost model (`repro_torch.perf.roofline`) against the
reference's (`repro.perf.roofline`).

The two run on different constants, the port on the H100 SXM data sheet's
(989.4e12 bf16 FLOP/s, 3.35e12 B/s), the reference on a TPU v5e's.  Both
price a dense tile and a tail edge as memory-bound at every tile size, so
the bandwidth cancels out of the threshold: the thresholds are equal, and
every cost in seconds differs by exactly the ratio of the two bandwidths
(held to a relative 1e-12, the rounding of two float divisions)."""
import math

import pytest

from repro.perf import roofline as ref
from repro_torch.perf import roofline as port

SIZES = (16, 32, 64, 128)
# (storage, T) -> the break-even nnz, the reference's thresholds
EXPECTED = {
    ("int8", 16): 80, ("int8", 32): 192, ("int8", 64): 512, ("int8", 128): 1536,
    ("bitpack", 16): 68, ("bitpack", 32): 136, ("bitpack", 64): 288, ("bitpack", 128): 640,
}
RATIO = ref.HBM_BW / port.HBM_BW


@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", SIZES)
def test_threshold_equals_reference(T, storage):
    got = port.hybrid_density_threshold(T, storage)
    assert got == ref.hybrid_density_threshold(T, storage) == EXPECTED[(storage, T)]
    assert 1 <= got <= T * T


@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", SIZES)
def test_tile_costs_are_memory_bound_and_scale_by_the_bandwidths(T, storage):
    flops_s = 2.0 * T * T * 8 / port.PEAK_FLOPS
    # memory-bound everywhere; on int8 tiles the compute term is under 5 %
    assert flops_s < (0.05 if storage == "int8" else 1.0) * port.dense_tile_cost_s(T, storage)
    assert math.isclose(port.dense_tile_cost_s(T, storage),
                        ref.dense_tile_cost_s(T, storage) * RATIO, rel_tol=1e-12)
    assert math.isclose(port.sparse_edge_cost_s(), ref.sparse_edge_cost_s() * RATIO,
                        rel_tol=1e-12)
    assert port._SPARSE_BYTES_PER_EDGE == ref._SPARSE_BYTES_PER_EDGE == 16


def test_predicted_round_cost_behaves_as_reference():
    for dense, edges, T, storage in [(0, 0, 16, "int8"), (100, 0, 16, "bitpack"),
                                     (0, 5000, 32, "int8"), (67338.0, 2441660.0, 16, "bitpack"),
                                     (-3, -7, 64, "int8"), (2.5, 10.25, 128, "bitpack")]:
        got = port.predicted_round_cost_s(dense, edges, tile_size=T, storage=storage)
        want = ref.predicted_round_cost_s(dense, edges, tile_size=T, storage=storage)
        assert math.isclose(got, want * RATIO, rel_tol=1e-12, abs_tol=0.0)
        assert got >= 0.0
    assert port.predicted_round_cost_s(0, 0, tile_size=16) == 0.0


def test_round_cost_attribution_behaves_as_reference():
    kw = dict(dense_tiles=68351, sparse_edges=1000, tile_size=16, storage="bitpack")
    predicted = port.predicted_round_cost_s(68351, 1000, tile_size=16, storage="bitpack")
    for measured in (0.0, predicted, 2 * predicted, 1e-3, -1.0):
        got = port.round_cost_attribution(measured_s=measured, **kw)
        assert set(got) == {"predicted_us", "measured_us", "error_pct"}
        assert got["predicted_us"] == round(predicted * 1e6, 3)
        m = max(measured, 0.0)
        assert got["measured_us"] == round(m * 1e6, 3)
        assert got["error_pct"] == round((m - predicted) / predicted * 100.0, 1)
        # the reference's, fed the measurement scaled into its own units
        want = ref.round_cost_attribution(measured_s=measured / RATIO, **kw)
        assert got["error_pct"] == want["error_pct"]
    zero = port.round_cost_attribution(dense_tiles=0, sparse_edges=0, tile_size=16,
                                       storage="int8", measured_s=1.0)
    assert zero["error_pct"] == 0.0 == ref.round_cost_attribution(
        dense_tiles=0, sparse_edges=0, tile_size=16, storage="int8",
        measured_s=1.0)["error_pct"]


def test_constants_are_the_h100s():
    assert port.PEAK_FLOPS == 989.4e12 and port.HBM_BW == 3.35e12
    assert (port.PEAK_FLOPS, port.HBM_BW) != (ref.PEAK_FLOPS, ref.HBM_BW)
    assert not hasattr(port, "ICI_BW")
    with pytest.raises(ValueError, match="tile_size"):
        port.dense_tile_cost_s(0)
