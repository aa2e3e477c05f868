"""The port's graph generators against the reference's: the same
arguments and seed give the same canonical half-edge arrays, for each
generator at a small size and for the eight graphs of the paper's suite
(`generate`, at the reduced scale the reference's benchmarks run)."""
import numpy as np
import pytest

from repro.graphs import generators as ref
from repro_torch.graphs import generators as port

SMALL = {
    "rmat": (dict(scale=8, edge_factor=8),),
    "powerlaw": (dict(n=500, avg_deg=5.0), dict(n=333, avg_deg=3.0, exponent=2.5)),
    "delaunay_like": (dict(n=300),),
    "preferential_attachment": (dict(n=400, m=3), dict(n=50, m=7)),
    "web_like": (dict(n=300, m=4), dict(n=120, m=2, p_triangle=0.9)),
    "grid2d": (dict(n_rows=13, n_cols=17),),
    "erdos_renyi": (dict(n=200, avg_deg=6.0),),
    "random_regular": (dict(n=100, d=4),),
}


def _assert_same_graph(got, want):
    E = want.n_edges
    assert (got.n_nodes, got.n_edges) == (want.n_nodes, E)
    np.testing.assert_array_equal(got.senders[:E].numpy(), np.asarray(want.senders)[:E])
    np.testing.assert_array_equal(got.receivers[:E].numpy(), np.asarray(want.receivers)[:E])


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("name, kw", [(k, kw) for k, cases in SMALL.items() for kw in cases],
                         ids=lambda x: x if isinstance(x, str) else "-".join(map(str, x.values())))
def test_generator_matches_reference(name, kw, seed):
    want = getattr(ref, name)(seed=seed, **kw)
    got = getattr(port, name)(seed=seed, device="cpu", **kw)
    assert got.senders.device.type == "cpu"
    _assert_same_graph(got, want)


@pytest.mark.parametrize("paper_id", [f"G{i}" for i in range(1, 9)])
def test_generate_suite_matches_reference(paper_id):
    spec, ref_spec = port.GRAPH_SUITE[paper_id], ref.GRAPH_SUITE[paper_id]
    assert (spec.name, spec.n_full, spec.e_full, spec.n_reduced) == (
        ref_spec.name, ref_spec.n_full, ref_spec.e_full, ref_spec.n_reduced)
    assert spec.e_over_v == ref_spec.e_over_v
    _assert_same_graph(port.generate(paper_id, device="cpu"), ref.generate(paper_id))


def test_generate_refuses_the_full_scale_and_bad_arguments():
    with pytest.raises(ValueError, match="full-scale"):
        port.generate("G2", scale="full", device="cpu")
    with pytest.raises(KeyError):
        port.generate("G9", device="cpu")
    with pytest.raises(ValueError, match="m <= n"):
        port.web_like(3, m=5, device="cpu")
    assert sorted(port.GRAPH_SUITE) == sorted(ref.GRAPH_SUITE)
