"""The port's public helpers against the JAX reference on the same inputs:
`build_csr`, `pad_graph`, `to_networkx` (graphs.graph), the partition
helpers (graphs.partition), `unpack_vertex_vector` and `tile_stats`
(core.tiling), and the tiled operators `spmv_tiled` / `neighbor_max_tiled`
(core.spmv) on both backends.  The reference's "pallas" backend runs its
Pallas kernels in interpret mode, as its own tests run them on the CPU;
the port's runs its Hopper wrappers, which take their plain versions on
CPU tensors.

Tolerances: the neighbour max, packed and 0/1 outputs exactly; random f32
SpMV lanes within rtol=1e-6 (sums of up to T positive terms, taken in
another order)."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_hybrid import _port_graph

from repro.core import spmv as ref_spmv
from repro.core.tiling import build_block_tiles as ref_build_block_tiles
from repro.core.tiling import tile_stats as ref_tile_stats
from repro.core.tiling import unpack_vertex_vector as ref_unpack_vertex_vector
from repro.graphs import partition as ref_partition
from repro.graphs.generators import powerlaw as ref_powerlaw
from repro.graphs.graph import build_csr as ref_build_csr
from repro.graphs.graph import from_edges as ref_from_edges
from repro.graphs.graph import pad_graph as ref_pad_graph
from repro.graphs.graph import to_networkx as ref_to_networkx
from repro_torch.core import spmv
from repro_torch.core.tiling import build_block_tiles, tile_stats, unpack_vertex_vector
from repro_torch.graphs import (
    build_csr,
    pad_graph,
    pad_to_multiple,
    partition_edges,
    partition_rows,
    to_networkx,
)
from repro_torch.graphs.graph import from_edges
from repro_torch.hopper import tc_neighbor_max as N
from repro_torch.hopper import tc_spmv as K


def _both(src, dst, n, **kw):
    return ref_from_edges(src, dst, n, **kw), from_edges(src, dst, n, device="cpu", **kw)


def _assert_graph_equal(got, want):
    np.testing.assert_array_equal(got.senders.numpy(), np.asarray(want.senders))
    np.testing.assert_array_equal(got.receivers.numpy(), np.asarray(want.receivers))
    assert (got.n_nodes, got.n_edges, got.e_pad) == (want.n_nodes, want.n_edges, want.e_pad)
    assert got.senders.dtype == got.receivers.dtype == torch.int32


# --------------------------------------------------------------------------
# graphs.graph
# --------------------------------------------------------------------------

def test_pad_graph_zero_edge_roundtrip_equals_reference():
    """tests/test_serve_mis.py's zero-edge case on both packages."""
    e = np.zeros(0, np.int64)
    ref_g, g = _both(e, e, 5, pad_to=8)
    assert (g.n_edges, g.e_pad) == (0, 8)
    shrunk, ref_shrunk = pad_graph(g, 4), ref_pad_graph(ref_g, 4)
    _assert_graph_equal(shrunk, ref_shrunk)
    assert (shrunk.n_edges, shrunk.e_pad) == (0, 4)
    grown, ref_grown = pad_graph(shrunk, 16), ref_pad_graph(ref_shrunk, 16)
    _assert_graph_equal(grown, ref_grown)
    assert grown.e_pad == 16 and bool((grown.senders == 5).all())
    assert not bool(grown.edge_mask.any())
    assert pad_graph(grown, 16) is grown


def test_pad_graph_shrink_keeps_real_edges_equals_reference():
    """tests/test_serve_mis.py's shrink case on both packages."""
    ref_g, g = _both(np.array([0, 1]), np.array([1, 2]), 3, pad_to=64)
    shrunk = pad_graph(g, g.n_edges)
    _assert_graph_equal(shrunk, ref_pad_graph(ref_g, ref_g.n_edges))
    assert shrunk.e_pad == g.n_edges == 4
    assert torch.equal(shrunk.senders, g.senders[: g.n_edges])
    with pytest.raises(ValueError, match="real edges"):
        pad_graph(g, 2)
    with pytest.raises(ValueError, match="real edges"):
        ref_pad_graph(ref_g, 2)


@pytest.mark.parametrize("pad_to", [None, 5000])
def test_build_csr_equals_reference(pad_to):
    ref_g = ref_powerlaw(700, avg_deg=4.0, seed=1)
    E = ref_g.n_edges
    ref_g, g = _both(np.asarray(ref_g.senders)[:E], np.asarray(ref_g.receivers)[:E], 700,
                     pad_to=pad_to)
    indptr, indices = build_csr(g)
    want_ptr, want_idx = ref_build_csr(ref_g)
    np.testing.assert_array_equal(indptr, want_ptr)
    np.testing.assert_array_equal(indices, want_idx)
    assert (indptr.dtype, indices.dtype) == (np.int64, np.int32)
    assert indptr[-1] == g.n_edges


def test_build_csr_empty_graph_equals_reference():
    e = np.zeros(0, np.int64)
    ref_g, g = _both(e, e, 4, pad_to=8)
    for got, want in zip(build_csr(g), ref_build_csr(ref_g)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_to_networkx_equals_reference():
    ref_g = ref_powerlaw(300, avg_deg=3.0, seed=4)
    got, want = to_networkx(_port_graph(ref_g)), ref_to_networkx(ref_g)
    assert sorted(got.nodes) == sorted(want.nodes) == list(range(300))
    assert {frozenset(e) for e in got.edges} == {frozenset(e) for e in want.edges}
    assert got.number_of_edges() == ref_g.n_edges // 2


# --------------------------------------------------------------------------
# graphs.partition
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_partition_helpers_equal_reference(n_shards):
    rng = np.random.default_rng(n_shards)
    s = rng.integers(0, 500, 3000).astype(np.int32)
    r = rng.integers(0, 500, 3000).astype(np.int32)
    np.testing.assert_array_equal(partition_rows(500, n_shards),
                                  ref_partition.partition_rows(500, n_shards))
    for got, want in zip(partition_edges(s, r, 500, n_shards),
                         ref_partition.partition_edges(s, r, 500, n_shards)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    empty = np.zeros(0, np.int32)
    for got, want in zip(partition_edges(empty, empty, 10, n_shards),
                         ref_partition.partition_edges(empty, empty, 10, n_shards)):
        np.testing.assert_array_equal(got, want)
    x = rng.integers(0, 9, (7, 3))
    for axis, mult in ((0, 4), (1, 3), (1, 5)):
        np.testing.assert_array_equal(pad_to_multiple(x, mult, -1, axis),
                                      ref_partition.pad_to_multiple(x, mult, -1, axis))


# --------------------------------------------------------------------------
# core.tiling
# --------------------------------------------------------------------------

@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [8, 16, 64])
def test_tile_stats_equal_reference(T, storage):
    ref_g = ref_powerlaw(900, avg_deg=6.0, seed=3)
    want = ref_tile_stats(ref_build_block_tiles(ref_g, tile_size=T, storage=storage))
    got = tile_stats(build_block_tiles(_port_graph(ref_g), tile_size=T, storage=storage))
    assert got == want
    assert list(got["nnz_hist"]) == list(want["nnz_hist"])


def test_unpack_vertex_vector_equals_reference():
    ref_g = ref_powerlaw(300, avg_deg=3.0, seed=0)
    ref_t = ref_build_block_tiles(ref_g, tile_size=16)
    t = build_block_tiles(_port_graph(ref_g), tile_size=16)
    x = np.random.default_rng(0).standard_normal((t.n_padded, 3)).astype(np.float32)
    np.testing.assert_array_equal(unpack_vertex_vector(torch.from_numpy(x), t).numpy(),
                                  np.asarray(ref_unpack_vertex_vector(jnp.asarray(x), ref_t)))
    assert unpack_vertex_vector(torch.from_numpy(x), t).shape == (300, 3)


# --------------------------------------------------------------------------
# core.spmv: the tiled operators on both backends
# --------------------------------------------------------------------------

def _tilings(storage, T=16):
    ref_g = ref_powerlaw(300, avg_deg=4.0, seed=9)
    return (ref_build_block_tiles(ref_g, tile_size=T, storage=storage),
            build_block_tiles(_port_graph(ref_g), tile_size=T, storage=storage))


def _covered(t):
    """Rows of block-rows that own a tile: the reference's split Pallas
    kernel leaves the others unwritten, the port writes 0 there."""
    return (t.row_starts[1:] > t.row_starts[:-1]).repeat_interleave(t.tile_size).numpy()


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("backend", ["ref", "pallas"])
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
def test_spmv_tiled_equals_reference(storage, backend, gated):
    ref_t, t = _tilings(storage)
    rng = np.random.default_rng(1)
    rhs = rng.uniform(0.0, 1.0, (t.n_padded, 8)).astype(np.float32)
    rhs[:, :2] = rng.random((t.n_padded, 2)) < 0.4          # the 0/1 lanes
    flags = (rng.random(t.n_block_cols) < 0.6).astype(np.int32) if gated else None
    want = np.asarray(ref_spmv.spmv_tiled(
        ref_t, jnp.asarray(rhs), backend=backend,
        col_flags=None if flags is None else jnp.asarray(flags)))
    launches = K.tc_spmv.launches
    got = spmv.spmv_tiled(t, torch.from_numpy(rhs), backend=backend,
                          col_flags=None if flags is None else torch.from_numpy(flags)).numpy()
    assert K.tc_spmv.launches == launches      # CPU tensors: the plain version
    rows = _covered(t)
    np.testing.assert_allclose(got[rows, :2], want[rows, :2], rtol=0, atol=0)
    np.testing.assert_allclose(got[rows, 2:], want[rows, 2:], rtol=1e-6)
    assert not got[~rows].any()
    if backend == "ref":
        np.testing.assert_array_equal(got[~rows], want[~rows])


@pytest.mark.parametrize("backend", ["ref", "pallas"])
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
def test_neighbor_max_tiled_equals_reference(storage, backend):
    ref_t, t = _tilings(storage)
    rng = np.random.default_rng(2)
    p = rng.integers(-(1 << 31), (1 << 31) - 1, t.n_padded, dtype=np.int64).astype(np.int32)
    mask = rng.random(t.n_padded) < 0.5
    want = np.asarray(ref_spmv.neighbor_max_tiled(ref_t, jnp.asarray(p), jnp.asarray(mask),
                                                  backend=backend))
    got = spmv.neighbor_max_tiled(t, torch.from_numpy(p), torch.from_numpy(mask),
                                  backend=backend)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if backend == "pallas":
        np.testing.assert_array_equal(
            got.numpy(), N.tc_neighbor_max_plain(t, torch.from_numpy(p),
                                                 torch.from_numpy(mask)).numpy())


def test_tiled_operators_refuse_an_unknown_backend():
    _, t = _tilings("int8", T=8)
    rhs = torch.zeros((t.n_padded, 2))
    for call in (lambda: spmv.spmv_tiled(t, rhs, backend="tiled"),
                 lambda: spmv.neighbor_max_tiled(t, rhs[:, 0].int(), rhs[:, 0] > 0,
                                                 backend="cuda")):
        with pytest.raises(ValueError, match="unknown backend"):
            call()


def test_spmv_tiled_at_gin_width():
    """GIN's call (`models/gnn/gin.py`): a (n_padded, 64) f32 feature matrix
    through `backend="pallas"`, against the reference's."""
    ref_t, t = _tilings("int8")
    h = np.random.default_rng(3).uniform(0.0, 1.0, (t.n_padded, 64)).astype(np.float32)
    want = np.asarray(ref_spmv.spmv_tiled(ref_t, jnp.asarray(h), backend="pallas"))
    got = spmv.spmv_tiled(t, torch.from_numpy(h), backend="pallas").numpy()
    rows = _covered(t)
    np.testing.assert_allclose(got[rows], want[rows], rtol=1e-6)
