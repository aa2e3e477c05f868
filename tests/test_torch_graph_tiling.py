"""Parity of the PyTorch port's graph container and BSR tiling with the
JAX reference: the same edge lists give array-equal graphs, tilings
(bitpack words compared as uint32) and packed tiles."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tiling as ref_tiling
from repro.graphs import generators as ref_gen
from repro.graphs.graph import from_edges as ref_from_edges
from repro_torch.core import tiling
from repro_torch.device import words_to_numpy
from repro_torch.graphs import generators as gen
from repro_torch.graphs.graph import from_edges

TILE_SIZES = (8, 16, 32, 64, 128)


def _noisy_edges(n, m, seed):
    """Random edge list with self-loops and duplicates."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    src[: m // 10] = dst[: m // 10]                 # self-loops
    return np.concatenate([src, dst[:20]]), np.concatenate([dst, src[:20]])


def _graph_pair(kind, n=300, seed=0):
    if kind == "empty":
        e = np.zeros(0, np.int64)
        return ref_from_edges(e, e, 37), from_edges(e, e, 37, device="cpu")
    if kind == "clustered":   # empty block-rows and isolated vertices
        rng = np.random.default_rng(seed)
        hi = n // 3
        src, dst = rng.integers(0, hi, 4 * hi), rng.integers(0, hi, 4 * hi)
    else:
        src, dst = _noisy_edges(n, 3 * n, seed)
    return ref_from_edges(src, dst, n), from_edges(src, dst, n, device="cpu")


@pytest.mark.parametrize("pad_to", [None, 5000])
@pytest.mark.parametrize("seed", range(3))
def test_from_edges_matches_reference(seed, pad_to):
    src, dst = _noisy_edges(250, 900, seed)
    ref = ref_from_edges(src, dst, 250, pad_to=pad_to)
    g = from_edges(src, dst, 250, pad_to=pad_to, device="cpu")
    assert (g.n_nodes, g.n_edges, g.e_pad) == (ref.n_nodes, ref.n_edges, ref.e_pad)
    np.testing.assert_array_equal(g.senders.numpy(), np.asarray(ref.senders))
    np.testing.assert_array_equal(g.receivers.numpy(), np.asarray(ref.receivers))
    np.testing.assert_array_equal(g.edge_mask.numpy(), np.asarray(ref.edge_mask))
    np.testing.assert_array_equal(g.degrees().numpy(), np.asarray(ref.degrees()))
    assert g.senders.dtype == torch.int32 and g.receivers.dtype == torch.int32


@pytest.mark.parametrize("make", ["grid2d", "erdos_renyi", "random_regular"])
def test_generators_match_reference(make):
    args = {"grid2d": (13, 17), "erdos_renyi": (200, 6.0), "random_regular": (200, 5)}[make]
    ref = getattr(ref_gen, make)(*args, seed=3)
    g = getattr(gen, make)(*args, seed=3, device="cpu")
    assert (g.n_nodes, g.n_edges) == (ref.n_nodes, ref.n_edges)
    np.testing.assert_array_equal(g.senders.numpy(), np.asarray(ref.senders))
    np.testing.assert_array_equal(g.receivers.numpy(), np.asarray(ref.receivers))


def _assert_tilings_equal(t, ref):
    assert (t.n_tiles, t.n_nodes, t.tile_size, t.n_block_rows, t.n_block_cols,
            t.storage) == (ref.n_tiles, ref.n_nodes, ref.tile_size,
                           ref.n_block_rows, ref.n_block_cols, ref.storage)
    if t.storage == "bitpack":
        assert t.tiles.dtype == torch.int32
        np.testing.assert_array_equal(words_to_numpy(t.tiles), np.asarray(ref.tiles))
    else:
        assert t.tiles.dtype == torch.int8
        np.testing.assert_array_equal(t.tiles.numpy(), np.asarray(ref.tiles))
    for name in ("tile_rows", "tile_cols", "row_starts"):
        np.testing.assert_array_equal(
            getattr(t, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name
        )


@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", TILE_SIZES)
@pytest.mark.parametrize("kind", ["random", "clustered", "empty"])
def test_build_block_tiles_matches_reference(kind, T, storage):
    ref_g, g = _graph_pair(kind)
    ref = ref_tiling.build_block_tiles(ref_g, tile_size=T, storage=storage)
    t = tiling.build_block_tiles(g, tile_size=T, storage=storage)
    _assert_tilings_equal(t, ref)
    # the pad-to-8 tail: zero tiles on the last real block-row, column 0
    assert t.n_tiles_pad % 8 == 0 and t.n_tiles_pad >= max(t.n_tiles, 1)


@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [8, 32])
def test_build_block_tiles_rcm_and_pad_floor_match_reference(T, storage):
    ref_g, g = _graph_pair("random", n=400, seed=5)
    ref = ref_tiling.build_block_tiles(
        ref_g, tile_size=T, storage=storage, reorder="rcm", pad_tiles_to=2001
    )
    t = tiling.build_block_tiles(
        g, tile_size=T, storage=storage, reorder="rcm", pad_tiles_to=2001
    )
    _assert_tilings_equal(t, ref)
    assert t.n_tiles_pad == 2008
    np.testing.assert_array_equal(tiling.rcm_ordering(g), ref_tiling.rcm_ordering(ref_g))


@pytest.mark.parametrize("T", TILE_SIZES)
def test_pack_unpack_roundtrip_matches_reference(T):
    rng = np.random.default_rng(T)
    dense = (rng.random((6, T, T)) < 0.3).astype(np.int8)
    words = tiling.pack_tile_bits(torch.from_numpy(dense))
    assert words.shape == (6, T, tiling.packed_words(T)) and words.dtype == torch.int32
    ref_words = ref_tiling.pack_tile_bits(dense)
    np.testing.assert_array_equal(words_to_numpy(words), ref_words)
    back = tiling.unpack_tile_bits(words, T)
    np.testing.assert_array_equal(back.numpy(), dense)
    np.testing.assert_array_equal(
        tiling.unpack_tile_mask(words, T).numpy(),
        np.asarray(ref_tiling.unpack_tile_mask(jnp.asarray(ref_words), T)),
    )


@pytest.mark.parametrize("T", [8, 64])
def test_to_storage_roundtrip(T):
    _, g = _graph_pair("random", seed=2)
    t8 = tiling.build_block_tiles(g, tile_size=T, storage="int8")
    tb = tiling.build_block_tiles(g, tile_size=T, storage="bitpack")
    assert torch.equal(t8.to_storage("bitpack").tiles, tb.tiles)
    assert torch.equal(tb.to_storage("int8").tiles, t8.tiles)
    assert t8.to_storage("int8") is t8
    with pytest.raises(ValueError, match="unknown storage"):
        t8.to_storage("int4")


def test_vector_and_count_helpers():
    assert [tiling.next_pow2(x) for x in (0, 1, 5, 8, 9)] == [
        ref_tiling.next_pow2(x) for x in (0, 1, 5, 8, 9)
    ]
    for n_real, floor in [(0, None), (1, None), (9, None), (3, 20)]:
        assert tiling.padded_tile_count(n_real, floor) == ref_tiling.padded_tile_count(
            n_real, floor
        )
    _, g = _graph_pair("random", n=100)
    t = tiling.build_block_tiles(g, tile_size=16)
    x = torch.arange(100, dtype=torch.int32)
    padded = tiling.pack_vertex_vector(x, t)
    assert padded.shape == (112,) and torch.equal(padded[:100], x)
    assert not padded[100:].any()
