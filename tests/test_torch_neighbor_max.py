"""The port's tiled neighbour max (`repro_torch.hopper.tc_neighbor_max`)
against the JAX reference's Pallas kernels, run as the reference's own
tests run them on the CPU (`interpret=True`), and against the reference's
oracles.  On CPU tensors the wrappers take their plain-torch versions; the
CUDA kernels are held against those on the card (tests/test_torch_gpu.py,
and chip_smoke.py).  All values are integers: every comparison is
exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import tile_neighbor_max as ref_tile_neighbor_max
from repro.core.tiling import build_block_tiles as ref_build_block_tiles
from repro.graphs.graph import from_edges as ref_from_edges
from repro.core.tiling import pack_frontier_words as ref_pack_frontier_words
from repro.core.tiling import pack_priority_planes as ref_pack_priority_planes
from repro.kernels import ops
from repro.kernels import ref as ref_oracles
from repro_torch.core.engine import tile_neighbor_max
from repro_torch.core.spmv import INT32_MIN, _NEG
from repro_torch.core.tiling import (
    pack_frontier_words,
    pack_priority_planes,
    tiles_as_words,
    tiling_from_arrays,
)
from repro_torch.hopper import tc_neighbor_max as K
from test_torch_spmv import _covered_rows, _tilings

# keys at the edges of the order: select-style (unsigned, 31 planes) and
# resolve-style (signed, 32 sign-biased planes)
EXTREMES = {False: (0, (1 << 31) - 1), True: (INT32_MIN, -1, 0)}


def _extreme_keys(n, signed, seed):
    """About half the keys from EXTREMES[signed], the rest drawn over the
    whole unsigned or signed range."""
    rng = np.random.default_rng(seed)
    p = rng.integers(-(1 << 31) if signed else 0, 1 << 31, n)
    pick = rng.random(n) < 0.5
    p[pick] = rng.choice(EXTREMES[signed], int(pick.sum()))
    return p.astype(np.int32)


def _mask(n, kind, seed):
    return np.random.default_rng(seed).random(n) < 0.5 if kind == "random" else np.zeros(n, bool)


@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [8, 16, 32])
@pytest.mark.parametrize("kind", ["random", "clustered"])
def test_dense_neighbor_max_matches_pallas(kind, T, storage):
    ref, t = _tilings(kind, T, storage)
    rng = np.random.default_rng(T)
    p = rng.integers(-(1 << 20), 1 << 20, ref.n_padded).astype(np.int32)
    mask = rng.random(ref.n_padded) < 0.6
    got = K.tc_neighbor_max(t, torch.from_numpy(p), torch.from_numpy(mask)).numpy()
    assert got.dtype == np.int32
    pallas = np.asarray(ops.tc_neighbor_max(ref, jnp.asarray(p), jnp.asarray(mask),
                                            interpret=True))
    # the Pallas kernel never writes block-rows that own no tile; the port
    # writes int32 min there, as the jnp operator and the oracle do
    covered = _covered_rows(ref)
    np.testing.assert_array_equal(got[covered], pallas[covered])
    pm = jnp.asarray(np.where(mask, p, _NEG).astype(np.int32))
    np.testing.assert_array_equal(got, np.asarray(ref_tile_neighbor_max(
        ref.tiles, ref.tile_rows, ref.tile_cols, pm, ref.n_block_rows, T)))
    np.testing.assert_array_equal(got, np.asarray(ref_oracles.tc_neighbor_max_ref(
        ref.tiles, ref.tile_rows, ref.tile_cols, pm, ref.n_block_rows)))
    np.testing.assert_array_equal(got, tile_neighbor_max(
        t.tiles, t.tile_rows, t.tile_cols, torch.from_numpy(np.array(pm)),
        t.n_block_rows, T).numpy())
    if kind == "clustered":
        assert (~covered).any() and (got[~covered] == INT32_MIN).all()


def _planes(p, T, signed):
    return (ref_pack_priority_planes(jnp.asarray(p), T, 32 if signed else 31, signed=signed),
            pack_priority_planes(torch.from_numpy(p), T, 32 if signed else 31, signed=signed))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("T", [8, 16, 32])
@pytest.mark.parametrize("kind", ["random", "clustered"])
def test_plane_scan_matches_pallas_and_oracle(kind, T, signed):
    ref, t = _tilings(kind, T, "bitpack", seed=T)
    rng = np.random.default_rng(T + 5)
    if signed:   # resolve-style keys: negative, distinct
        p = (-rng.permutation(ref.n_padded) * 7 - 1).astype(np.int32)
    else:        # select-style keys: q << 23 with many ties
        p = (rng.integers(0, 16, ref.n_padded) << 23).astype(np.int32)
    mask = rng.random(ref.n_padded) < 0.5
    ref_mask_w = ref_pack_frontier_words(jnp.asarray(mask), T)
    ref_planes, planes = _planes(p, T, signed)
    got = K.tc_neighbor_max_bits(
        t, planes, pack_frontier_words(torch.from_numpy(mask), T), signed=signed).numpy()
    # the reference wrapper patches uncovered rows to int32 min, as the port's kernel
    want = np.asarray(ops.tc_neighbor_max_bits(ref, ref_planes, ref_mask_w, signed=signed,
                                               interpret=True))
    np.testing.assert_array_equal(got, want)
    oracle = np.asarray(ref_oracles.tc_neighbor_max_bits_ref(
        ref.tiles, ref.tile_rows, ref.tile_cols, jnp.asarray(p), ref_mask_w,
        ref.n_block_rows))
    np.testing.assert_array_equal(got, oracle)
    # the plane scan and the dense masked max are one function
    np.testing.assert_array_equal(got, K.tc_neighbor_max_plain(
        t, torch.from_numpy(p), torch.from_numpy(mask)).numpy())


@pytest.mark.parametrize("mask_kind", ["random", "dead"])
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [8, 16, 32])
def test_dense_neighbor_max_extreme_keys_and_dead_masks_match_pallas(T, storage, mask_kind):
    ref, t = _tilings("random", T, storage)
    covered = _covered_rows(ref)
    mask = _mask(ref.n_padded, mask_kind, T)
    for signed in (False, True):
        p = _extreme_keys(ref.n_padded, signed, T + signed)
        got = K.tc_neighbor_max(t, torch.from_numpy(p), torch.from_numpy(mask)).numpy()
        pallas = np.asarray(ops.tc_neighbor_max(ref, jnp.asarray(p), jnp.asarray(mask),
                                                interpret=True))
        np.testing.assert_array_equal(got[covered], pallas[covered])
        pm = jnp.asarray(np.where(mask, p, _NEG).astype(np.int32))
        np.testing.assert_array_equal(got, np.asarray(ref_tile_neighbor_max(
            ref.tiles, ref.tile_rows, ref.tile_cols, pm, ref.n_block_rows, T)))
        if mask_kind == "dead":
            assert (got[covered] == _NEG).all() and (got[~covered] == INT32_MIN).all()


@pytest.mark.parametrize("mask_kind", ["random", "dead"])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("T", [8, 16, 32])
def test_plane_scan_extreme_keys_and_dead_masks_match_pallas(T, signed, mask_kind):
    ref, t = _tilings("random", T, "bitpack", seed=T)
    p = _extreme_keys(ref.n_padded, signed, T)
    mask = _mask(ref.n_padded, mask_kind, T + 1)
    ref_mask_w = ref_pack_frontier_words(jnp.asarray(mask), T)
    ref_planes, planes = _planes(p, T, signed)
    got = K.tc_neighbor_max_bits(
        t, planes, pack_frontier_words(torch.from_numpy(mask), T), signed=signed).numpy()
    want = np.asarray(ops.tc_neighbor_max_bits(ref, ref_planes, ref_mask_w, signed=signed,
                                               interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(ref_oracles.tc_neighbor_max_bits_ref(
        ref.tiles, ref.tile_rows, ref.tile_cols, jnp.asarray(p), ref_mask_w,
        ref.n_block_rows)))
    if mask_kind == "dead":
        covered = _covered_rows(ref)
        assert (got[covered] == _NEG).all() and (got[~covered] == INT32_MIN).all()


@pytest.mark.parametrize("T", [8, 16])
def test_dense_neighbor_max_keeps_keys_below_neg_on_all_live_rows(T):
    """Blocks 0 and 1 joined completely, every vertex live, every key int32
    min: each tile row of blocks 0 and 1 is T live edges.  The Hopper
    wrapper's plain version floors every covered row at _NEG, as the Pallas
    `_nbr_max_kernel` (interpret mode) starts each row there (the kernel is
    held to the plain version on the card).  The jnp rule keeps the keys
    below _NEG: the port's `tile_neighbor_max`, which its `tiled_ref`
    engine runs, gives int32 min there, as the reference's does."""
    a, b = np.meshgrid(np.arange(T), np.arange(T, 2 * T))
    n = 4 * T
    ref = ref_build_block_tiles(ref_from_edges(a.ravel(), b.ravel(), n), tile_size=T)
    t = tiling_from_arrays(
        {k: np.asarray(getattr(ref, k)) for k in ("tiles", "tile_rows", "tile_cols", "row_starts")},
        n_tiles=ref.n_tiles, n_nodes=n, tile_size=T, n_block_rows=ref.n_block_rows,
        n_block_cols=ref.n_block_cols, storage="int8", device="cpu")
    p = np.full(ref.n_padded, INT32_MIN, dtype=np.int32)
    mask = np.ones(ref.n_padded, dtype=bool)
    got = K.tc_neighbor_max(t, torch.from_numpy(p), torch.from_numpy(mask)).numpy()
    pallas = np.asarray(ops.tc_neighbor_max(ref, jnp.asarray(p), jnp.asarray(mask),
                                            interpret=True))
    covered = _covered_rows(ref)
    np.testing.assert_array_equal(got[covered], pallas[covered])
    assert (got[: 2 * T] == _NEG).all() and (got[~covered] == INT32_MIN).all()
    nt = ref.n_tiles   # the real tiles: a zero padding tile adds _NEG to its block-row
    jnp_rule = tile_neighbor_max(t.tiles[:nt], t.tile_rows[:nt], t.tile_cols[:nt],
                                 torch.from_numpy(p), t.n_block_rows, T).numpy()
    np.testing.assert_array_equal(jnp_rule, np.asarray(ref_tile_neighbor_max(
        ref.tiles[:nt], ref.tile_rows[:nt], ref.tile_cols[:nt], jnp.asarray(p),
        ref.n_block_rows, T)))
    assert (jnp_rule[: 2 * T] == INT32_MIN).all()


def test_plane_scan_takes_int8_tiles_as_words():
    ref, t = _tilings("random", 16, "int8")
    p = np.random.default_rng(0).integers(0, 1 << 30, ref.n_padded).astype(np.int32)
    mask = torch.from_numpy(np.random.default_rng(1).random(ref.n_padded) < 0.5)
    _, planes = _planes(p, 16, False)
    words = tiles_as_words(t.tiles, 16)
    got = K.tc_neighbor_max_bits(t, planes, pack_frontier_words(mask, 16))
    assert torch.equal(got, K.tc_neighbor_max_bits(t, planes, pack_frontier_words(mask, 16),
                                                   tiles_words=words))
    assert torch.equal(got, K.tc_neighbor_max_plain(t, torch.from_numpy(p), mask))


def test_plain_versions_count_no_launch_and_kernels_refuse_cpu():
    _, t = _tilings("random", 16, "bitpack")
    p = torch.zeros(t.n_padded, dtype=torch.int32)
    mask = torch.ones(t.n_padded, dtype=torch.bool)
    planes = pack_priority_planes(p, 16, 31)
    words = pack_frontier_words(mask, 16)
    before = (K.tc_neighbor_max.launches, K.tc_neighbor_max_bits.launches)
    K.tc_neighbor_max(t, p, mask)
    K.tc_neighbor_max_bits(t, planes, words)
    assert (K.tc_neighbor_max.launches, K.tc_neighbor_max_bits.launches) == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        K._launch(t, p, mask)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        K._launch_bits(t, t.tiles, planes, words, False)


@pytest.mark.parametrize("n_bits, signed", [(31, True), (32, False), (30, False), (16, True)])
def test_plane_scan_takes_only_the_engines_plane_stacks(n_bits, signed):
    """31 unsigned select planes or 32 sign-biased resolve planes: any other
    stack is refused on every device, before the plain version or the
    kernel runs."""
    _, t = _tilings("random", 16, "bitpack")
    p = torch.zeros(t.n_padded, dtype=torch.int32)
    planes = pack_priority_planes(p, 16, n_bits, signed=signed)
    words = pack_frontier_words(torch.ones(t.n_padded, dtype=torch.bool), 16)
    with pytest.raises(ValueError, match="planes must be"):
        K.tc_neighbor_max_bits(t, planes, words, signed=signed)
