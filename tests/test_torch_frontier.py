"""The port's packed-frontier substrate against the JAX reference: the
packing and priority-sort helpers of `core.tiling`, the plain-torch word
operators of `core.engine` (the clz form of the bitwise phase ① and the
word-AND phase ②), the per-solve bitwise context, and the frontier policy.
Words are compared as uint32 (`words_to_numpy`); every comparison is
exact."""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import SolveOptions as RefOptions
from repro.core import engine as ref_engine
from repro.core.heuristics import Priorities as RefPriorities
from repro.core import tiling as ref_tiling
from repro.kernels import ref as ref_oracles
from repro_torch.api import SolveOptions
from repro_torch.core import engine
from repro_torch.core import tiling
from repro_torch.core.heuristics import Priorities
from repro_torch.core.spmv import INT32_MIN
from repro_torch.device import to_torch, words_to_numpy
from test_torch_spmv import _tilings

TILE_SIZES = (8, 16, 32, 64, 128)


# --------------------------------------------------------------------------
# packing helpers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("T", TILE_SIZES)
def test_frontier_packing_matches_reference(T):
    rng = np.random.default_rng(T)
    bits = rng.random((5, 3, T)) < 0.4
    bits[0, 0] = True                      # a word with bit 31 set (T >= 32)
    want = ref_tiling.pack_frontier_bits(jnp.asarray(bits), T)
    got = tiling.pack_frontier_bits(torch.from_numpy(bits), T)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(words_to_numpy(got), np.asarray(want))
    np.testing.assert_array_equal(
        tiling.unpack_frontier_bits(got, T).numpy(),
        np.asarray(ref_tiling.unpack_frontier_bits(want, T)))
    np.testing.assert_array_equal(tiling.unpack_frontier_bits(got, T).numpy(), bits)

    vec = bits.reshape(-1)
    want_w = ref_tiling.pack_frontier_words(jnp.asarray(vec), T)
    got_w = tiling.pack_frontier_words(torch.from_numpy(vec), T)
    np.testing.assert_array_equal(words_to_numpy(got_w), np.asarray(want_w))
    np.testing.assert_array_equal(tiling.unpack_frontier_words(got_w, T).numpy(),
                                  np.asarray(ref_tiling.unpack_frontier_words(want_w, T)))

    want_s = ref_tiling.pack_sorted_frontier_bits(jnp.asarray(bits), T)
    got_s = tiling.pack_sorted_frontier_bits(torch.from_numpy(bits), T)
    np.testing.assert_array_equal(words_to_numpy(got_s), np.asarray(want_s))
    if T < 32:   # only the low T bits are live in the standard layout
        assert int(words_to_numpy(got).max()) < (1 << T)


@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [8, 16, 32, 64])
def test_tiles_as_words_matches_reference(T, storage):
    ref, port = _tilings("random", T, storage)
    got = tiling.tiles_as_words(port.tiles, T)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(words_to_numpy(got),
                                  np.asarray(ref_tiling.tiles_as_words(ref.tiles, T)))
    if storage == "bitpack":
        assert got is port.tiles


def _tie_heavy_keys(n_blocks, T, seed):
    """H3-style select keys (q << 23, few levels, many ties), a few
    negative resolve-style keys and int32 min."""
    rng = np.random.default_rng(seed)
    p = (rng.integers(0, 4, n_blocks * T) << 23).astype(np.int32)
    p[::7] = -rng.integers(1, 1 << 30, p[::7].shape[0])
    p[3] = INT32_MIN
    p[T + 1] = INT32_MIN
    return p


@pytest.mark.parametrize("T", [8, 16, 32, 64])
def test_priority_sort_matches_reference_with_ties_and_int32_min(T):
    ref, port = _tilings("random", T, "bitpack", seed=T)
    p = _tie_heavy_keys(ref.n_block_cols, T, seed=T)
    want_order, want_ps = ref_tiling.sort_block_priorities(jnp.asarray(p), T)
    got_order, got_ps = tiling.sort_block_priorities(torch.from_numpy(p), T)
    assert got_order.dtype == torch.int32
    np.testing.assert_array_equal(got_order.numpy(), np.asarray(want_order))
    np.testing.assert_array_equal(got_ps.numpy(), np.asarray(want_ps))
    # a stable sort on -p: int32 min negates to itself and sorts first
    assert got_ps[0, 0] == INT32_MIN

    want_tiles = ref_tiling.sorted_tile_bits(ref.tiles, ref.tile_cols, want_order, T)
    got_tiles = tiling.sorted_tile_bits(port.tiles, port.tile_cols, got_order, T)
    np.testing.assert_array_equal(words_to_numpy(got_tiles), np.asarray(want_tiles))
    int8_tiles = tiling.unpack_tile_bits(port.tiles, T)
    np.testing.assert_array_equal(
        words_to_numpy(tiling.sorted_tile_bits(int8_tiles, port.tile_cols, got_order, T)),
        np.asarray(want_tiles))

    mask = np.random.default_rng(1).random(ref.n_padded) < 0.5
    words = ref_tiling.pack_frontier_words(jnp.asarray(mask), T)
    want_sw = ref_tiling.sorted_frontier_words(words, want_order, T)
    got_sw = tiling.sorted_frontier_words(to_torch(np.asarray(words), "cpu"), got_order, T)
    np.testing.assert_array_equal(words_to_numpy(got_sw), np.asarray(want_sw))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("T", [8, 16, 32, 64])
def test_priority_planes_match_reference(T, signed):
    rng = np.random.default_rng(T)
    n = 6 * T
    if signed:
        p = -rng.integers(0, 1 << 31, n).astype(np.int64)
        p[0], p[1] = INT32_MIN, 0
        n_bits = 32
    else:
        p = rng.integers(0, 1 << 31, n)
        n_bits = 31
    p = p.astype(np.int32)
    want = ref_tiling.pack_priority_planes(jnp.asarray(p), T, n_bits, signed=signed)
    got = tiling.pack_priority_planes(torch.from_numpy(p), T, n_bits, signed=signed)
    assert got.shape == (n_bits, n // T, tiling.packed_words(T))
    np.testing.assert_array_equal(words_to_numpy(got), np.asarray(want))


def test_clz32_is_exact_on_every_bit_position():
    words = [1 << b for b in range(32)] + [(1 << b) - 1 for b in range(1, 33)]
    words += list(np.random.default_rng(0).integers(1, 1 << 32, 200))
    u = np.array(words, dtype=np.uint64).astype(np.uint32)
    want = np.array([32 - int(w).bit_length() for w in u], np.int32)
    got = engine.clz32(torch.from_numpy(u.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# plain-torch word operators
# --------------------------------------------------------------------------

@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("T", [8, 16, 32])
@pytest.mark.parametrize("kind", ["random", "clustered"])
def test_tile_spmv_bits_matches_reference_and_oracle(kind, T, gated):
    ref, port = _tilings(kind, T, "bitpack", seed=T)
    rng = np.random.default_rng(T + 1)
    cand = rng.random(ref.n_padded) < 0.3
    cand_w = ref_tiling.pack_frontier_words(jnp.asarray(cand), T)
    flags = None
    if gated:
        flags = ((rng.random(ref.n_block_cols) >= 1 / 3)
                 & cand.reshape(-1, T).any(axis=1)).astype(np.int32)
    jflags = None if flags is None else jnp.asarray(flags)
    want = ref_engine.tile_spmv_bits(ref.tiles, ref.tile_rows, ref.tile_cols, cand_w,
                                     ref.n_block_rows, T, col_flags=jflags)
    got = engine.tile_spmv_bits(port.tiles, port.tile_rows, port.tile_cols,
                                to_torch(np.asarray(cand_w), "cpu"), port.n_block_rows, T,
                                col_flags=None if flags is None else torch.from_numpy(flags))
    np.testing.assert_array_equal(words_to_numpy(got), np.asarray(want))
    oracle = ref_oracles.tc_spmv_bits_ref(ref.tiles, ref.tile_rows, ref.tile_cols, cand_w,
                                          ref.n_block_rows, col_flags=jflags)
    np.testing.assert_array_equal(words_to_numpy(got), np.asarray(oracle))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("T", [8, 16, 32, 64])
@pytest.mark.parametrize("kind", ["random", "clustered"])
def test_clz_neighbor_max_matches_reference_and_oracle(kind, T, signed):
    ref, port = _tilings(kind, T, "bitpack", seed=T)
    rng = np.random.default_rng(T + 2)
    p = (-rng.integers(1, 1 << 24, ref.n_padded) if signed
         else rng.integers(0, 4, ref.n_padded) << 23).astype(np.int32)
    mask_w = ref_tiling.pack_frontier_words(jnp.asarray(rng.random(ref.n_padded) < 0.4), T)
    order, p_sorted = ref_tiling.sort_block_priorities(jnp.asarray(p), T)
    want = ref_engine.tile_neighbor_max_bits(
        ref_tiling.sorted_tile_bits(ref.tiles, ref.tile_cols, order, T),
        ref.tile_rows, ref.tile_cols, p_sorted,
        ref_tiling.sorted_frontier_words(mask_w, order, T), ref.n_block_rows, T)
    got_order, got_ps = tiling.sort_block_priorities(torch.from_numpy(p), T)
    got = engine.tile_neighbor_max_bits(
        tiling.sorted_tile_bits(port.tiles, port.tile_cols, got_order, T),
        port.tile_rows, port.tile_cols, got_ps,
        tiling.sorted_frontier_words(to_torch(np.asarray(mask_w), "cpu"), got_order, T),
        port.n_block_rows, T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    oracle = np.asarray(ref_oracles.tc_neighbor_max_bits_ref(
        ref.tiles, ref.tile_rows, ref.tile_cols, jnp.asarray(p), mask_w, ref.n_block_rows))
    # the oracle's uncovered rows come from its padded segment max too
    np.testing.assert_array_equal(got.numpy(), oracle)


def test_phase3_update_bits_is_the_word_rule():
    rng = np.random.default_rng(0)
    a, c, h = (torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (9, 2)).astype(np.int32))
               for _ in range(3))
    state = engine.MISRoundState(alive=a, in_mis=c & ~a, rnd=torch.tensor(4, dtype=torch.int32))
    new = engine.phase3_update_bits(state, c, h)
    assert torch.equal(new.alive, a & ~c & ~h)
    assert torch.equal(new.in_mis, (c & ~a) | c)
    assert int(new.rnd) == 5


# --------------------------------------------------------------------------
# per-solve bitwise context
# --------------------------------------------------------------------------

@pytest.mark.parametrize("storage", ["int8", "bitpack"])
def test_bitwise_context_matches_reference(storage):
    T = 16
    ref, port = _tilings("random", T, storage, seed=5)
    rng = np.random.default_rng(5)
    sel = (rng.integers(0, 8, ref.n_padded) << 23).astype(np.int32)
    res = (-rng.integers(0, 1 << 30, ref.n_padded)).astype(np.int32)
    want = ref_engine.make_bitwise_context(
        ref, RefPriorities(jnp.asarray(sel), jnp.asarray(res)), planes=True)
    pri = Priorities(torch.from_numpy(sel), torch.from_numpy(res))
    sorted_ctx = engine.make_bitwise_context(port, pri, planes=False)
    plane_ctx = engine.make_bitwise_context(port, pri, planes=True)
    for ctx in (sorted_ctx, plane_ctx):
        np.testing.assert_array_equal(words_to_numpy(ctx.tiles_bits),
                                      np.asarray(want.tiles_bits))
    for got, ref_st in ((sorted_ctx.select, want.select), (sorted_ctx.resolve, want.resolve)):
        np.testing.assert_array_equal(got.order.numpy(), np.asarray(ref_st.order))
        np.testing.assert_array_equal(got.p_sorted.numpy(), np.asarray(ref_st.p_sorted))
        np.testing.assert_array_equal(words_to_numpy(got.tiles), np.asarray(ref_st.tiles))
    assert sorted_ctx.select_planes is None and plane_ctx.select is None
    np.testing.assert_array_equal(words_to_numpy(plane_ctx.select_planes),
                                  np.asarray(want.select_planes))
    np.testing.assert_array_equal(words_to_numpy(plane_ctx.resolve_planes),
                                  np.asarray(want.resolve_planes))
    assert plane_ctx.select_planes.shape[0] == engine.SELECT_PLANE_BITS
    assert plane_ctx.resolve_planes.shape[0] == engine.RESOLVE_PLANE_BITS


@pytest.mark.parametrize("name", ["tiled_pallas", "fused_pallas"])
def test_hopper_engines_refuse_a_context_without_planes(name):
    """The Hopper engines' bitwise phase ① is the plane-scan kernel and
    nothing else: a sorted-only context raises, it does not fall back to
    the clz form."""
    T = 16
    _, port = _tilings("random", T, "bitpack", seed=5)
    rng = np.random.default_rng(5)
    sel = torch.from_numpy((rng.integers(0, 8, port.n_padded) << 23).astype(np.int32))
    res = torch.from_numpy((-rng.integers(0, 1 << 30, port.n_padded)).astype(np.int32))
    pri = Priorities(sel, res)
    eng = engine.get_engine(name)
    assert eng.plane_kernel_nbr_max
    ctx = engine.EngineContext(
        g=None, tiled=port, cfg=SolveOptions(engine=name, phase1="tiled"),
        frontier="bitwise", bits=engine.make_bitwise_context(port, pri, planes=False))
    alive_w = tiling.pack_frontier_words(torch.ones(port.n_padded, dtype=torch.bool), T)
    with pytest.raises(ValueError, match="needs the priority planes"):
        eng.phase1_candidates_bits(ctx, pri, alive_w)
    # with the planes built, the same call runs
    ctx = dataclasses.replace(ctx, bits=engine.make_bitwise_context(port, pri, planes=True))
    cand = eng.phase1_candidates_bits(ctx, pri, alive_w)
    assert cand.shape == alive_w.shape


# --------------------------------------------------------------------------
# frontier policy
# --------------------------------------------------------------------------

def test_resolve_frontier_matches_reference_for_every_combination():
    combos = itertools.product(engine.engine_names(), ("segment", "tiled"),
                               ("auto", "dense", "bitwise"), ("int8", "bitpack"),
                               (False, True))
    seen = set()
    for name, phase1, frontier, storage, member_rounds in combos:
        got = engine.resolve_frontier(
            SolveOptions(engine=name, phase1=phase1, frontier=frontier),
            engine.get_engine(name), storage=storage, member_rounds=member_rounds)
        want = ref_engine.resolve_frontier(
            RefOptions(engine=name, phase1=phase1, frontier=frontier),
            ref_engine.get_engine(name), storage=storage, member_rounds=member_rounds)
        assert got == want, (name, phase1, frontier, storage, member_rounds)
        seen.add(got)
    assert seen == {"dense", "bitwise"}
