"""The port's tiled SpMV (`repro_torch.hopper.tc_spmv`), on the dense and
the packed-word frontier, against the JAX reference's Pallas kernels, run
as the reference's own tests run them on the CPU (`interpret=True`).  On
CPU tensors the port's wrappers take their plain-torch versions; the CUDA
kernels themselves are held against those plain versions on the card
(tests/test_torch_gpu.py, and chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import tile_spmv as ref_tile_spmv
from repro.core.tiling import build_block_tiles as ref_build_block_tiles
from repro.core.tiling import pack_frontier_words as ref_pack_frontier_words
from repro.graphs.graph import from_edges as ref_from_edges
from repro.kernels import ops
from repro.kernels import ref as ref_oracles
from repro_torch.core.tiling import (
    pack_frontier_words,
    tiles_as_words,
    tiling_from_arrays,
)
from repro_torch.device import to_torch, words_to_numpy
from repro_torch.hopper import tc_spmv as K

LANES = 8
# Split SpMV on a random f32 RHS: XLA's per-tile dot and torch's bmm +
# index_add_ sum the same terms in different orders, so results differ in
# the last bits of f32 (ε = 1.2e-7) on sums of up to a few dozen O(1)
# terms; 1e-6 absolute and relative covers that with margin.
SPLIT_TOL = 1e-6


def _edges(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "clustered":
        # the reference test_engine graph: edges confined to [0, n//3), so
        # most block-rows store no tiles and vertices >= n//3 are isolated
        n, hi = 100, 33
        return rng.integers(0, hi, 4 * hi), rng.integers(0, hi, 4 * hi), n
    n = 160
    m = 3 * n
    return rng.integers(0, n, m), rng.integers(0, n, m), n


def _tilings(kind, T, storage, seed=0):
    """The reference tiling and the port's copy of its arrays."""
    src, dst, n = _edges(kind, seed)
    ref = ref_build_block_tiles(ref_from_edges(src, dst, n), tile_size=T, storage=storage)
    arrays = {k: np.asarray(getattr(ref, k))
              for k in ("tiles", "tile_rows", "tile_cols", "row_starts")}
    t = tiling_from_arrays(
        arrays, n_tiles=ref.n_tiles, n_nodes=ref.n_nodes, tile_size=T,
        n_block_rows=ref.n_block_rows, n_block_cols=ref.n_block_cols,
        storage=storage, device="cpu",
    )
    return ref, t


def _frontier(n_padded, T, seed, gated):
    rng = np.random.default_rng(seed)
    alive = rng.random(n_padded) < 0.7
    cand = alive & (rng.random(n_padded) < 0.3)
    flags = None
    if gated:
        gate = rng.random(n_padded // T) >= 1 / 3
        flags = (cand.reshape(-1, T).any(axis=1) & gate).astype(np.int32)
    return cand, alive, flags


def _covered_rows(ref):
    rs = np.asarray(ref.row_starts)
    return np.repeat(rs[1:] > rs[:-1], ref.tile_size)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [8, 16, 32])
@pytest.mark.parametrize("kind", ["random", "clustered"])
def test_fused_matches_pallas_exactly(kind, T, storage, gated):
    ref, t = _tilings(kind, T, storage)
    cand, alive, flags = _frontier(ref.n_padded, T, seed=T, gated=gated)
    rng = np.random.default_rng(1)
    rhs = (rng.random((ref.n_padded, LANES)) < 0.5).astype(np.float32)
    rhs[:, 0], rhs[:, 1] = cand, alive
    want = ops.tc_spmv_fused(
        ref, jnp.asarray(rhs), jnp.asarray(cand), jnp.asarray(alive),
        col_flags=None if flags is None else jnp.asarray(flags), interpret=True,
    )
    got = K.tc_spmv_fused(
        t, torch.from_numpy(rhs), torch.from_numpy(cand), torch.from_numpy(alive),
        col_flags=None if flags is None else torch.from_numpy(flags),
    )
    assert got[1].dtype == torch.bool and got[2].dtype == torch.bool
    for name, a, b in zip(("n_c", "new_alive", "mis_add"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [8, 16, 32])
@pytest.mark.parametrize("kind", ["random", "clustered"])
def test_split_matches_pallas(kind, T, storage, gated):
    ref, t = _tilings(kind, T, storage)
    _, _, flags = _frontier(ref.n_padded, T, seed=T + 1, gated=gated)
    rhs = np.random.default_rng(2).standard_normal((ref.n_padded, LANES)).astype(np.float32)
    jflags = None if flags is None else jnp.asarray(flags)
    tflags = None if flags is None else torch.from_numpy(flags)
    got = K.tc_spmv(t, torch.from_numpy(rhs), col_flags=tflags).numpy()
    pallas = np.asarray(ops.tc_spmv(ref, jnp.asarray(rhs), col_flags=jflags, interpret=True))
    # the Pallas kernel never writes block-rows that own no tile (the
    # reference masks them downstream); the port writes 0 there, like the
    # reference's jnp oracle, so those rows are held against the oracle
    covered = _covered_rows(ref)
    np.testing.assert_allclose(got[covered], pallas[covered],
                               rtol=SPLIT_TOL, atol=SPLIT_TOL)
    oracle = np.asarray(ref_tile_spmv(
        ref.tiles, ref.tile_rows, ref.tile_cols, jnp.asarray(rhs),
        ref.n_block_rows, T, col_flags=jflags,
    ))
    np.testing.assert_allclose(got, oracle, rtol=SPLIT_TOL, atol=SPLIT_TOL)


def test_three_way_bf16_split_gives_back_f32_exactly():
    """The dense kernel feeds an f32 RHS to the tensor cores as three bf16
    parts, hi = rn(x), mid = rn(x - hi), lo = rn(x - hi - mid), with
    `__float2bfloat16_rn`; torch's bf16 cast rounds the same way (to nearest,
    ties to even).  For finite x with 2^-110 <= |x| < 2^128·(1 - 2^-9), and
    0, the parts sum back to x exactly, so each 0/1 × part product, and a
    row with one nonzero term, is exact.  Seeded full 24-bit mantissas over
    that exponent range, the mantissa that rounds up to the next power of
    two, and the range's ends."""
    rng = np.random.default_rng(0)
    n = 1 << 16
    mant = rng.integers(0, 1 << 23, n)
    mant[::97] = (1 << 23) - 1
    x = np.ldexp(1 + mant * 2.0 ** -23, rng.integers(-110, 127, n)) * rng.choice([-1, 1], n)
    ends = [2.0 ** 127 * (2 - 2.0 ** -8 - 2.0 ** -23), 2.0 ** -110 * (2 - 2.0 ** -23),
            2.0 ** -110, 0.0, -0.0]
    x = torch.from_numpy(np.concatenate([x, ends, np.negative(ends)]).astype(np.float32))
    assert bool(torch.isfinite(x).all())
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    assert torch.equal(lo.float(), rest - mid.float())      # nothing left over
    assert torch.equal(hi.float() + mid.float() + lo.float(), x)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())


def _words_frontier(ref, T, seed, gated):
    """Packed cand / alive words (reference, port) and optional flags."""
    cand, alive, flags = _frontier(ref.n_padded, T, seed=seed, gated=gated)
    cand_w = ref_pack_frontier_words(jnp.asarray(cand), T)
    alive_w = ref_pack_frontier_words(jnp.asarray(alive), T)
    port = [to_torch(np.asarray(w), "cpu") for w in (cand_w, alive_w)]
    return (cand_w, alive_w), port, flags


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("T", [8, 16, 32])
@pytest.mark.parametrize("kind", ["random", "clustered"])
def test_split_bits_matches_pallas_and_oracle(kind, T, gated):
    ref, t = _tilings(kind, T, "bitpack")
    (cand_w, _), (tcand, _), flags = _words_frontier(ref, T, seed=T + 2, gated=gated)
    jflags = None if flags is None else jnp.asarray(flags)
    got = K.tc_spmv_bits(t, tcand, col_flags=None if flags is None else torch.from_numpy(flags))
    assert got.dtype == torch.int32 and got.shape == (ref.n_block_rows, t.tiles.shape[-1])
    want = ops.tc_spmv_bits(ref, cand_w, col_flags=jflags, interpret=True)
    np.testing.assert_array_equal(words_to_numpy(got), np.asarray(want))
    oracle = ref_oracles.tc_spmv_bits_ref(ref.tiles, ref.tile_rows, ref.tile_cols, cand_w,
                                          ref.n_block_rows, col_flags=jflags)
    np.testing.assert_array_equal(words_to_numpy(got), np.asarray(oracle))


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [8, 16, 32])
@pytest.mark.parametrize("kind", ["random", "clustered"])
def test_fused_bits_matches_pallas_exactly(kind, T, storage, gated):
    ref, t = _tilings(kind, T, storage)
    (cand_w, alive_w), (tcand, talive), flags = _words_frontier(ref, T, seed=T, gated=gated)
    tflags = None if flags is None else torch.from_numpy(flags)
    got = K.tc_spmv_fused_bits(t, tcand, talive, col_flags=tflags)
    want = ops.tc_spmv_fused_bits(ref, cand_w, alive_w,
                                  col_flags=None if flags is None else jnp.asarray(flags),
                                  interpret=True)
    for name, a, b in zip(("hit", "new_alive", "mis_add"), got, want):
        np.testing.assert_array_equal(words_to_numpy(a), np.asarray(b), err_msg=name)
    oracle = ref_oracles.tc_spmv_bits_ref(
        ref.tiles, ref.tile_rows, ref.tile_cols, cand_w, ref.n_block_rows,
        col_flags=None if flags is None else jnp.asarray(flags))
    np.testing.assert_array_equal(words_to_numpy(got[0]), np.asarray(oracle))
    # the words agree with the dense fused kernel's masks on the same frontier
    cand, alive = (torch.from_numpy(np.asarray(x)) for x in _frontier(
        ref.n_padded, T, seed=T, gated=gated)[:2])
    rhs = torch.zeros((ref.n_padded, LANES))
    rhs[:, 0], rhs[:, 1] = cand.float(), alive.float()
    _, dense_alive, dense_add = K.tc_spmv_fused(t, rhs, cand, alive, col_flags=tflags)
    assert torch.equal(got[1], pack_frontier_words(dense_alive, T))
    assert torch.equal(got[2], pack_frontier_words(dense_add, T))
    assert torch.equal(got[0], K.tc_spmv_bits(t, tcand, tiles_words=tiles_as_words(t.tiles, T),
                                              col_flags=tflags))


def test_wrapper_rejects_mixed_devices_and_plain_counts_nothing():
    _, t = _tilings("random", 16, "int8")
    rhs = torch.zeros((t.n_padded, LANES))
    words = torch.zeros((t.n_block_cols, 1), dtype=torch.int32)
    counts = lambda: (K.tc_spmv.launches, K.tc_spmv_fused.launches,  # noqa: E731
                      K.tc_spmv_bits.launches, K.tc_spmv_fused_bits.launches)
    before = counts()
    K.tc_spmv(t, rhs)
    K.tc_spmv_bits(t, words)
    K.tc_spmv_fused_bits(t, words, words)
    assert counts() == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        K._launch(t, rhs, None, None)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        K._launch_bits(t, tiles_as_words(t.tiles, 16), words, words, None)
    with pytest.raises(ValueError, match="mixed devices"):
        K.tc_spmv_bits(t, words.to("meta"))
