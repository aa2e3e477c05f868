"""The port's embedding bag (`repro_torch.hopper.embedding_bag`) against the
JAX reference: the Pallas `_bag_kernel`, run as the reference's own tests
run it on the CPU (interpret mode), and the oracle `embedding_bag_ref`.
On CPU tensors the port's wrapper takes its plain-torch version; the CUDA
kernel is held against that plain version on the card
(tests/test_torch_gpu.py, and chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels.ref import embedding_bag_ref
from repro_torch.hopper import embedding_bag as E

# f32 bag sums of up to 39 O(1) terms: the interpret-mode Pallas result and
# the oracle's `sum(axis=1)` differ by a few ulps of the sum (3.4e-6 seen
# at D ∈ {1, 10}, K = 39), and the port's sequential sum is one more order
TOL = 1e-5


def _inputs(B, K, D, V=500, weighted=True, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    idx = rng.integers(0, V, (B, K)).astype(np.int32)
    w = rng.random((B, K)).astype(np.float32) if weighted else None
    return table, idx, w


def _port(table, idx, w):
    return E.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                           None if w is None else torch.from_numpy(w)).numpy()


def _reference(table, idx, w):
    ones = np.ones(idx.shape, np.float32)
    args = (jnp.asarray(table), jnp.asarray(idx), jnp.asarray(ones if w is None else w))
    return np.asarray(ops.embedding_bag(*args)), np.asarray(embedding_bag_ref(*args))


@pytest.mark.parametrize("B,K,D", [(4, 1, 8), (16, 5, 16), (32, 13, 32), (8, 39, 1),
                                   (8, 39, 10)])
@pytest.mark.parametrize("weighted", [False, True])
def test_bag_matches_pallas_and_oracle(B, K, D, weighted):
    table, idx, w = _inputs(B, K, D, weighted=weighted, seed=B + K + D)
    got = _port(table, idx, w)
    pallas, oracle = _reference(table, idx, w)
    assert got.shape == (B, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, oracle, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_bf16_table_sums_in_f32(weighted):
    """A bf16 table is widened to f32 row by row, as the Pallas kernel's
    `astype(f32)`: both packages see the same bf16 values."""
    table, idx, w = _inputs(8, 7, 10, weighted=weighted, seed=3)
    t16 = torch.from_numpy(table).to(torch.bfloat16)
    got = E.embedding_bag(t16, torch.from_numpy(idx),
                          None if w is None else torch.from_numpy(w))
    assert got.dtype == torch.float32
    ones = np.ones(idx.shape, np.float32)
    ref = ops.embedding_bag(jnp.asarray(table).astype(jnp.bfloat16), jnp.asarray(idx),
                            jnp.asarray(ones if w is None else w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    # and it is the f32 sum of the bf16 values
    want = E.embedding_bag(t16.float(), torch.from_numpy(idx),
                           None if w is None else torch.from_numpy(w))
    assert torch.equal(got, want)


def test_duplicate_indices_in_a_bag_add_up():
    table, _, _ = _inputs(1, 1, 6, V=20, seed=4)
    idx = np.array([[3, 3, 3, 7], [5, 5, 5, 5]], np.int32)
    got = _port(table, idx, None)
    np.testing.assert_allclose(got[0], 3 * table[3] + table[7], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1], 4 * table[5], rtol=1e-6, atol=1e-6)
    pallas, _ = _reference(table, idx, None)
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)


def test_zero_weight_masks_its_slot():
    """A slot of weight 0 adds nothing: the bag equals the same bag with
    that slot pointing anywhere else, exactly."""
    table, idx, w = _inputs(12, 9, 10, seed=5)
    w[:, 2] = 0.0
    w[5, :] = 0.0
    got = _port(table, idx, w)
    moved = idx.copy()
    moved[:, 2] = (moved[:, 2] + 17) % table.shape[0]
    moved[5, :] = 0
    assert np.array_equal(got, _port(table, moved, w))
    assert np.array_equal(got[5], np.zeros(10, np.float32))
    pallas, oracle = _reference(table, idx, w)
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, oracle, rtol=TOL, atol=TOL)


def test_plain_version_follows_the_kernels_order():
    """The plain version is the sequential sum from zeros (the order the
    Pallas grid walks and the CUDA kernel keeps), not a pairwise sum."""
    table, idx, w = _inputs(16, 39, 10, seed=6)
    t, i, ww = (torch.from_numpy(x) for x in (table, idx, w))
    want = torch.zeros((16, 10))
    for k in range(39):
        want = want + ww[:, k, None] * t[i[:, k]]
    assert torch.equal(E.embedding_bag_plain(t, i, ww), want)
    assert torch.equal(E.embedding_bag(t, i, None), E.embedding_bag_plain(t, i, torch.ones(16, 39)))


def test_cpu_calls_count_no_launch_and_the_kernel_refuses_cpu():
    table, idx, w = (torch.from_numpy(x) for x in _inputs(4, 3, 5))
    before = E.embedding_bag.launches
    E.embedding_bag(table, idx, w)
    E.embedding_bag(table, idx)
    assert E.embedding_bag.launches == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        E._launch(table, idx, w)
    with pytest.raises(ValueError, match="mixed devices"):
        E.embedding_bag(table, idx.to("meta"))
    # not CPU, not CUDA: the wrapper raises, it does not fall back
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        E.embedding_bag(table.to("meta"), idx.to("meta"))
    assert E.embedding_bag.launches == before
