"""The port's seeded draws (`repro_torch.core.prng`) against `jax.random`,
bit for bit: `key`, `split`, `fold_in`, `bits`, `uniform`, `randint` and
`permutation` over seeds 0, 1, 2^31 - 1 and -1 and sizes 0, 1, an odd
few, 1,625 / 1,626 (where `permutation` goes from one sort round to two)
and 300,000 (whose 32-bit sort keys tie); then `make_priorities` for the
four heuristics from the key alone; then the Threefry wrapper's plain
path, its fake branch and its refusals.  The port implements JAX's
partitionable Threefry with 64-bit types off, so the flags are held too:
a JAX that changes either fails here instead of drifting."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import heuristics as ref_heur
from repro.graphs.generators import powerlaw as ref_powerlaw
from repro_torch.core import heuristics as heur
from repro_torch.core import prng
from repro_torch.hopper import threefry as TF
from repro_torch.hopper.launch import fake_mode
from repro_torch.perf.counting import CountingMode

SEEDS = [0, 1, (1 << 31) - 1, -1]
SIZES = [0, 1, 7, 1625, 1626, 300_000]


def _words(k) -> tuple:
    return tuple(int(w) for w in jax.random.key_data(k))


def _u32(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


def test_jax_draws_the_stream_the_port_implements():
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64
    assert jax.random.key_impl(jax.random.key(0)) == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS + [(1 << 32) + 5, -(1 << 31)])
def test_key_split_fold_in(seed):
    k, pk = jax.random.key(seed), prng.key(seed)
    assert _words(k) == tuple(pk)
    for num in (1, 2, 3):
        assert [_words(x) for x in jax.random.split(k, num)] == \
            [tuple(x) for x in prng.split(pk, num)]
    for data in (0, 3, (1 << 31) - 1, (1 << 32) - 1):
        assert _words(jax.random.fold_in(k, data)) == tuple(prng.fold_in(pk, data))
    sub = jax.random.split(k)[1]
    assert _words(jax.random.fold_in(sub, 7)) == tuple(prng.fold_in(prng.split(pk)[1], 7))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform(seed, n):
    k, pk = jax.random.key(seed), prng.key(seed)
    got = prng.bits(pk, n, "cpu")
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), _u32(jax.random.bits(k, (n,))))
    u = prng.uniform(pk, n, "cpu")
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(u.numpy().view(np.int32), _u32(jax.random.uniform(k, (n,))))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", SEEDS)
def test_randint(seed, n):
    k, pk = jax.random.key(seed), prng.key(seed)
    int32_max = (1 << 31) - 1
    # Luby's span, where (2^16 mod span)^2 wraps to 0; spans whose
    # multiplier does not; an empty range; the full int32 range (at the
    # largest size Luby's and one with both streams: each jax call costs)
    spans = ((0, int32_max), (-5, 17), (0, 1 << 20), (3, 3), (9, 2),
             (-(1 << 31), int32_max), (-(1 << 31), 0))
    for lo, hi in spans[:2] if n >= 300_000 else spans:
        want = jax.random.randint(k, (n,), lo, hi, dtype=jnp.int32)
        np.testing.assert_array_equal(prng.randint(pk, n, lo, hi, "cpu").numpy(),
                                      np.asarray(want), err_msg=f"[{lo}, {hi})")
    with pytest.raises(ValueError, match="int32"):
        prng.randint(pk, n, 0, 1 << 31, "cpu")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", SEEDS)
def test_permutation(seed, n):
    want = jax.random.permutation(jax.random.key(seed), jnp.arange(n, dtype=jnp.int32))
    got = prng.permutation(prng.key(seed), n, "cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_permutation_rounds_and_ties():
    assert [prng.permutation_rounds(n) for n in (0, 1, 2, 1625, 1626)] == [0, 0, 1, 1, 2]
    # 300,000 draws of 32-bit sort keys tie: the stable sort's order decides
    keys = prng.bits(prng.split(prng.key(0))[1], 300_000, "cpu")
    assert torch.unique(keys).numel() < 300_000


@pytest.mark.parametrize("n", [1, 7, 1626, 5000])
@pytest.mark.parametrize("heuristic", ["h1", "h2", "h3", "ecl"])
def test_make_priorities_from_the_key(heuristic, n):
    """Eq. 1's d̄ is an f32 mean: exact, so the same in both packages,
    while the degrees sum below 2^24 (ROADMAP.md Queue 3 has a case past
    that bound where the two means differ)."""
    g = ref_powerlaw(n, avg_deg=4.0, seed=n)
    deg = np.array(g.degrees())
    key = jax.random.fold_in(jax.random.key(3), n)
    want = ref_heur.make_priorities(heuristic, key, n, jnp.asarray(deg))
    got = heur.make_priorities(heuristic, prng.fold_in(prng.key(3), n), n,
                               torch.from_numpy(deg))
    np.testing.assert_array_equal(got.select.numpy(), np.asarray(want.select))
    assert (got.resolve is None) == (want.resolve is None)
    if want.resolve is not None:
        np.testing.assert_array_equal(got.resolve.numpy(), np.asarray(want.resolve))


def test_threefry_wrapper_plain_path_and_refusals():
    before = TF.threefry_bits.launches
    out = TF.threefry_bits(0x12345678, 0x9ABCDEF0, 1000, "cpu")
    assert TF.threefry_bits.launches == before     # the CPU runs the plain version
    want = TF.threefry_bits_plain(0x12345678, 0x9ABCDEF0, torch.empty(1000, dtype=torch.int32))
    assert torch.equal(out, want)
    # the host hash on ints is the plain version's elementwise hash
    b1, b2 = TF.threefry2x32(7, 8, 0, 999)
    assert int(TF.threefry_bits(7, 8, 1000, "cpu")[999]) == int(np.uint32(b1 ^ b2).view(np.int32))
    with pytest.raises(ValueError, match="mode"):
        TF.threefry_bits(0, 0, 4, "cpu", "normal")
    with pytest.raises(ValueError, match="2\\^32"):
        TF.threefry_bits(0, 0, 1 << 32, "cpu")
    with pytest.raises(ValueError, match="uint32"):
        TF.threefry_bits(-1, 0, 4, "cpu")


def test_threefry_fake_branch_reports_its_bound():
    """On fake tensors (the dry run's) the wrapper reports the launch's
    bytes (the output written once) and operations, and runs nothing."""
    counting = CountingMode()
    with fake_mode(), counting:
        out = TF.threefry_bits(1, 2, 4096, "cpu", "uniform")
    assert out.shape == (4096,) and out.dtype == torch.float32
    rec = counting.kernels["threefry"]
    assert (rec.launches, rec.bytes, rec.flops) == (1, 4.0 * 4096, 76 * 4096)
