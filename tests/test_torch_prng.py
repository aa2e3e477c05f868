"""The port's seeded draws (`repro_torch.core.prng`) against `jax.random`,
bit for bit: `key`, `split`, `fold_in`, `bits`, `uniform`, `randint` and
`permutation` over seeds 0, 1, 2^31 - 1 and -1 and sizes 0, 1, an odd
few, 1,625 / 1,626 (where `permutation` goes from one sort round to two)
and 300,000 (whose 32-bit sort keys tie); `uniform` over ranges, shaped
draws and draws from a start counter (a block of a draw, and starts past
2^32 against JAX's own draw with its counters shifted there,
`_counters_from`); `normal` and `gumbel` within 4 ulp (XLA's log1p and
log are not torch's); `categorical`'s tokens, ties included; then
`make_priorities` for the four heuristics from the key alone; then the
Threefry wrapper's plain path, its fake branch and its refusals.  The
port implements JAX's partitionable Threefry with 64-bit types off and
JAX's "low" Gumbel, so the flags are held too: a JAX that changes one
fails here instead of drifting."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax._src import prng as jax_prng

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


def test_jax_draws_the_gumbel_the_port_implements():
    """`gumbel` / `categorical` take JAX's default mode, "low": one uniform
    on [tiny, 1) an element."""
    assert not jax.config.jax_high_dynamic_range_gumbel


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
        TF.threefry_bits(0, 0, 4, "cpu", "gamma")
    with pytest.raises(ValueError, match="2\\^64"):
        TF.threefry_bits(0, 0, 4, "cpu", start=(1 << 64) - 3)
    with pytest.raises(ValueError, match="2\\^64"):
        TF.threefry_bits(0, 0, 4, "cpu", start=-1)
    with pytest.raises(ValueError, match="uint32"):
        TF.threefry_bits(-1, 0, 4, "cpu")
    with pytest.raises(ValueError, match="out must be"):
        TF.threefry_bits(0, 0, 4, "cpu", "normal", out=torch.empty(4, dtype=torch.int32))
    into = torch.zeros(6)
    TF.threefry_bits(3, 4, 4, "cpu", "uniform", start=9, out=into[1:5])
    assert torch.equal(into[1:5], TF.threefry_bits(3, 4, 4, "cpu", "uniform", start=9))
    assert into[0] == into[5] == 0


def test_threefry_fake_branch_reports_its_bound():
    """On fake tensors (the dry run's) the wrapper reports the launch's
    bytes (the output written once) and operations, and runs nothing; on
    the meta device it returns the shape and reports nothing."""
    counting = CountingMode()
    with fake_mode(), counting:
        out = TF.threefry_bits(1, 2, 4096, "cpu", "uniform")
        normal = TF.threefry_bits(1, 2, 100, "cpu", "normal", start=1 << 40)
    assert out.shape == (4096,) and out.dtype == torch.float32
    assert normal.shape == (100,) and normal.dtype == torch.float32
    rec = counting.kernels["threefry"]
    assert (rec.launches, rec.bytes, rec.flops) == (2, 4.0 * 4196, 80 * 4096 + 104 * 100)
    counting = CountingMode()
    before = TF.threefry_bits.launches
    with counting:
        meta = prng.normal(prng.key(0), (30, 7), "meta")
    assert meta.shape == (30, 7) and meta.device.type == "meta"
    assert not counting.kernels and TF.threefry_bits.launches == before


# --------------------------------------------------------------------------
# the draws outside the MIS paths: ranges, shapes, starts, normal, gumbel,
# categorical
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _counters_from(start: int, draw_shape):
    """JAX's draws of `draw_shape` with their flat counters shifted to
    begin at `start`: element j then hashes start + j, as element start + j
    of a draw of more than start elements does (JAX cannot hold one past
    2^32).  Key splits (other shapes) keep their counters.  Traces are
    cleared before and after."""
    orig = jax_prng.iota_2x32_shape
    s_hi, s_lo = np.uint32(start >> 32), np.uint32(start & 0xFFFFFFFF)

    def shifted(shape):
        hi, lo = orig(shape)
        if tuple(shape) != tuple(draw_shape):
            return hi, lo
        lo2 = lo + s_lo
        return hi + s_hi + (lo2 < lo).astype(jnp.uint32), lo2

    jax.clear_caches()
    jax_prng.iota_2x32_shape = shifted
    try:
        yield
    finally:
        jax_prng.iota_2x32_shape = orig
        jax.clear_caches()


def _ulps(got, want) -> np.ndarray:
    """f32 ulps between two arrays (the distance of their ordered bits)."""
    def ordered(x):
        b = np.asarray(x, dtype=np.float32).view(np.int32).astype(np.int64)
        return np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(ordered(got) - ordered(want))


RANGES = [(0.0, 1.0), (-3.5, 2.25), (1e-3, 1.0), (-1.0, 1.0), (float(np.finfo(np.float32).tiny),
                                                               1.0), (-7.0, -6.9)]


@pytest.mark.parametrize("lo, hi", RANGES)
@pytest.mark.parametrize("seed", [0, (1 << 31) - 1])
def test_uniform_ranges(seed, lo, hi):
    """`uniform(minval, maxval)` bit for bit: XLA takes f * (maxval -
    minval) + minval as one FMA, so ranges whose product rounds tell."""
    n = 100_000
    want = jax.random.uniform(jax.random.key(seed), (n,), minval=lo, maxval=hi)
    got = prng.uniform(prng.key(seed), n, "cpu", lo, hi)
    np.testing.assert_array_equal(got.numpy().view(np.int32), _u32(want))


@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 3, 4), (9, 7, 5)])
def test_shaped_draws_and_blocks_from_a_start(shape):
    """A shape's draw is the flat draw reshaped row-major, and rows r0 on
    of it are the draw of their shape from start r0 * (row size): bits,
    uniforms, integers (Luby's span and a two-stream span), bit for bit;
    normals within 4 ulp."""
    k, pk = jax.random.key(11), prng.key(11)
    row = int(np.prod(shape[1:], dtype=np.int64))
    r0 = shape[0] // 2
    block = (shape[0] - r0,) + shape[1:]
    draws = [
        (lambda: jax.random.bits(k, shape), lambda sh, s: prng.bits(pk, sh, "cpu", start=s)),
        (lambda: jax.random.uniform(k, shape, minval=-2.0, maxval=3.0),
         lambda sh, s: prng.uniform(pk, sh, "cpu", -2.0, 3.0, start=s)),
        (lambda: jax.random.randint(k, shape, 0, (1 << 31) - 1, dtype=jnp.int32),
         lambda sh, s: prng.randint(pk, sh, 0, (1 << 31) - 1, "cpu", start=s)),
        (lambda: jax.random.randint(k, shape, -5, 17, dtype=jnp.int32),
         lambda sh, s: prng.randint(pk, sh, -5, 17, "cpu", start=s)),
    ]
    for ref, port in draws:
        want = np.asarray(ref()).view(np.int32)
        whole = port(shape, 0)
        assert tuple(whole.shape) == shape
        np.testing.assert_array_equal(whole.numpy().view(np.int32), want)
        np.testing.assert_array_equal(port(block, r0 * row).numpy().view(np.int32), want[r0:])
    want = np.asarray(jax.random.normal(k, shape))
    assert _ulps(prng.normal(pk, shape, "cpu").numpy(), want).max() <= 4
    assert _ulps(prng.normal(pk, block, "cpu", start=r0 * row).numpy(), want[r0:]).max() <= 4


@pytest.mark.parametrize("start", [0, 1234, (1 << 32) - 5, 3 << 32, (1 << 64) - 1000])
def test_draws_from_a_start_past_the_high_word(start):
    """From a start counter (crossing 2^32, past it, at the top of the
    2^64 range) every draw is JAX's at those counters: bits, uniforms
    and integers bit for bit, normals and Gumbels within 4 ulp."""
    n, seed = 1000, 3
    k, pk = jax.random.key(seed), prng.key(seed)
    with _counters_from(start, (n,)):
        want = dict(bits=_u32(jax.random.bits(k, (n,))),
                    uniform=_u32(jax.random.uniform(k, (n,), minval=-1.5, maxval=0.5)),
                    randint=np.asarray(jax.random.randint(k, (n,), 2, 99, dtype=jnp.int32)),
                    normal=np.asarray(jax.random.normal(k, (n,))),
                    gumbel=np.asarray(jax.random.gumbel(k, (n,))))
    np.testing.assert_array_equal(prng.bits(pk, n, "cpu", start=start).numpy(), want["bits"])
    np.testing.assert_array_equal(
        prng.uniform(pk, n, "cpu", -1.5, 0.5, start=start).numpy().view(np.int32),
        want["uniform"])
    np.testing.assert_array_equal(prng.randint(pk, n, 2, 99, "cpu", start=start).numpy(),
                                  want["randint"])
    assert _ulps(prng.normal(pk, n, "cpu", start=start).numpy(), want["normal"]).max() <= 4
    g = prng.gumbel(pk, n, "cpu", start=start).numpy()
    assert (np.abs(g - want["gumbel"])
            <= 4 * np.spacing(np.maximum(np.abs(want["gumbel"]), 1.0))).all()


@pytest.mark.parametrize("seed", [0, 7, -1])
def test_normal_and_gumbel_within_ulps(seed):
    """`normal`: sqrt(2) erf_inv of the uniform on (-1, 1), XLA's Giles
    polynomial, within 4 ulp of `jax.random.normal`.  `gumbel`: -log(-log
    u), within 4 ulp of max(|x|, 1) (near 0 the outer log's argument is
    near 1, where one ulp of the inner log is many of the result)."""
    n = 100_000
    k, pk = jax.random.key(seed), prng.key(seed)
    z = prng.normal(pk, n, "cpu")
    assert z.dtype == torch.float32 and z.shape == (n,)
    d = _ulps(z.numpy(), jax.random.normal(k, (n,)))
    assert d.max() <= 4 and (d == 0).mean() > 0.9
    g = prng.gumbel(pk, n, "cpu").numpy()
    want = np.asarray(jax.random.gumbel(k, (n,)))
    assert (np.abs(g - want) <= 4 * np.spacing(np.maximum(np.abs(want), 1.0))).all()


@pytest.mark.parametrize("case", ["normal", "quantised", "ties"])
def test_categorical_tokens(case):
    """`categorical(key(100 + i), logits / T)` as the serve launcher
    samples: the reference's tokens for eight keys, on continuous logits,
    on logits quantised to a few levels, and where whole rows tie (argmax
    takes the first index, as jnp.argmax)."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 2048)).astype(np.float32)
    if case == "quantised":
        logits = np.round(logits * 2) / 2
    elif case == "ties":
        logits = np.zeros((4, 2048), np.float32)
        logits[:, 3::7] = 5.0
    for i in range(8):
        want = jax.random.categorical(jax.random.key(100 + i), jnp.asarray(logits) / 0.7)
        got = prng.categorical(prng.key(100 + i), torch.from_numpy(logits) / 0.7)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"key {100 + i}")
    with pytest.raises(TypeError, match="f32"):
        prng.categorical(prng.key(0), torch.zeros((2, 3), dtype=torch.float64))


def test_argmax_takes_the_first_of_tied_maxima():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 5.0, 5.0]])
    assert torch.argmax(x, dim=-1).tolist() == [1, 0]
    assert np.asarray(jnp.argmax(jnp.asarray(x.numpy()), axis=-1)).tolist() == [1, 0]


@pytest.mark.parametrize("dtype, bits", [(torch.bfloat16, torch.int16),
                                          (torch.float32, torch.int32)])
def test_normal_into_draws_a_leaf_block_by_block(monkeypatch, dtype, bits):
    """`normal_into` fills a leaf from blocks of FILL_BLOCK elements, each
    from its start: with the block cut to 1,000 elements, the same bits as
    one draw of the whole leaf (scaled in f32, then cast to bf16; an f32
    leaf's blocks drawn and scaled in place)."""
    out = torch.empty((37, 91), dtype=dtype)
    monkeypatch.setattr(prng, "FILL_BLOCK", 1000)
    prng.normal_into(prng.key(4), out, 0.02)
    want = (prng.normal(prng.key(4), (37, 91), "cpu") * 0.02).to(dtype)
    assert torch.equal(out.view(bits), want.view(bits))


@pytest.mark.parametrize("mode, lo, hi", [("bits", 0.0, 1.0), ("uniform", 0.0, 1.0),
                                          ("uniform", -3.5, 2.25), ("normal", 0.0, 1.0)])
def test_plain_version_is_one_draw_in_any_chunks(monkeypatch, mode, lo, hi):
    """The plain version hashes `_CHUNK` counters at a time: cut to 1,000
    (the card's size stands in for the CPU's), a draw from a start that
    crosses 2^32 inside a chunk gives the bits of the draw taken in one
    chunk, and the intra-op thread count it cut to one is restored."""
    n, start = 2777, (1 << 32) - 100
    dtype = torch.int32 if mode == "bits" else torch.float32
    threads = torch.get_num_threads()
    whole = TF.threefry_bits_plain(7, 9, torch.empty(n, dtype=dtype), mode, start=start,
                                   minval=lo, maxval=hi)
    monkeypatch.setattr(TF, "_CHUNK", (1 << 22, 1000))
    chunked = TF.threefry_bits_plain(7, 9, torch.empty(n, dtype=dtype), mode, start=start,
                                     minval=lo, maxval=hi)
    assert torch.equal(chunked.view(torch.int32), whole.view(torch.int32))
    assert torch.get_num_threads() == threads
