"""The LM's attention substrate and RMSNorm, port against reference, on the
CPU: `apply_rope`, `flash_attention` (GQA, windows, ragged S, MLA's
dq != dv, non-causal), `decode_attention`, `mla_decode_attention` and
`rms_norm`, fed the same numpy inputs.

Tolerances: f32 within 1e-5 (both packages compute in f32; only the order
of the matmuls' sums and the libm differ); bf16 inputs within 2e-2 (the
outputs are rounded to bf16, whose spacing near 1 is 7.8e-3, so one
rounding apart is within it).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as RA
from repro.models.transformer import rms_norm as ref_rms_norm
from repro_torch.models import attention as A
from repro_torch.models.transformer import rms_norm

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, dtype=np.float32), rtol=tol, atol=tol)


def test_rope_freqs_match():
    for d, theta in ((16, 10_000.0), (128, 1_000_000.0), (64, 10_000.0)):
        _close(A.rope_freqs(d, theta), RA.rope_freqs(d, theta), F32_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_rope_matches(dtype):
    rng = np.random.default_rng(0)
    x = _randn(rng, 2, 24, 4, 32)
    # positions far into a long cache as well as the first few
    pos = np.stack([np.arange(24), 32_000 + np.arange(24)]).astype(np.int32)
    tdt, jdt, tol = ((torch.float32, jnp.float32, F32_TOL) if dtype == "f32"
                     else (torch.bfloat16, jnp.bfloat16, BF16_TOL))
    for theta in (10_000.0, 1_000_000.0):
        got = A.apply_rope(_t(x, tdt), _t(pos, torch.int32), theta)
        want = RA.apply_rope(_j(x, jdt), jnp.asarray(pos), theta)
        assert got.dtype == tdt and got.shape == x.shape
        _close(got, want, tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_matches(dtype):
    rng = np.random.default_rng(1)
    x = _randn(rng, 3, 5, 64) * 3
    w = 1 + 0.1 * _randn(rng, 64)
    tdt, jdt, tol = ((torch.float32, jnp.float32, F32_TOL) if dtype == "f32"
                     else (torch.bfloat16, jnp.bfloat16, BF16_TOL))
    got = rms_norm(_t(x, tdt), _t(w, tdt))
    assert got.dtype == tdt
    _close(got, ref_rms_norm(_j(x, jdt), _j(w, jdt)), tol)


FLASH_CASES = {
    # name: (B, S, H, Hkv, dq, dv, chunk, window, causal, scale)
    "gqa": (2, 64, 8, 4, 32, 32, 16, None, True, None),
    "gqa_window": (2, 64, 8, 4, 32, 32, 16, 16, True, None),
    "window_not_chunk_aligned": (1, 70, 4, 2, 16, 16, 16, 11, True, None),
    "ragged": (1, 37, 2, 2, 16, 16, 16, None, True, None),
    "ragged_window": (2, 37, 4, 1, 16, 16, 16, 8, True, None),
    "mla_dq_ne_dv": (2, 40, 4, 4, 24, 16, 16, None, True, 24 ** -0.5 * 0.9),
    "mqa_one_chunk": (2, 12, 6, 1, 8, 8, 512, None, True, None),
    "not_causal": (1, 48, 4, 2, 16, 16, 16, None, False, None),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_matches(case):
    B, S, H, Hkv, dq, dv, chunk, window, causal, scale = FLASH_CASES[case]
    rng = np.random.default_rng(sorted(FLASH_CASES).index(case))
    q, k, v = _randn(rng, B, S, H, dq), _randn(rng, B, S, Hkv, dq), _randn(rng, B, S, Hkv, dv)
    got = A.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                            chunk=chunk, scale=scale)
    want = RA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window, chunk=chunk, scale=scale)
    assert got.shape == (B, S, H, dv) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    _close(got, want, F32_TOL)


def test_flash_attention_bf16_matches():
    rng = np.random.default_rng(7)
    q, k, v = (_randn(rng, 2, 48, 4, 32), _randn(rng, 2, 48, 2, 32), _randn(rng, 2, 48, 2, 32))
    got = A.flash_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                            _t(v, torch.bfloat16), window=20, chunk=16)
    want = RA.flash_attention(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                              _j(v, jnp.bfloat16), window=20, chunk=16)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)


def test_flash_attention_fully_masked_leading_chunks_stay_finite():
    """A window of 4 under chunks of 8: the last query's first chunks hold
    no live key, so its running max is the -1e30 fill until a live chunk
    wipes the sum.  The result equals a plain softmax over the window."""
    rng = np.random.default_rng(3)
    S, W = 40, 4
    q, k, v = _randn(rng, 1, S, 2, 8), _randn(rng, 1, S, 2, 8), _randn(rng, 1, S, 2, 8)
    got = A.flash_attention(_t(q), _t(k), _t(v), window=W, chunk=8).numpy()
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * 8 ** -0.5
    qp, kp = np.arange(S)[:, None], np.arange(S)[None, :]
    s = np.where((qp >= kp) & (qp - kp < W), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("Hkv", [1, 2, 4])
def test_decode_attention_matches(Hkv):
    rng = np.random.default_rng(10 + Hkv)
    B, C, H, d = 3, 40, 4, 16
    q, kc, vc = _randn(rng, B, H, d), _randn(rng, B, C, Hkv, d), _randn(rng, B, C, Hkv, d)
    valid = np.arange(C)[None, :] <= np.array([0, 17, C - 1])[:, None]
    got = A.decode_attention(_t(q), _t(kc), _t(vc), torch.from_numpy(valid))
    want = RA.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                               jnp.asarray(valid))
    assert got.shape == (B, H, d)
    _close(got, want, F32_TOL)
    got = A.decode_attention(_t(q, torch.bfloat16), _t(kc, torch.bfloat16),
                             _t(vc, torch.bfloat16), torch.from_numpy(valid), scale=0.3)
    want = RA.decode_attention(_j(q, jnp.bfloat16), _j(kc, jnp.bfloat16),
                               _j(vc, jnp.bfloat16), jnp.asarray(valid), scale=0.3)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)


def test_mla_decode_attention_matches():
    rng = np.random.default_rng(20)
    B, C, H, dn, dr, r, dv = 2, 30, 4, 16, 8, 12, 10
    q_nope, q_rope = _randn(rng, B, H, dn), _randn(rng, B, H, dr)
    ckv, krope = _randn(rng, B, C, r), _randn(rng, B, C, dr)
    w_uk, w_uv = _randn(rng, H, dn, r) * 0.3, _randn(rng, H, r, dv) * 0.3
    valid = np.arange(C)[None, :] <= np.array([5, C - 1])[:, None]
    scale = (dn + dr) ** -0.5
    got = A.mla_decode_attention(_t(q_nope), _t(q_rope), _t(ckv), _t(krope),
                                 torch.from_numpy(valid), _t(w_uk), _t(w_uv), scale=scale)
    want = RA.mla_decode_attention(*(jnp.asarray(a) for a in (
        q_nope, q_rope, ckv, krope, valid, w_uk, w_uv)), scale=scale)
    assert got.shape == (B, H, dv)
    _close(got, want, F32_TOL)
