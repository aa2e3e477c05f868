"""LM serving, port against reference, on the CPU: `prefill` and
`decode_step` (logits and the cache's contents), greedy generation, the
sliding-window ring, and the keystone (teacher-forced decode reproduces the
forward's logits) on the port, for all five `SMOKE` configs fed the
reference's weights through `lm_params_from_numpy`.

Tolerances: logits within 1e-4 in f32, the cache's f32 entries within
1e-5; qwen3's `SMOKE` in bf16: logits within 5e-3 (measured 2.7e-3 at
|logit| <= 0.5), the bf16 cache within 2e-2 (one bf16 spacing at |x| in
[2, 4) is 1.56e-2, and entries one rounding apart occur).  The keystone on
the port alone holds at the reference's own 2e-3.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (
    ARCHS, RefServe, as_bf16, close, configs, head, port_weights, ref_weights, t,
    tokens, wide_capacity,
)
from repro.models.lm_config import LMConfig as RefLMConfig
from repro_torch.configs import lm_cells as C
from repro_torch.core import prng
from repro_torch.launch import serve
from repro_torch.models import transformer as tf
from repro_torch.models.lm_config import LMConfig

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
BF16_LOGIT_TOL = 5e-3
BF16_CACHE_TOL = 2e-2
KEYSTONE_TOL = 2e-3


def _serve_both(ref, port, tk, n_steps, max_len):
    """Prefill tk[:, :-n_steps], then teacher-force the last n_steps tokens
    through both packages; holds logits at every step and the cache after
    the prefill and after the last step."""
    tol, ctol = (BF16_LOGIT_TOL, BF16_CACHE_TOL) if port.dtype == torch.bfloat16 else (LOGIT_TOL, CACHE_TOL)
    rparams, np_params = ref_weights(ref)
    params = port_weights(np_params, port)
    rs = RefServe(ref)
    P = tk.shape[1] - n_steps
    logits, cache = C.prefill_step(params, port, t(tk[:, :P]), max_len=max_len)
    rlogits, rcache = rs.prefill(rparams, jnp.asarray(tk[:, :P]), max_len)
    close(logits, rlogits, tol, "prefill logits")
    assert cache.length == rcache.length and int(cache.pos) == int(rcache.pos) == P
    for k in rcache.data:
        assert cache.data[k].dtype == port.dtype
        close(cache.data[k], rcache.data[k], ctol, f"prefill cache {k}")
    for i in range(P, tk.shape[1]):
        logits, cache = C.serve_step(params, port, cache, t(tk[:, i]))
        rlogits, rcache = rs.decode(rparams, rcache, jnp.asarray(tk[:, i]))
        assert logits.dtype == torch.float32 and logits.shape == (tk.shape[0], port.vocab)
        close(logits, rlogits, tol, f"decode logits at {i}")
    assert int(cache.pos) == int(rcache.pos) == tk.shape[1]
    for k in rcache.data:
        close(cache.data[k], rcache.data[k], ctol, f"cache {k} after decode")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match(arch):
    ref, port = configs(arch)
    _serve_both(ref, port, tokens(port.vocab, 2, 24), 4, 25)


def test_prefill_and_decode_match_in_bf16():
    ref, port = as_bf16(*configs("qwen3-0.6b"))
    _serve_both(ref, port, tokens(port.vocab, 2, 24), 4, 25)


def test_prefill_and_decode_match_past_the_window():
    """mixtral's SMOKE window is 16: a prefill of 30 fills the ring past
    its end, and the decode steps overwrite the oldest slots."""
    ref, port = configs("mixtral-8x22b")
    _serve_both(ref, port, tokens(port.vocab, 2, 34, seed=4), 4, 40)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generation_matches(arch):
    ref, port = configs(arch)
    rparams, np_params = ref_weights(ref)
    params = port_weights(np_params, port)
    prompts = tokens(port.vocab, 2, 8, seed=2)
    n_new = 6
    got, cache, _, _ = serve.generate(params, port, t(prompts), n_new)
    rs = RefServe(ref)
    logits, rcache = rs.prefill(rparams, jnp.asarray(prompts), 8 + n_new)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    want = []
    for _ in range(n_new):
        want.append(tok)
        logits, rcache = rs.decode(rparams, rcache, tok)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.stack(want, axis=1))
    assert cache.length == rcache.length and int(cache.pos) == 8 + n_new


def _ring_cfgs():
    kw = dict(name="swa-test", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
              d_head=16, d_ff=128, vocab=64, window=8, attn_chunk=8, loss_chunk=8)
    return RefLMConfig(dtype=jnp.float32, **kw), LMConfig(dtype=torch.float32, **kw)


def test_swa_ring_buffer_consistency():
    """The reference's ring test on the port (decode from one prefilled
    token, the ring of 8 rolling many times, against the port's windowed
    forward), and each step's logits against the reference's decode."""
    ref, port = _ring_cfgs()
    rparams, np_params = ref_weights(ref)
    params = port_weights(np_params, port)
    B, S = 1, 32
    tk = tokens(port.vocab, B, S)
    h, _, _ = tf.forward(params, port, t(tk))
    full_logits = h @ params["head"]
    rs = RefServe(ref)
    logits, cache = tf.prefill(params, port, t(tk[:, :1]), max_len=S)
    rlogits, rcache = rs.prefill(rparams, jnp.asarray(tk[:, :1]), S)
    assert cache.length == port.window
    for i in range(1, S):
        logits, cache = tf.decode_step(params, port, cache, t(tk[:, i]))
        rlogits, rcache = rs.decode(rparams, rcache, jnp.asarray(tk[:, i]))
        close(logits, full_logits[:, i], KEYSTONE_TOL, f"ring decode diverges at {i}")
        close(logits, rlogits, LOGIT_TOL, f"against the reference at {i}")
    close(cache.data["k"], rcache.data["k"], CACHE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The reference's keystone on the port: teacher-forced decode from a
    prefill of S - 4 tokens reproduces the forward's logits."""
    _, port = wide_capacity(*configs(arch))
    params = tf.init_lm(prng.key(0), port, device="cpu")
    B, S, k = 2, 24, 4
    tk = t(tokens(port.vocab, B, S))
    h, _, _ = tf.forward(params, port, tk)
    full_logits = (h @ head(params)).float()
    logits, cache = tf.prefill(params, port, tk[:, : S - k], max_len=S + 1)
    close(logits, full_logits[:, S - k - 1], KEYSTONE_TOL)
    for i in range(S - k, S):
        logits, cache = tf.decode_step(params, port, cache, tk[:, i])
        if port.window is None or cache.length >= i + 1:
            close(logits, full_logits[:, i], KEYSTONE_TOL, f"{arch}: diverges at {i}")


def test_decode_consumes_the_cache_in_place():
    _, port = configs("qwen3-0.6b")
    params = tf.init_lm(prng.key(0), port, device="cpu")
    _, cache = tf.prefill(params, port, t(tokens(port.vocab, 2, 5)), max_len=8)
    k_before = cache.data["k"].clone()
    _, nxt = tf.decode_step(params, port, cache, torch.tensor([1, 2]))
    assert nxt.data["k"] is cache.data["k"] and int(nxt.pos) == 6 and int(cache.pos) == 5
    changed = (nxt.data["k"] != k_before).flatten(3).any(-1)     # (L, B, C)
    assert changed[:, :, 5].all() and not changed[:, :, :5].any() and not changed[:, :, 6:].any()
    assert cache.nbytes() == 2 * port.n_layers * 2 * 8 * port.n_kv_heads * port.d_head * 4


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                "--gen", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"arch={arch} batch=2"
    assert out[1].startswith("prefill 8 tok: ")
    ring = 12           # 8 + 4; mixtral: min(its window 128, 8 + 4)
    assert out[2].startswith("decode  4 steps: ") and out[2].endswith(f"ring={ring})")
    ids = [int(x) for x in out[3].split(":", 1)[1].strip(" []").split(",")]
    assert len(ids) == 4 and all(0 <= i < 2048 for i in ids)
    # greedy: the same run gives the same tokens
    serve.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                "--gen", "4"])
    assert capsys.readouterr().out.splitlines()[3] == out[3]


def test_serve_launcher_samples_with_a_temperature(capsys):
    args = ["--device", "cpu", "--batch", "3", "--prompt-len", "4", "--gen", "5"]
    serve.main(args + ["--temperature", "2.0"])
    hot = capsys.readouterr().out.splitlines()[3]
    serve.main(args + ["--temperature", "2.0"])
    assert capsys.readouterr().out.splitlines()[3] == hot       # seeded
    serve.main(args)
    assert capsys.readouterr().out.splitlines()[3] != hot
