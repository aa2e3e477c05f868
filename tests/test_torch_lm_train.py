"""The LM's training path, port against reference, on the CPU at the SMOKE
sizes: `chunked_xent`, `lm_loss` and every parameter's gradient against
`jax.value_and_grad(lm_loss)`, one `make_lm_train_step` against the
reference's (weights carried by `lm_params_from_numpy`, moments by
`adamw_state_from_numpy`), the remat modes against each other, each arch's
`smoke`, the TrainLoop and the launcher, and `flash_attention`'s two paths
(in place without autograd, out of place with it).

Tolerances, f32 on both sides: losses within 1e-5; a gradient, parameter
or moment leaf within 1e-5 of its largest entry (the two packages sum the
same products in other orders; 9e-7 seen); remat "full", "dots" and off
within 1e-6 (the same ops, recomputed).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import ARCHS, close, configs, port_weights, ref_weights, tokens
from repro.configs.common import make_lm_train_step as ref_make_lm_train_step
from repro.models import attention as RA
from repro.models import transformer as rtf
from repro.train import OptConfig as RefOptConfig
from repro.train import adamw_init as ref_adamw_init
from repro_torch.configs import LM_ARCHS
from repro_torch.configs import lm_cells as C
from repro_torch.core import prng
from repro_torch.data.pipeline import TokenStream
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as A
from repro_torch.models import transformer as tf
from repro_torch.train import LoopConfig, OptConfig, TrainLoop, adamw_init
from repro_torch.train import tree as T
from repro_torch.train.optimizer import adamw_state_from_numpy

LOSS_TOL = 1e-5
LEAF_TOL = 1e-5       # of the leaf's largest |entry|
REMAT_TOL = 1e-6


def _leaf_close(got, want, tol, what):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().to(torch.float32).numpy()
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: max |err| {err:.3e} > {tol} x {scale:.3e}"


def _trees_close(got_tree, want_tree, tol, what):
    got, want = T.leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(want_tree)]
    for path, g, w in zip(paths, got, want):
        assert tuple(g.shape) == tuple(np.shape(w)), path
        _leaf_close(g, w, tol, f"{what} {path}")


def _targets(tk, ignore=((0, 5),)):
    tg = np.roll(tk, -1, axis=1)
    for b, s in ignore:
        tg[b, s] = -1
    return tg


# --------------------------------------------------------------------------
# chunked_xent
# --------------------------------------------------------------------------

XENT_CASES = {
    # name: (B, S, D, V, chunk, ignored positions)
    "ragged": (2, 37, 16, 50, 8, ()),
    "ignored": (3, 32, 16, 40, 16, ((0, 0), (1, 7), (2, 31), (2, 30))),
    "chunk_past_S": (2, 12, 8, 30, 64, ((1, 3),)),
    "all_ignored_but_one": (1, 10, 8, 20, 4, tuple((0, s) for s in range(9))),
}


@pytest.mark.parametrize("case", sorted(XENT_CASES))
def test_chunked_xent_matches(case):
    B, S, D, V, chunk, ignored = XENT_CASES[case]
    rng = np.random.default_rng(sorted(XENT_CASES).index(case))
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    head = (rng.standard_normal((D, V)) * 0.3).astype(np.float32)
    tg = rng.integers(0, V, (B, S)).astype(np.int32)
    for b, s in ignored:
        tg[b, s] = -1
    want, (gh, ghead) = jax.value_and_grad(
        lambda a, w: rtf.chunked_xent(a, w, jnp.asarray(tg), chunk), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(head))
    th = torch.from_numpy(h).requires_grad_()
    thead = torch.from_numpy(head).requires_grad_()
    got = tf.chunked_xent(th, thead, torch.from_numpy(tg), chunk)
    got.backward()
    close(got, want, LOSS_TOL)
    _leaf_close(th.grad, gh, LEAF_TOL, "dh")
    _leaf_close(thead.grad, ghead, LEAF_TOL, "dhead")


def test_chunked_xent_holds_no_full_logits():
    """While autograd records, no tensor saved for backward holds a chunk's
    (B, chunk, V) logits: each chunk is checkpointed."""
    B, S, D, V, chunk = 2, 32, 8, 64, 8
    h = torch.randn(B, S, D, requires_grad=True)
    head = torch.randn(D, V, requires_grad=True)
    tg = torch.randint(0, V, (B, S))
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = tf.chunked_xent(h, head, tg, chunk)
    assert sizes and max(sizes) < B * chunk * V
    loss.backward()
    assert torch.isfinite(h.grad).all() and torch.isfinite(head.grad).all()


# --------------------------------------------------------------------------
# lm_loss and its gradients, all five SMOKE configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match(arch):
    ref, port = configs(arch)
    rp, np_tree = ref_weights(ref)
    tk = tokens(port.vocab, 2, 40)
    tg = _targets(tk)
    (rloss, rmetrics), rgrads = jax.jit(jax.value_and_grad(
        lambda p, a, b: rtf.lm_loss(p, ref, a, b), has_aux=True))(
        rp, jnp.asarray(tk), jnp.asarray(tg))
    loss, metrics, grads = C.lm_loss_and_grads(port_weights(np_tree, port), port,
                                              torch.from_numpy(tk), torch.from_numpy(tg))
    close(loss, rloss, LOSS_TOL)
    assert set(metrics) == set(rmetrics)
    for k in metrics:
        close(metrics[k], rmetrics[k], LOSS_TOL, k)
    if port.mtp:
        assert float(metrics["mtp"]) > 0
    _trees_close(grads, rgrads, LEAF_TOL, f"{arch} grad")


def test_train_step_matches_reference():
    """One reference step from its init, carried over (weights and the
    moments it left), then one more step on each side; mixtral's SMOKE
    config (MoE, the ring window), the AdamW half being the same for every
    arch and every arch's gradients held above."""
    ref, port = configs("mixtral-8x22b")
    rp, _ = ref_weights(ref)
    tk = tokens(port.vocab, 2, 32)
    tg = _targets(tk, ())
    step = jax.jit(ref_make_lm_train_step(ref, RefOptConfig(total_steps=100)))
    rp1, ropt1, _, _ = step(rp, ref_adamw_init(rp), jnp.asarray(tk), jnp.asarray(tg))
    tk2 = tokens(port.vocab, 2, 32, seed=2)
    tg2 = _targets(tk2, ())
    rp2, ropt2, rloss, rxent = step(rp1, ropt1, jnp.asarray(tk2), jnp.asarray(tg2))

    to_np = lambda tree: jax.tree.map(np.asarray, tree)   # noqa: E731
    params = port_weights(to_np(rp1), port)
    opt = adamw_state_from_numpy(to_np(ropt1), lambda t: port_weights(t, port), device="cpu")
    assert int(opt.step) == 1
    p2, opt2, loss, xent = C.make_lm_train_step(port, OptConfig(total_steps=100))(
        params, opt, torch.from_numpy(tk2), torch.from_numpy(tg2))
    close(loss, rloss, LOSS_TOL)
    close(xent, rxent, LOSS_TOL)
    assert int(opt2.step) == int(ropt2.step) == 2
    _trees_close(p2, rp2, LEAF_TOL, "params")
    _trees_close(opt2.m, ropt2.m, LEAF_TOL, "m")
    _trees_close(opt2.v, ropt2.v, LEAF_TOL, "v")


def test_donated_step_equals_the_out_of_place_step():
    """`donate` writes the same bits into the state it is given."""
    cfg = LM_ARCHS["mixtral-8x22b"].SMOKE
    params = tf.init_lm(prng.key(0), cfg, device="cpu")
    tk = torch.from_numpy(tokens(cfg.vocab, 2, 24))
    tg = torch.roll(tk, -1, dims=1)
    opt_cfg = OptConfig(total_steps=100, warmup_steps=2)
    want_p, want_o, want_loss, _ = C.make_lm_train_step(cfg, opt_cfg)(
        params, adamw_init(params), tk, tg)
    own = T.tree_map(torch.clone, params)
    own_opt = adamw_init(own)
    got_p, got_o, loss, _ = C.make_lm_train_step(cfg, opt_cfg, donate=True)(own, own_opt, tk, tg)
    assert float(loss) == float(want_loss)
    for g, w, mine in zip(T.leaves(got_p), T.leaves(want_p), T.leaves(own)):
        assert g is mine and torch.equal(g, w)
    for g, w in zip(T.leaves(got_o.m) + T.leaves(got_o.v), T.leaves(want_o.m) + T.leaves(want_o.v)):
        assert torch.equal(g, w)


# --------------------------------------------------------------------------
# remat
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v3-671b", "mixtral-8x22b"])
def test_remat_invariance(arch):
    """Remat "full", "dots" and off give the same loss and gradients (the
    port's counterpart of test_models_lm.py's unroll invariance)."""
    cfg = LM_ARCHS[arch].SMOKE
    params = tf.init_lm(prng.key(0), cfg, device="cpu")
    tk = torch.from_numpy(tokens(cfg.vocab, 2, 32))
    tg = torch.roll(tk, -1, dims=1)
    runs = {}
    for label, remat, policy in (("off", False, "full"), ("full", True, "full"),
                                 ("dots", True, "dots")):
        runs[label] = C.lm_loss_and_grads(
            params, dataclasses.replace(cfg, remat=remat, remat_policy=policy), tk, tg)
    want_loss, _, want = runs["off"]
    for label in ("full", "dots"):
        loss, _, grads = runs[label]
        assert abs(float(loss) - float(want_loss)) <= REMAT_TOL * abs(float(want_loss))
        for g, w in zip(T.leaves(grads), T.leaves(want)):
            scale = max(float(w.abs().max()), 1e-30)
            assert float((g - w).abs().max()) <= REMAT_TOL * scale, label


def test_remat_checkpoints_each_layer():
    """Under remat "full" the forward keeps no tensor of a layer's inside:
    what autograd saves is at most the width of a layer's carry."""
    cfg = dataclasses.replace(LM_ARCHS["qwen3-0.6b"].SMOKE, n_layers=3)
    params = tf.init_lm(prng.key(0), cfg, device="cpu")
    weights = {p.requires_grad_().untyped_storage().data_ptr() for p in T.leaves(params)}
    tk = torch.from_numpy(tokens(cfg.vocab, 2, 32))
    biggest = {}
    for remat in (False, True):
        sizes = []

        def pack(t):     # the weights (and views of them) aside
            if t.untyped_storage().data_ptr() not in weights:
                sizes.append(t.numel())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tf.forward(params, dataclasses.replace(cfg, remat=remat), tk)
        biggest[remat] = max(sizes)
    carry = 2 * 32 * cfg.d_model
    assert biggest[True] <= carry < biggest[False]


def test_dots_policy_saves_the_2d_matmuls_only():
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    assert tf._dots_policy(None, aten.mm.default) == CheckpointPolicy.MUST_SAVE
    assert tf._dots_policy(None, aten.addmm.default) == CheckpointPolicy.MUST_SAVE
    for op in (aten.bmm.default, aten.exp.default, aten.amax.default):
        assert tf._dots_policy(None, op) == CheckpointPolicy.PREFER_RECOMPUTE


def test_unknown_remat_policy_raises():
    cfg = dataclasses.replace(LM_ARCHS["qwen3-0.6b"].SMOKE, remat_policy="everything")
    params = tf.init_lm(prng.key(0), cfg, device="cpu")
    tk = torch.from_numpy(tokens(cfg.vocab, 1, 8))
    with pytest.raises(ValueError, match="remat_policy"):
        C.lm_loss_and_grads(params, cfg, tk, tk)


# --------------------------------------------------------------------------
# smoke, TrainLoop, launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_arch_smoke(arch):
    LM_ARCHS[arch].smoke(device="cpu")


def test_train_loop_end_to_end_lm(tmp_path):
    """tests/test_system.py's driver test on the port: a tiny LM trains
    through the TrainLoop and its loss falls below uniform."""
    cfg = LM_ARCHS["qwen1.5-0.5b"].SMOKE
    params = tf.init_lm(prng.key(0), cfg, device="cpu")
    raw = C.make_lm_train_step(cfg, OptConfig(lr=3e-3, warmup_steps=5, total_steps=100))

    def step_fn(state, batch):
        params, opt = state
        params, opt, loss, _ = raw(params, opt, *batch)
        return (params, opt), {"loss": loss}

    loop = TrainLoop(step_fn=step_fn, init_state=(params, adamw_init(params)),
                     stream=TokenStream(cfg.vocab, 8, 32, seed=3),
                     cfg=LoopConfig(ckpt_dir=str(tmp_path), checkpoint_every=20), device="cpu")
    res = loop.run(60)
    assert math.isfinite(res["metrics"]["loss"])
    assert res["metrics"]["loss"] < math.log(cfg.vocab) - 0.3


def test_launch_train_main_in_process(tmp_path, capsys):
    args = ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path / "ckpt"), "--checkpoint-every", "2",
            "--log", str(tmp_path / "log.jsonl")]
    res = launch_train.main(args)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("qwen1.5-0.5b [cpu-small]: ") and out[0].endswith("M params")
    assert out[1] == "starting at step 0" and out[2].startswith("done: ")
    assert res["final_step"] == 2 and math.isfinite(res["metrics"]["loss"])
    # a second run resumes from the last checkpoint
    res = launch_train.main(args[:3] + ["2"] + args[4:])
    assert capsys.readouterr().out.splitlines()[1] == "starting at step 3"
    assert res["final_step"] == 4
    assert len((tmp_path / "log.jsonl").read_text().splitlines()) == 5


def test_launch_train_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        launch_train.main(["--steps", "1"])


# --------------------------------------------------------------------------
# flash_attention: the serving path and the differentiable path
# --------------------------------------------------------------------------

ATTN_CASES = {
    # name: (B, S, H, Hkv, dq, dv, causal, window, chunk)
    "gqa_causal": (2, 32, 4, 2, 16, 16, True, None, 8),
    "window_ragged": (1, 37, 4, 1, 8, 8, True, 10, 16),
    "mla_dims": (2, 24, 2, 2, 12, 8, True, None, 16),
    "non_causal": (1, 20, 2, 2, 8, 8, False, None, 8),
}


def _attn_inputs(case):
    B, S, H, Hkv, dq, dv, *_ = ATTN_CASES[case]
    rng = np.random.default_rng(sorted(ATTN_CASES).index(case))
    return (rng.standard_normal((B, S, H, dq)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, dq)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, dv)).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_paths_are_bit_identical(case, dtype):
    """The in-place serving path (no autograd) and the out-of-place path
    (autograd recording) give the same bits."""
    *_, causal, window, chunk = ATTN_CASES[case]
    q, k, v = (torch.from_numpy(a).to(dtype) for a in _attn_inputs(case))
    with torch.no_grad():
        served = A.flash_attention(q, k, v, causal=causal, window=window, chunk=chunk)
    trained = A.flash_attention(q.requires_grad_(), k, v, causal=causal, window=window,
                                chunk=chunk)
    assert trained.requires_grad and not served.requires_grad
    assert torch.equal(served, trained.detach())


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_grad_matches(case):
    *_, causal, window, chunk = ATTN_CASES[case]
    q, k, v = _attn_inputs(case)
    w = np.random.default_rng(9).standard_normal(q.shape[:3] + (v.shape[-1],)).astype(np.float32)

    def ref(q_, k_, v_):
        o = RA.flash_attention(q_, k_, v_, causal=causal, window=window, chunk=chunk)
        return jnp.sum(o * jnp.asarray(w))

    want = jax.grad(ref, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = A.flash_attention(tq, tk, tv, causal=causal, window=window, chunk=chunk)
    (out * torch.from_numpy(w)).sum().backward()
    for name, got, g in zip("qkv", (tq, tk, tv), want):
        _leaf_close(got.grad, g, LEAF_TOL, f"d{name}")
