"""The port's training substrate (`repro_torch.train`, and the streams of
`repro_torch.data.pipeline`) on the cases of tests/test_train_substrate.py,
and against the JAX reference where both compute the same thing: schedule
values, AdamW updates on a small tree (out of place and in place),
compression on tie-free inputs and on quantised ones whose |g| ties
across the k-th place (the kept positions in `jax.lax.top_k`'s order),
token batches, the order of a tree's leaves.  `zero1_specs` is held to the
reference's in tests/test_torch_dist.py, the placed AdamW across ranks in
tests/test_torch_dist_train.py.  Everything runs on the CPU.

Tolerances: the schedule within 5e-7 relative (a few ulps of f32: `cos`
and the products around it round differently in XLA and torch; 2.3e-7
seen); AdamW within 1e-6 (elementwise f32 on equal inputs); compression
exact (the same top-k set on continuous values, the same values scattered
back).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose

import torch

from repro.data import pipeline as ref_pipeline
from repro.train import compression as ref_compression
from repro.train import optimizer as RO
from repro_torch.data.pipeline import TokenStream, prefetch
from repro_torch.train import (
    AdamWState,
    LoopConfig,
    OptConfig,
    TrainLoop,
    adamw_init,
    adamw_update,
    checkpoint as ckpt,
    compress_with_error_feedback,
    ef_init,
    global_norm,
    schedule,
)
from repro_torch.train import compression as comp
from repro_torch.train import tree as T

# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def _quad_grads(params):
    w = params["w"].detach().requires_grad_()
    (g,) = torch.autograd.grad(torch.sum(w ** 2), w)
    return {"w": g}


def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    opt = adamw_init(params)
    cfg = OptConfig(lr=0.1, warmup_steps=0, total_steps=200, weight_decay=0.0)
    for _ in range(150):
        params, opt, m = adamw_update(cfg, _quad_grads(params), opt, params)
    assert float(params["w"].abs().max()) < 0.05


def test_grad_clipping():
    params = {"w": torch.ones(4)}
    opt = adamw_init(params)
    cfg = OptConfig(lr=1e-3, clip_norm=1.0, warmup_steps=0, total_steps=10)
    grads = {"w": torch.full((4,), 1e6)}
    _, _, metrics = adamw_update(cfg, grads, opt, params)
    assert float(metrics["grad_norm"]) > 1e5  # reported pre-clip


def test_schedule_shape():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    s = [float(schedule(cfg, torch.tensor(i, dtype=torch.int32))) for i in [0, 5, 10, 50, 100]]
    assert s[0] == 0.0 and s[1] == 0.5 and s[2] == pytest.approx(1.0)
    assert s[3] < 1.0 and s[4] == pytest.approx(0.1, rel=1e-3)


@pytest.mark.parametrize("kw", [dict(lr=1.0, warmup_steps=10, total_steps=100),
                                dict(lr=3e-3, warmup_steps=5, total_steps=100),
                                dict(total_steps=10000), dict(warmup_steps=0, total_steps=50)])
def test_schedule_equals_reference(kw):
    cfg, ref = OptConfig(**kw), RO.OptConfig(**kw)
    steps = np.arange(121, dtype=np.int32)
    got = schedule(cfg, torch.from_numpy(steps)).numpy()
    want = np.asarray(RO.schedule(ref, jnp.asarray(steps)))
    assert got.dtype == want.dtype == np.float32
    assert_allclose(got, want, rtol=5e-7, atol=0)


def test_opt_config_defaults_equal_the_reference():
    import dataclasses

    assert dataclasses.asdict(OptConfig()) == dataclasses.asdict(RO.OptConfig())


def _tree_pair(seed):
    """A tree with matrices (decayed) and vectors (not), numpy."""
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32),
                  "d": rng.standard_normal((2, 2, 2)).astype(np.float32)},
            "e": np.float32(rng.standard_normal())}


@pytest.mark.parametrize("clip", [None, 1.0, 1e-3])
def test_adamw_update_equals_reference(clip):
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20, clip_norm=clip)
    cfg, ref_cfg = OptConfig(**kw), RO.OptConfig(**kw)
    params = _tree_pair(0)
    ref_p, ref_s = params, RO.adamw_init(jax.tree.map(jnp.asarray, params))
    p = T.tree_map(torch.from_numpy, T.tree_map(np.asarray, params))
    s = adamw_init(p)
    for step in range(5):
        g = _tree_pair(100 + step)
        ref_p, ref_s, ref_m = RO.adamw_update(ref_cfg, jax.tree.map(jnp.asarray, g), ref_s,
                                              jax.tree.map(jnp.asarray, ref_p))
        p, s, m = adamw_update(cfg, T.tree_map(lambda x: torch.from_numpy(np.asarray(x)), g),
                               s, p)
        for got, want in zip(T.leaves((p, s.m, s.v)), jax.tree.leaves((ref_p, ref_s.m, ref_s.v))):
            assert got.shape == np.shape(want) and got.dtype == torch.float32
            assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        assert int(s.step) == int(ref_s.step) == step + 1
        for key in ("grad_norm", "lr"):
            assert_allclose(float(m[key]), float(ref_m[key]), rtol=1e-6)


def test_adamw_state_is_a_tree_of_device_tensors():
    params = {"w": torch.ones((2, 3)), "b": torch.zeros(3)}
    s = adamw_init(params)
    assert isinstance(s, AdamWState) and s.step.dtype == torch.int32 and s.step.shape == ()
    assert [x.dtype for x in T.leaves(s)] == [torch.int32] + [torch.float32] * 4
    assert float(global_norm({"x": torch.tensor([3.0]), "y": torch.tensor([4.0])})) == 5.0


def test_update_frees_the_old_state_without_the_cycle_collector():
    """A step's old params, moments and grads die with their last reference:
    no reference cycle in the tree code keeps them for the cyclic collector
    (on the card that held four copies of a 1.4 GB state per step)."""
    import gc
    import weakref

    params = {"a": torch.ones(3, 2), "b": {"c": torch.zeros(4)}}
    opt = adamw_init(params)
    grads = {"a": torch.ones(3, 2), "b": {"c": torch.ones(4)}}
    gc.disable()
    try:
        new = adamw_update(OptConfig(), grads, opt, params)
        refs = [weakref.ref(t) for t in T.leaves((params, opt, grads))]
        del params, opt, grads
        assert all(r() is None for r in refs)
        assert len(T.leaves(new)) == 9
    finally:
        gc.enable()


def test_leaves_follow_jax_order():
    tree = {"z": (1, [2, 3]), "a": {"y": 4, "b": 5},
            "m": RO.AdamWState(step=6, m={"q": 7, "p": 8}, v=None)}
    assert T.leaves(tree) == jax.tree.leaves(tree)
    leaves, spec = T.flatten(tree)
    assert T.unflatten(spec, leaves) == tree


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn((32, 16), generator=g),
        "nested": {"b": torch.arange(7, dtype=torch.int32)},
        "scalar": torch.tensor(3.5),
    }


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 3, tree)
    out = ckpt.restore(str(tmp_path), 3, device="cpu")
    for a, b in zip(T.leaves(tree), T.leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_corruption_fallback(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree(1))
    ckpt.save(str(tmp_path), 2, _tree(2))
    # corrupt step 2's first leaf payload
    d = os.path.join(str(tmp_path), "step_00000002", "arrays")
    victim = os.path.join(d, sorted(os.listdir(d))[0])
    with open(victim, "r+b") as f:
        f.seek(4)
        f.write(b"\xde\xad\xbe\xef")
    step, tree = ckpt.restore_latest(str(tmp_path), device="cpu")
    assert step == 1, "must fall back past the corrupted checkpoint"
    for a, b in zip(T.leaves(_tree(1)), T.leaves(tree)):
        assert_allclose(a.numpy(), b.numpy())


def test_checkpoint_gc(tmp_path):
    for s in range(6):
        ckpt.save(str(tmp_path), s, {"x": torch.tensor(float(s))})
    ckpt.garbage_collect(str(tmp_path), keep=2)
    assert ckpt.available_steps(str(tmp_path)) == [4, 5]


def test_tmp_dirs_not_picked_up(tmp_path):
    ckpt.save(str(tmp_path), 1, {"x": torch.tensor(1.0)})
    os.makedirs(os.path.join(str(tmp_path), "step_00000099.tmp"))
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_checkpoint_keeps_structure_dtypes_and_shapes(tmp_path):
    """An optimizer state (a NamedTuple), a bf16 and an empty leaf, a list
    and None; `tree_shapes` reads the manifest alone."""
    state = ({"w": torch.randn(3, 2).bfloat16(), "e": torch.zeros((0, 4))},
             AdamWState(step=torch.tensor(5, dtype=torch.int32), m=[torch.ones(2), None],
                        v={"k": torch.tensor([True, False])}))
    ckpt.save(str(tmp_path), 7, state)
    out = ckpt.restore(str(tmp_path), 7, device="cpu")
    assert isinstance(out, tuple) and isinstance(out[1], AdamWState)
    assert out[1].m[1] is None
    for a, b in zip(T.leaves(state), T.leaves(out)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    shapes = ckpt.tree_shapes(str(tmp_path), 7)
    assert [(x.shape, x.dtype, x.device.type) for x in T.leaves(shapes)] == [
        (a.shape, a.dtype, "meta") for a in T.leaves(state)]


def test_checkpoint_restore_on_cuda_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ckpt.save(str(tmp_path), 0, {"x": torch.tensor(1.0)})
    with pytest.raises(RuntimeError, match="cuda"):
        ckpt.restore(str(tmp_path), 0)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,ratio,levels", [(8, 0.25, 2), (1000, 0.05, 5), (4096, 0.1, 3),
                                            (777, 1.0, 4), (64, 0.02, 1)])
def test_compress_leaf_ties_match_reference(n, ratio, levels):
    """|g| on a few levels, so it ties across the k-th place: the kept
    positions, in order, and their values are `jax.lax.top_k`'s (descending
    |g|, the lower position first)."""
    rng = np.random.default_rng(n)
    g_np = (rng.integers(-levels, levels + 1, n) * 0.5).astype(np.float32)
    if n == 8:
        g_np = np.array([0, 1, -1, 1, 0, 1, 1, -1], np.float32)
    got = comp.compress_leaf(torch.from_numpy(g_np), ratio)
    want = ref_compression.compress_leaf(jnp.asarray(g_np), ratio)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    if n == 8:
        np.testing.assert_array_equal(got.indices.numpy(), [1, 2])

def test_error_feedback_lossless_over_time():
    """EF guarantees Σ applied = Σ true grads (up to the residual in flight)."""
    rng = np.random.default_rng(0)
    grads = {"w": torch.from_numpy(rng.standard_normal(128).astype(np.float32))}
    ef = ef_init(grads)
    applied_sum = torch.zeros(128)
    true_sum = torch.zeros(128)
    for i in range(20):
        g = {"w": torch.from_numpy(np.random.default_rng(i).standard_normal(128)
                                   .astype(np.float32))}
        applied, ef = compress_with_error_feedback(g, ef, ratio=0.1)
        applied_sum += applied["w"]
        true_sum += g["w"]
    assert_allclose((true_sum - applied_sum).numpy(), ef["w"].numpy(), rtol=1e-4, atol=1e-4)


def test_compression_ratio_bytes():
    grads = {"w": torch.randn(1000, generator=torch.Generator().manual_seed(0))}
    c = comp.compress_tree(grads, ratio=0.05)
    assert comp.compressed_bytes(c) == 50 * 8   # 50 values + 50 indices


def test_compressed_training_converges():
    params = {"w": torch.tensor([4.0, -4.0, 4.0, -4.0])}
    opt = adamw_init(params)
    ef = ef_init(params)
    cfg = OptConfig(lr=0.1, warmup_steps=0, total_steps=300, weight_decay=0.0)
    for _ in range(250):
        grads, ef = compress_with_error_feedback(_quad_grads(params), ef, ratio=0.25)
        params, opt, _ = adamw_update(cfg, grads, opt, params)
    assert float(params["w"].abs().max()) < 0.1


@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.5])
def test_compression_equals_reference(ratio):
    """Continuous values (no ties in |g|): the same kept positions, values,
    dense trees and residuals as the reference's."""
    g_np = {"a": np.random.default_rng(1).standard_normal((30, 7)).astype(np.float32),
            "b": np.random.default_rng(2).standard_normal(50).astype(np.float32)}
    e_np = {k: np.random.default_rng(3).standard_normal(v.shape).astype(np.float32) * 0.1
            for k, v in g_np.items()}
    g = {k: torch.from_numpy(v) for k, v in g_np.items()}
    got = comp.compress_tree(g, ratio)
    want = ref_compression.compress_tree(jax.tree.map(jnp.asarray, g_np), ratio)
    for k in g_np:
        assert np.array_equal(got[k].indices.numpy(), np.asarray(want[k].indices))
        assert np.array_equal(got[k].values.numpy(), np.asarray(want[k].values))
        assert got[k].indices.dtype == torch.int32 and got[k].size == want[k].size
    assert comp.compressed_bytes(got) == ref_compression.compressed_bytes(want)
    dense = comp.decompress_tree(got, g)
    want_dense = ref_compression.decompress_tree(want, jax.tree.map(jnp.asarray, g_np))
    for k in g_np:
        assert np.array_equal(dense[k].numpy(), np.asarray(want_dense[k]))
    applied, ef = compress_with_error_feedback(
        g, {k: torch.from_numpy(v) for k, v in e_np.items()}, ratio)
    ref_applied, ref_ef = ref_compression.compress_with_error_feedback(
        jax.tree.map(jnp.asarray, g_np), jax.tree.map(jnp.asarray, e_np), ratio)
    for k in g_np:
        assert np.array_equal(applied[k].numpy(), np.asarray(ref_applied[k]))
        assert np.array_equal(ef[k].numpy(), np.asarray(ref_ef[k]))


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_stream_determinism_and_resume():
    s1 = TokenStream(100, 4, 16, seed=7)
    s2 = TokenStream(100, 4, 16, seed=7)
    a, _ = s1.batch_at(42)
    b, _ = s2.batch_at(42)
    np.testing.assert_array_equal(a, b)
    c, _ = s1.batch_at(43)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("seed", [0, 7])
def test_token_stream_equals_reference(seed):
    ours, ref = TokenStream(100, 4, 16, seed=seed), ref_pipeline.TokenStream(100, 4, 16, seed=seed)
    for step in (0, 1, 42):
        for a, b in zip(ours.batch_at(step), ref.batch_at(step)):
            assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)
    assert all(np.array_equal(a, b) for a, b in zip(next(iter(ours)), ref.batch_at(0)))


def test_prefetch_preserves_order():
    out = list(prefetch(iter(range(20)), size=4))
    assert out == list(range(20))


# ---------------------------------------------------------------------------
# fault-tolerant loop
# ---------------------------------------------------------------------------

class _QuadStream:
    def batch_at(self, step):
        rng = np.random.default_rng(step)
        return rng.standard_normal(4).astype(np.float32)


def _make_loop(tmp, **kw):
    opt_cfg = OptConfig(lr=0.05, warmup_steps=0, total_steps=1000, weight_decay=0.0)

    def step_fn(state, batch):
        params, opt = state
        w = params["w"].detach().requires_grad_()
        loss = torch.sum((w - batch) ** 2)
        (g,) = torch.autograd.grad(loss, w)
        params, opt, _ = adamw_update(opt_cfg, {"w": g}, opt, params)
        return (params, opt), {"loss": loss.detach()}

    params = {"w": torch.zeros(4)}
    return TrainLoop(
        step_fn=step_fn,
        init_state=(params, adamw_init(params)),
        stream=_QuadStream(),
        cfg=LoopConfig(ckpt_dir=str(tmp), checkpoint_every=10, **kw),
        device="cpu",
    )


def test_loop_checkpoints_and_resumes_bitwise(tmp_path):
    loop1 = _make_loop(tmp_path / "a")
    loop1.run(25)
    w_straight = loop1.state[0]["w"].numpy()

    # same run, interrupted at 20 then resumed
    loop2a = _make_loop(tmp_path / "b")
    loop2a.run(20)
    loop2b = _make_loop(tmp_path / "b")    # fresh process restores step 19
    assert loop2b.start_step == 20
    loop2b.run(5)
    np.testing.assert_array_equal(w_straight, loop2b.state[0]["w"].numpy())


def test_loop_recovers_from_node_failure(tmp_path):
    log = tmp_path / "log.jsonl"
    loop = _make_loop(tmp_path, log_path=str(log))
    boom = {"armed": True}

    def fail_hook(step):
        if step == 13 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("simulated node loss")

    res = loop.run(30, fail_hook=fail_hook)
    assert res["recoveries"] >= 1
    assert res["final_step"] == 29
    assert np.isfinite(res["metrics"]["loss"])
    assert '"event": "retry"' in log.read_text()


def test_loop_restores_after_hard_failure(tmp_path):
    """Past max_retries the loop restores the last checkpoint and goes on."""
    log = tmp_path / "log.jsonl"
    loop = _make_loop(tmp_path, log_path=str(log), max_retries=1)

    def fail_hook(step):
        if step == 12:
            raise RuntimeError("simulated hard failure")

    res = loop.run(15, fail_hook=fail_hook)
    assert res["recoveries"] == 2 and res["final_step"] == 14
    assert '"event": "restore"' in log.read_text()
    assert ckpt.latest_step(str(tmp_path)) == 14


def test_loop_moves_numpy_batches_to_its_device(tmp_path):
    loop = _make_loop(tmp_path)
    batch = loop.to_device((np.ones(3, np.float32), np.arange(2, dtype=np.int32)))
    assert isinstance(batch, tuple) and all(isinstance(b, torch.Tensor) for b in batch)
    assert batch[1].dtype == torch.int32 and batch[0].device.type == "cpu"


def test_loop_on_cuda_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TrainLoop(lambda s, b: (s, {}), {}, _QuadStream(), LoopConfig(ckpt_dir=str(tmp_path)))
