"""The port's DeepFM serving path (`repro_torch.models.deepfm`,
`repro_torch.configs.deepfm`, `repro_torch.data.pipeline`) against the JAX
reference: the same weights (drawn by the reference's `deepfm_init`,
carried over by `deepfm_params_from_numpy`) and the same numpy fields go
through `deepfm_logits` / `retrieval_score` in both packages.  On the CPU
the port's two bag sums per call run the bag kernel's plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepfm as ref_configs
from repro.data.pipeline import ClickStream as RefClickStream
from repro.models import deepfm as R
from repro_torch.configs import deepfm as C
from repro_torch.core import prng
from repro_torch.data.pipeline import ClickStream
from repro_torch.hopper.embedding_bag import embedding_bag, embedding_bag_plain
from repro_torch.models import deepfm as M
from repro_torch.models.gnn.common import MLP

# logits: sums of O(0.1) terms in f32 taken in other orders (the bag's
# sequential sum against XLA's reduce, addmm against dot); retrieval adds
# the factorised FM term, which the reference's own test holds within 1e-4
LOGIT_TOL = 1e-5
RETRIEVAL_TOL = 1e-4

# the full deep tower and a Criteo-like skew, cut to ~20 K rows
SKEWED = tuple([64] * 13 + [max(16, (v // 2000 + 15) // 16 * 16) for v in C._CAT])
CONFIGS = {
    "smoke": (C.SMOKE_CONFIG, ref_configs.SMOKE_CONFIG),
    "skewed": (M.DeepFMConfig(field_vocabs=SKEWED),
               R.DeepFMConfig(field_vocabs=SKEWED)),
}


def _pair(name, seed=0):
    """(port model on the CPU, reference params, port cfg, reference cfg)
    with the reference's weights in both."""
    cfg, ref_cfg = CONFIGS[name]
    params = jax.tree.map(np.asarray, R.deepfm_init(jax.random.key(seed), ref_cfg))
    model = M.DeepFM(cfg, device="cpu")
    model.load_state_dict(M.deepfm_params_from_numpy(params))
    return model, params, cfg, ref_cfg


def _fields(cfg, B, seed):
    return ClickStream(cfg.field_vocabs, B, seed=seed).batch_at(0)[0]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_reference(name):
    model, params, cfg, ref_cfg = _pair(name)
    fields = _fields(cfg, 64, seed=1)
    got = C.serve_step(model, torch.from_numpy(fields))
    want = np.asarray(R.deepfm_logits(params, ref_cfg, jnp.asarray(fields)))
    assert got.shape == (64,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("item_field", [0, 13])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_retrieval_matches_reference(name, item_field):
    model, params, cfg, ref_cfg = _pair(name)
    user = _fields(cfg, 1, seed=2)[0]
    n_items = cfg.field_vocabs[item_field]
    cands = np.random.default_rng(3).integers(0, n_items, 200).astype(np.int32)
    got = C.retrieval_step(model, torch.from_numpy(user), torch.from_numpy(cands), item_field)
    want = np.asarray(R.retrieval_score(params, ref_cfg, jnp.asarray(user),
                                        jnp.asarray(cands), item_field=item_field))
    assert got.shape == (200,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RETRIEVAL_TOL, atol=RETRIEVAL_TOL)


def test_params_carry_transposes_the_mlp():
    model, params, cfg, _ = _pair("smoke")
    ws, bs = params["mlp"]
    state = model.state_dict()
    assert sorted(state) == sorted(M.deepfm_params_from_numpy(params))
    for i, (w, b) in enumerate(zip(ws, bs)):
        assert np.array_equal(state[f"mlp.layers.{i}.weight"].numpy(), w.T)
        assert np.array_equal(state[f"mlp.layers.{i}.bias"].numpy(), b)
    assert np.array_equal(state["embed"].numpy(), params["embed"])
    assert state["bias"].shape == ()


def test_config_matches_reference():
    assert C.FIELD_VOCABS == ref_configs.FIELD_VOCABS
    assert C.SHAPES == ref_configs.SHAPES
    for cfg, ref_cfg in ((C.CONFIG, ref_configs.CONFIG),
                         (C.SMOKE_CONFIG, ref_configs.SMOKE_CONFIG)):
        assert (cfg.field_vocabs, cfg.embed_dim, cfg.mlp_dims) == (
            ref_cfg.field_vocabs, ref_cfg.embed_dim, ref_cfg.mlp_dims)
        assert cfg.param_count() == ref_cfg.param_count()
        assert cfg.total_vocab == ref_cfg.total_vocab
        assert np.array_equal(cfg.offsets.numpy(), np.asarray(ref_cfg.offsets))
        assert cfg.offsets.dtype == torch.int32
        for B in (512, 262_144):
            assert C._fwd_flops(cfg, B) == ref_configs._fwd_flops(ref_cfg, B)
    assert C.CONFIG.total_vocab == 33_889_984
    assert C.RETRIEVAL_CANDIDATES == 1_000_448


@pytest.mark.parametrize("seed", [0, 7])
def test_click_stream_equals_reference(seed):
    ours = ClickStream(C.FIELD_VOCABS, 128, seed=seed)
    ref = RefClickStream(ref_configs.FIELD_VOCABS, 128, seed=seed)
    for step in (0, 1, 5):
        (f, l), (rf, rl) = ours.batch_at(step), ref.batch_at(step)
        assert f.dtype == rf.dtype == np.int32
        assert np.array_equal(f, rf) and np.array_equal(l, rl)
    first = next(iter(ours))
    assert np.array_equal(first[0], ref.batch_at(0)[0])


def test_fm_identity_vs_bruteforce():
    """½(‖Σv‖²−Σ‖v‖²) == Σ_{i<j} ⟨v_i, v_j⟩, with Σv from the port's bag."""
    cfg = M.DeepFMConfig(field_vocabs=(7, 5, 9, 4), embed_dim=6, mlp_dims=(8,))
    model = M.DeepFM(cfg, seed=0, device="cpu")
    fields = torch.from_numpy(np.random.default_rng(1).integers(0, 4, (10, 4)).astype(np.int32))
    with torch.no_grad():
        flat = fields + model.offsets[None, :]
        v = model.embed[flat]
        s = embedding_bag(model.embed, flat)
        fm = 0.5 * ((s * s).sum(-1) - (v * v).sum(dim=(1, 2)))
        brute = torch.zeros(10)
        for i in range(4):
            for j in range(i + 1, 4):
                brute += (v[:, i] * v[:, j]).sum(-1)
    torch.testing.assert_close(fm, brute, rtol=1e-5, atol=1e-5)


def test_retrieval_matches_full_model_when_deep_is_user_side():
    """With the deep tower blind to the item field, the factorised sweep
    equals the full model's logits per candidate."""
    cfg = M.DeepFMConfig(field_vocabs=(50, 8, 8, 8), embed_dim=6, mlp_dims=(16,))
    model = M.DeepFM(cfg, seed=0, device="cpu")
    user = torch.tensor([0, 3, 1, 5], dtype=torch.int32)     # item_field=0 ignored
    cands = torch.arange(50, dtype=torch.int32)
    scores = C.retrieval_step(model, user, cands, item_field=0)
    with torch.no_grad():
        fields = user[None, :].repeat(50, 1)
        fields[:, 0] = cands
        flat = fields + model.offsets[None, :]
        v = model.embed[flat]
        lin = model.linear[flat].sum(1)
        s = v.sum(1)
        fm = 0.5 * ((s * s).sum(-1) - (v * v).sum(dim=(1, 2)))
        v_deep = v.clone()
        v_deep[:, 0] = 0.0                                     # user side only
        deep = model.mlp(v_deep.reshape(50, -1))[:, 0]
        full = model.bias + lin + fm + deep
    torch.testing.assert_close(scores, full, rtol=1e-4, atol=1e-4)


def test_plain_bag_path_equals_the_wrapper_on_cpu():
    """`bag=` swaps in the kernel's plain version (what chip_smoke.py holds
    the card's path against); on the CPU both are the plain version."""
    model, _, cfg, _ = _pair("smoke")
    fields = torch.from_numpy(_fields(cfg, 32, seed=4))
    with torch.no_grad():
        assert torch.equal(M.deepfm_logits(model, fields),
                           M.deepfm_logits(model, fields, bag=embedding_bag_plain))
        user, cands = fields[0], torch.arange(32, dtype=torch.int32)
        assert torch.equal(M.retrieval_score(model, user, cands, 5),
                           M.retrieval_score(model, user, cands, 5, bag=embedding_bag_plain))


def test_smoke_runs_on_cpu():
    C.smoke(device="cpu")


def test_model_and_mlp_init_follow_the_reference():
    """normal·0.01 tables, zero bias, He-scaled MLP weights, zero biases;
    the same seed draws the same model."""
    cfg = M.DeepFMConfig(field_vocabs=(4000, 4000), embed_dim=10, mlp_dims=(400,))
    a, b = (M.DeepFM(cfg, seed=3, device="cpu").requires_grad_(False) for _ in range(2))
    for k, t in a.state_dict().items():
        assert torch.equal(t, b.state_dict()[k]), k
    assert abs(float(a.embed.std()) - 0.01) < 5e-4
    assert abs(float(a.linear.std()) - 0.01) < 5e-4
    assert float(a.bias) == 0.0
    w0 = a.mlp.layers[0].weight
    assert w0.shape == (400, 20)
    assert abs(float(w0.std()) - (2 / 20) ** 0.5) < 0.02
    assert all(float(layer.bias.abs().max()) == 0.0 for layer in a.mlp.layers)
    mlp = MLP((3, 5, 2), key=prng.key(0), device="cpu")
    assert [tuple(layer.weight.shape) for layer in mlp.layers] == [(5, 3), (2, 5)]


def test_entry_points_raise_on_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        M.DeepFM(C.SMOKE_CONFIG)
    with pytest.raises(RuntimeError, match="cuda"):
        MLP((4, 2), key=prng.key(0))
    with pytest.raises(RuntimeError, match="cuda"):
        C.smoke()
