"""The LM family's configs, parameter tree and forward, port against
reference, on the CPU.

Configs: every arch's full `CONFIG` and its `SMOKE` equal the reference's
field for field (but the XLA-only knobs the port leaves out), as do
`small_variant`, `param_count`, `active_param_count`, `LM_SHAPES` and the
cells' FLOP counts.  The tree: `param_shapes` of each full config equals
`jax.eval_shape` of the reference's `init_lm` leaf for leaf (path, shape,
dtype); the port's own `init_lm` makes that tree with the reference's
scales.  The forward of each `SMOKE` config, fed the reference's weights
through `lm_params_from_numpy`: logits within 1e-4 (f32), the MoE aux
loss within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (
    ARCHS, REF_MODULES, XLA_ONLY, RefServe, close, configs, head,
    port_weights, ref_weights, t, tokens,
)
from repro.configs import common as RC
from repro.launch.train import small_variant as ref_small_variant
from repro.models import transformer as rtf
from repro_torch.configs import LM_ARCHS
from repro_torch.configs import lm_cells as C
from repro_torch.core import prng
from repro_torch.launch.train import small_variant
from repro_torch.models import transformer as tf
from repro_torch.models.lm_config import LMConfig

LOGIT_TOL = 1e-4
F32_TOL = 1e-5


def _fields(cfg):
    """A config's fields as plain values, dtypes by name."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v)
        elif f.name == "dtype":
            v = str(v).replace("torch.", "") if isinstance(v, torch.dtype) else np.dtype(v).name
        out[f.name] = v
    return out


def _same_config(port, ref):
    p, r = _fields(port), _fields(ref)
    assert set(r) - set(p) == XLA_ONLY
    for k in p:
        if isinstance(p[k], dict):
            assert {n: r[k][n] for n in p[k]} == p[k], k
        else:
            assert p[k] == r[k], k


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch, which):
    ref, port = configs(arch, which)
    _same_config(port, ref)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert port.d_q_total == ref.d_q_total


def test_param_counts_of_the_full_configs():
    counts = {a: (LM_ARCHS[a].CONFIG.param_count(), LM_ARCHS[a].CONFIG.active_param_count())
              for a in ARCHS}
    assert counts["qwen3-0.6b"] == (751_625_216, 751_625_216)
    for a in ARCHS:
        ref = REF_MODULES[a].CONFIG
        assert counts[a] == (ref.param_count(), ref.active_param_count()), a


@pytest.mark.parametrize("arch", ARCHS)
def test_small_variant_matches(arch):
    ref, port = configs(arch, "CONFIG")
    _same_config(small_variant(port), ref_small_variant(ref))


def test_lm_shapes_and_flops_match():
    assert C.LM_SHAPES == RC.LM_SHAPES
    for a in ARCHS:
        ref, port = configs(a, "CONFIG")
        for B, S in ((1, 1), (8, 32768), (128, 4096)):
            assert C.lm_train_flops(port, B, S) == RC.lm_train_flops(ref, B, S)
            assert C.lm_decode_flops(port, B, S) == RC.lm_decode_flops(ref, B, S)


def _ref_shapes(ref_cfg):
    tree = jax.eval_shape(lambda k: rtf.init_lm(k, ref_cfg), jax.random.key(0))
    return {tuple(getattr(p, "key") for p in path): (tuple(x.shape), np.dtype(x.dtype).name)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_shapes(shapes, prefix=()):
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out.update(_port_shapes(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = (tuple(v[0]), str(v[1]).replace("torch.", ""))
    return out


FUSED = {"fuse_qkv": True, "fuse_gate": True}


@pytest.mark.parametrize("variant", ["CONFIG", "SMOKE", "SMOKE_fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_the_reference(arch, variant):
    ref, port = configs(arch, variant.split("_")[0], **(FUSED if "fused" in variant else {}))
    assert _port_shapes(tf.param_shapes(port)) == _ref_shapes(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_makes_that_tree_with_the_reference_s_scales(arch):
    _, cfg = configs(arch)
    cfg = dataclasses.replace(cfg, n_layers=cfg.n_layers + 2)   # two more layers
    params = tf.init_lm(prng.key(0), cfg, device="cpu")
    want = _port_shapes(tf.param_shapes(cfg))
    got = {}

    def walk(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                got[prefix + (k,)] = v

    walk(params)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in got.items()} == want
    out_scale = 0.02 / (2 * cfg.n_layers) ** 0.5
    for path, v in got.items():
        leaf = path[-1]
        if leaf.startswith(("ln", "q_norm", "kv_norm", "k_norm", "norm", "final_norm")):
            assert bool((v == 1).all()), path
        elif leaf in ("bq", "bk", "bv"):
            assert bool((v == 0).all()), path
        else:
            std = out_scale if leaf in ("wo", "w2", "we2", "ws2") else 0.02
            assert abs(float(v.float().std()) / std - 1) < 0.2, path
            if path[0] in ("dense_layers", "moe_layers") and v.shape[0] > 1:
                assert not torch.equal(v[0], v[1]), path     # layers drawn apart
    again = tf.init_lm(prng.key(0), cfg, device="cpu")
    assert torch.equal(again["embed"], params["embed"])
    other = tf.init_lm(prng.key(1), cfg, device="cpu")
    assert not torch.equal(other["embed"], params["embed"])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches(arch):
    ref, port = configs(arch)
    rparams, np_params = ref_weights(ref)
    params = port_weights(np_params, port)
    tk = tokens(port.vocab, 2, 37)
    h, aux, _ = tf.forward(params, port, t(tk))
    rh, raux, _ = RefServe(ref).forward(rparams, jnp.asarray(tk))
    close(h @ head(params), rh @ head(rparams), LOGIT_TOL)
    close(aux, raux, F32_TOL)
    if port.moe is not None:
        assert float(aux) > 0


def test_forward_with_fused_projections_matches():
    ref, port = configs("qwen1.5-0.5b", **FUSED)
    rparams, np_params = ref_weights(ref)
    params = port_weights(np_params, port)
    assert "wqkv" in params["dense_layers"]["attn"] and "w13" in params["dense_layers"]["ffn"]
    tk = tokens(port.vocab, 2, 20)
    h, _, _ = tf.forward(params, port, t(tk))
    rh, _, _ = RefServe(ref).forward(rparams, jnp.asarray(tk))
    close(h @ head(params), rh @ head(rparams), LOGIT_TOL)


def test_lm_params_from_numpy_carries_bf16_bits():
    ref, port = configs("deepseek-v3-671b", dtype=(jnp.bfloat16, torch.bfloat16))
    _, np_params = ref_weights(ref)
    assert np_params["embed"].dtype.name == "bfloat16"
    params = port_weights(np_params, port)
    assert params["embed"].dtype == torch.bfloat16
    assert params["moe_layers"]["ffn"]["router"].dtype == torch.float32
    for got, want in ((params["embed"], np_params["embed"]),
                      (params["moe_layers"]["ffn"]["we1"], np_params["moe_layers"]["ffn"]["we1"]),
                      (params["mtp"]["block"]["attn"]["w_uk"],
                       np_params["mtp"]["block"]["attn"]["w_uk"])):
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


def test_lm_params_from_numpy_refuses_another_tree():
    ref, port = configs("qwen3-0.6b")
    _, np_params = ref_weights(ref)
    broken = dict(np_params, dense_layers=dict(np_params["dense_layers"]))
    broken["dense_layers"]["attn"] = {k: v for k, v in np_params["dense_layers"]["attn"].items()
                                      if k != "q_normh"}
    with pytest.raises(KeyError, match="q_normh"):
        port_weights(broken, port)
    with pytest.raises(ValueError, match="embed"):
        port_weights(dict(np_params, embed=np_params["embed"][:5]), port)
    with pytest.raises(ValueError, match="float64"):
        port_weights(dict(np_params, head=np_params["head"].astype(np.float64)), port)


def test_lm_config_dtype_default_is_bf16():
    cfg = LMConfig(name="x", n_layers=1, d_model=8, n_heads=2, n_kv_heads=1, d_head=4,
                   d_ff=8, vocab=16)
    assert cfg.dtype == torch.bfloat16
