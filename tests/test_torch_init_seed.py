"""From the seed alone, the port's draws outside the MIS paths against the
reference's: model inits, the GNN samplers, the serve launcher's prompts
and samples, the smoke inputs.  No weight or draw is carried across.

Tolerances: integer and uniform draws are bit for bit; a normal goes
through XLA's `erf_inv`, whose `log1p` is not torch's, so an f32 leaf is
held within 4 ulp (3 of the normal, 1 of its scale) and a bf16 leaf within
one bf16 ulp.

`chip_smoke.py` holds the card's full-width inits (qwen3-0.6b, DeepFM's
CONFIG, GIN at minibatch_lg's widths) to the reference's first elements
of every normal leaf, `INIT_SEED_LEAVES`.  A draw's element j depends on
its key and j alone and the key tree on the structure alone, so the
reference computes those elements here at tiny widths of the same
structure (`reference_leaves`), and this file holds the pinned constants
(read from chip_smoke.py's source, not imported) to it and the port's
tiny-width inits to them by the card's rule."""
import ast
import contextlib
import dataclasses
import io
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY
from repro.configs import deepfm as ref_deepfm_cfg
from repro.configs import gnn_cells as ref_cells
from repro.graphs import sampler as ref_sampler
from repro.graphs.generators import erdos_renyi as ref_erdos_renyi
from repro.launch import serve as ref_serve
from repro.launch.train import small_variant as ref_small_variant
from repro.models import deepfm as ref_deepfm
from repro.models import transformer as rtf
from repro_torch.configs import GNN_ARCHS, LM_ARCHS
from repro_torch.configs import deepfm as DF
from repro_torch.configs import gnn_cells as C
from repro_torch.configs import lm_cells as LC
from repro_torch.core import prng
from repro_torch.graphs import sampler as S
from repro_torch.graphs.generators import erdos_renyi
from repro_torch.launch import serve
from repro_torch.launch.train import small_variant
from repro_torch.models import deepfm as M
from repro_torch.models import gnn as G
from repro_torch.models import transformer as tf

CHIP_SMOKE = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
F32_ULPS, BF16_ULPS = 4, 1
# the structures chip_smoke.py inits at full width, here at tiny widths:
# every fan-in that sets a scale kept (the MLPs' widths, n_layers)
LM_TINY = dict(d_model=16, n_heads=2, n_kv_heads=1, d_head=8, d_ff=16, vocab=32)
DEEPFM_TINY_VOCABS = (1,) * 39
GIN_WIDTHS = dict(d_in=602, n_out=41)         # minibatch_lg's features and classes
PIN_ELEMENTS = 8


def _pinned() -> dict:
    for node in ast.parse(CHIP_SMOKE.read_text()).body:
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "INIT_SEED_LEAVES"):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py assigns no INIT_SEED_LEAVES")


def _ordered(bits: np.ndarray, width: int) -> np.ndarray:
    """Sign-magnitude float bits as integers in the floats' order."""
    b = bits.astype(np.int64) & ((1 << width) - 1)
    sign = 1 << (width - 1)
    return np.where(b & sign, -(b & (sign - 1)), b)


def _bits(x) -> tuple:
    """("bf16" | "f32", bits as a numpy int array) of a numpy / jax array."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return "bf16", a.view(np.int16).astype(np.int64)
    return "f32", np.asarray(a, dtype=np.float32).view(np.int32).astype(np.int64)


def _torch_bits(t: torch.Tensor) -> tuple:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return "bf16", t.view(torch.int16).numpy().astype(np.int64)
    return "f32", t.float().view(torch.int32).numpy().astype(np.int64)


def _ulps(kind: str, got, want) -> int:
    width = 16 if kind == "bf16" else 32
    return int(np.abs(_ordered(np.asarray(got), width) - _ordered(np.asarray(want), width)).max())


def _assert_close_bits(got, want, what: str) -> None:
    """Port against reference leaf: one bf16 ulp, or 4 f32 ulps."""
    (kind, g), (kind_w, w) = got, want
    assert kind == kind_w and g.shape == w.shape, what
    if g.size:
        limit = BF16_ULPS if kind == "bf16" else F32_ULPS
        assert _ulps(kind, g, w) <= limit, f"{what}: {_ulps(kind, g, w)} ulps"


# --------------------------------------------------------------------------
# the pinned elements
# --------------------------------------------------------------------------

def _lm_tiny(cfg):
    return dataclasses.replace(cfg, **LM_TINY)


def _deepfm_tiny(cfg):
    return dataclasses.replace(cfg, field_vocabs=DEEPFM_TINY_VOCABS)


def _head(kind_bits) -> tuple:
    kind, b = kind_bits
    return kind, [int(x) for x in b.reshape(-1)[:PIN_ELEMENTS]]


def reference_leaves() -> dict:
    """{model: {leaf: (kind, scale, first PIN_ELEMENTS bits)}} from the
    reference: qwen3-0.6b's `init_lm(key(0))` (a stacked leaf's layers 0
    and n - 1), DeepFM's `deepfm_init(key(0), CONFIG)` and GIN's
    `gin_init(key(0), 602, n_out=41)`, each at tiny widths of its
    structure."""
    out = {}
    cfg = REGISTRY["qwen3-0.6b"].config
    tree = rtf.init_lm(jax.random.key(0), _lm_tiny(cfg))
    scales = {"/".join(p): init for p, _, _, init in tf._walk(tf._tree_spec(
        LM_ARCHS["qwen3-0.6b"].CONFIG)) if not isinstance(init, str)}
    lm = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(p.key for p in path)
        if name not in scales:
            continue
        layers = (0, leaf.shape[0] - 1) if name.split("/")[0].endswith("_layers") else (None,)
        for i in layers:
            kind, first = _head(_bits(leaf if i is None else leaf[i]))
            lm[name if i is None else f"{name}@{i}"] = (kind, scales[name], first)
    out["qwen3-0.6b"] = lm

    dcfg = ref_deepfm_cfg.CONFIG
    p = ref_deepfm.deepfm_init(jax.random.key(0), _deepfm_tiny(dcfg))
    d = {"embed": ("f32", 0.01, _head(_bits(p["embed"]))[1]),
         "linear": ("f32", 0.01, _head(_bits(p["linear"]))[1])}
    for i, w in enumerate(p["mlp"].ws):
        d[f"mlp/{i}"] = ("f32", (2.0 / w.shape[0]) ** 0.5, _head(_bits(w))[1])
    out["deepfm"] = d

    from repro.configs import gin_tu as ref_gin_cfg

    g = ref_gin_cfg._init(jax.random.key(0), GIN_WIDTHS["d_in"], GIN_WIDTHS["n_out"])
    gin = {}
    for l, layer in enumerate(g["layers"]):
        for i, w in enumerate(layer["mlp"].ws):
            gin[f"layers/{l}/mlp/{i}"] = ("f32", (2.0 / w.shape[0]) ** 0.5, _head(_bits(w))[1])
    for i, w in enumerate(g["head"].ws):
        gin[f"head/{i}"] = ("f32", (2.0 / w.shape[0]) ** 0.5, _head(_bits(w))[1])
    out["gin-tu"] = gin
    return out


def port_leaves(model: str, built) -> dict:
    """{leaf: (kind, all its bits)} of the port's build of `model`, named
    as `reference_leaves` names them (MLP weights as the reference's (in,
    out))."""
    if model == "qwen3-0.6b":
        params, cfg = built
        out = {}
        for path, _, _, init in tf._walk(tf._tree_spec(cfg)):
            if isinstance(init, str):
                continue
            leaf = tf._get(params, path)
            name = "/".join(path)
            if path[0].endswith("_layers"):
                for i in (0, leaf.shape[0] - 1):
                    out[f"{name}@{i}"] = _torch_bits(leaf[i])
            else:
                out[name] = _torch_bits(leaf)
        return out
    if model == "deepfm":
        out = {"embed": _torch_bits(built.embed), "linear": _torch_bits(built.linear)}
        for i, layer in enumerate(built.mlp.layers):
            out[f"mlp/{i}"] = _torch_bits(layer.weight.T)
        return out
    out = {}
    for l, layer in enumerate(built.layers):
        for i, lin in enumerate(layer.mlp.layers):
            out[f"layers/{l}/mlp/{i}"] = _torch_bits(lin.weight.T)
    for i, lin in enumerate(built.head.layers):
        out[f"head/{i}"] = _torch_bits(lin.weight.T)
    return out


def test_pinned_init_elements_are_the_reference_s():
    pinned = _pinned()
    assert pinned == reference_leaves()
    assert sorted(pinned) == ["deepfm", "gin-tu", "qwen3-0.6b"]
    assert len(pinned["qwen3-0.6b"]) == 2 + 2 * 7         # embed, head, 7 stacked leaves
    assert all(len(v[2]) == PIN_ELEMENTS for m in pinned.values() for v in m.values())


@pytest.mark.parametrize("model", ["qwen3-0.6b", "deepfm", "gin-tu"])
def test_port_tiny_inits_hold_to_the_pins(model):
    """The card's rule on the CPU: the port's init of the same structure
    at tiny widths, its first elements of every normal leaf within one
    bf16 / 4 f32 ulps of the pins."""
    pinned = _pinned()[model]
    if model == "qwen3-0.6b":
        cfg = _lm_tiny(LM_ARCHS[model].CONFIG)
        built = (tf.init_lm(prng.key(0), cfg, device="cpu"), cfg)
    elif model == "deepfm":
        built = M.DeepFM(_deepfm_tiny(DF.CONFIG), seed=0, device="cpu")
    else:
        built = GNN_ARCHS["gin-tu"].init(GIN_WIDTHS["d_in"], GIN_WIDTHS["n_out"], seed=0,
                                         device="cpu")
    leaves = port_leaves(model, built)
    assert sorted(leaves) == sorted(pinned)
    for name, (kind, _, want) in pinned.items():
        got_kind, got = leaves[name]
        assert got_kind == kind, name
        assert _ulps(kind, got.reshape(-1)[:PIN_ELEMENTS], np.array(want)) <= (
            BF16_ULPS if kind == "bf16" else F32_ULPS), name


# --------------------------------------------------------------------------
# model inits from the seed
# --------------------------------------------------------------------------

def _lm_pair(arch: str, dtype=None):
    rcfg = ref_small_variant(REGISTRY[arch].config)
    cfg = small_variant(LM_ARCHS[arch].CONFIG)
    if dtype is not None:
        rcfg = dataclasses.replace(rcfg, dtype=jnp.bfloat16)
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    return rcfg, cfg


@pytest.mark.parametrize("arch, dtype", [(a, None) for a in sorted(LM_ARCHS)]
                         + [("deepseek-v3-671b", "bf16"), ("qwen3-0.6b", "bf16")])
def test_init_lm_from_the_seed_is_the_reference_s(arch, dtype):
    """`init_lm(prng.key(0), small_variant(cfg))` leaf for leaf against the
    reference's `init_lm(jax.random.key(0), ...)`: every leaf's path,
    shape and dtype, ones and zeros exact, normals within the tolerance
    (MLA, MoE with its f32 router, MTP and the fused flags each follow the
    reference's split tree)."""
    rcfg, cfg = _lm_pair(arch, dtype)
    ref = rtf.init_lm(jax.random.key(0), rcfg)
    got = tf.init_lm(prng.key(0), cfg, device="cpu")
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(ref_leaves) == sum(1 for _ in tf._walk(tf._tree_spec(cfg)))
    for path, leaf in ref_leaves:
        names = tuple(p.key for p in path)
        _assert_close_bits(_torch_bits(tf._get(got, names)), _bits(leaf), "/".join(names))


@pytest.mark.parametrize("fuse", ["fuse_qkv", "fuse_gate"])
def test_init_lm_fused_leaves_take_the_reference_s_keys(fuse):
    """`wqkv` under the attention split's key 0 and `wo` under key 3; `w13`
    under the FFN split's key 0."""
    rcfg, cfg = _lm_pair("qwen3-0.6b")
    rcfg, cfg = (dataclasses.replace(c, **{fuse: True}) for c in (rcfg, cfg))
    ref = rtf.init_lm(jax.random.key(5), rcfg)
    got = tf.init_lm(prng.key(5), cfg, device="cpu")
    for names in (("dense_layers", "attn", "wqkv" if fuse == "fuse_qkv" else "wq"),
                  ("dense_layers", "attn", "wo"),
                  ("dense_layers", "ffn", "w13" if fuse == "fuse_gate" else "w1")):
        _assert_close_bits(_torch_bits(tf._get(got, names)), _bits(tf._get(ref, names)),
                           "/".join(names))


def _gnn_ref_tree(arch: str, d_in: int, n_out: int, key):
    from repro.configs import egnn, gin_tu, mace, pna

    mod = {"gin-tu": gin_tu, "pna": pna, "egnn": egnn, "mace": mace}[arch]
    return mod._init(key, d_in, n_out)


@pytest.mark.parametrize("arch, n_out", [("gin-tu", 7), ("pna", 7), ("egnn", 1),
                                         ("egnn", 5), ("mace", 1), ("mace", 41)])
def test_gnn_init_from_the_seed_is_the_reference_s(arch, n_out):
    """Each GNN arch's module from `key=` against its config's `_init`
    (the `*_init` split trees; MACE's `fold_in(k3, l)` / `fold_in(k3, 10 +
    l)` mixes and, for n_out != 1, the readout under `fold_in(key, 99)`):
    every leaf within 4 f32 ulps."""
    key = jax.random.fold_in(jax.random.key(3), 1)
    tree = _gnn_ref_tree(arch, 12, n_out, key)
    want = G.gnn_params_from_numpy(arch, jax.tree.map(np.asarray, tree))
    pkey = prng.fold_in(prng.key(3), 1)
    model = GNN_ARCHS[arch].init(12, n_out, key=pkey, device="cpu")
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        _assert_close_bits(_torch_bits(got[name]), _torch_bits(w), name)
    seeded = GNN_ARCHS[arch].init(12, n_out, seed=7, device="cpu")
    again = GNN_ARCHS[arch].init(12, n_out, key=prng.key(7), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(seeded.parameters(), again.parameters()))


def test_deepfm_init_from_the_seed_is_the_reference_s():
    """DeepFM's SMOKE_CONFIG: `deepfm_init(key(0))`'s tables and MLP
    (split(key, 3)) within 4 f32 ulps, the bias zero."""
    tree = jax.tree.map(np.asarray, ref_deepfm.deepfm_init(jax.random.key(0),
                                                           ref_deepfm_cfg.SMOKE_CONFIG))
    want = M.deepfm_params_from_numpy(tree)
    model = M.DeepFM(DF.SMOKE_CONFIG, seed=0, device="cpu")
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        _assert_close_bits(_torch_bits(got[name]), _torch_bits(w), name)


def test_meta_builds_shapes_and_draws_nothing():
    """The dry run's modules: on "meta" a model has its shapes and dtypes
    and no launch or draw happens."""
    from repro_torch.hopper import threefry as TF

    before = TF.threefry_bits.launches
    model = M.DeepFM(DF.CONFIG, seed=0, device="meta")
    assert model.embed.shape == (DF.CONFIG.total_vocab, DF.CONFIG.embed_dim)
    assert model.embed.device.type == "meta"
    gnn = GNN_ARCHS["mace"].init(16, 41, seed=0, device="meta")
    assert all(p.device.type == "meta" for p in gnn.parameters())
    params = tf.init_lm(prng.key(0), LM_ARCHS["qwen3-0.6b"].CONFIG, device="meta")
    assert params["embed"].shape == (151936, 1024) and params["embed"].dtype == torch.bfloat16
    assert TF.threefry_bits.launches == before


# --------------------------------------------------------------------------
# the GNN samplers from the key
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5])
def test_neighbor_sampler_from_the_key(seed):
    """`NeighborSampler.sample(key, seeds)` from the key alone: the
    reference's layers and masks bit for bit; then as two ranks' blocks of
    the batch (rows from row0, the draws from its start counter)."""
    ref_g = ref_erdos_renyi(300, avg_deg=3.0, seed=seed)
    g = erdos_renyi(300, avg_deg=3.0, seed=seed, device="cpu")
    seeds = np.arange(1, 61, 3, dtype=np.int32)
    fanout = (5, 3)
    key = jax.random.fold_in(jax.random.key(seed), 9)
    pkey = prng.fold_in(prng.key(seed), 9)
    want = ref_sampler.NeighborSampler(ref_g, fanout).sample(key, jnp.asarray(seeds))
    sampler = S.NeighborSampler(g, fanout)
    sub = sampler.sample(pkey, torch.from_numpy(seeds))
    for got_l, want_l in zip(sub.layers + sub.masks, want.layers + want.masks):
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    half = len(seeds) // 2
    for lo, hi in ((0, half), (half, len(seeds))):
        block = sampler.sample(pkey, torch.from_numpy(seeds[lo:hi]), row0=lo)
        for got_l, want_l in zip(block.layers + block.masks, want.layers + want.masks):
            np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l)[lo:hi])


def test_minibatch_tree_from_the_key(monkeypatch):
    """The minibatch cell's inline sampler from the key alone: the port's
    `minibatch_draws(key, ...)` are the reference cell's `k1, k2 =
    split(key)` integers bit for bit, whole and as two ranks' row blocks,
    and the tree the step builds from them is the reference's (captured
    from its node_logits)."""
    B, fanout, n = 6, (4, 3), 80
    shape = dict(ref_cells.GNN_SHAPES["minibatch_lg"], n_nodes=n, batch_nodes=B,
                 fanout=fanout)
    monkeypatch.setitem(ref_cells.GNN_SHAPES, "minibatch_lg", shape)
    key = jax.random.key(21)
    pkey = prng.key(21)
    k1, k2 = jax.random.split(key)
    hi = jnp.iinfo(jnp.int32).max
    want = (np.asarray(jax.random.randint(k1, (B, 4), 0, hi, dtype=jnp.int32)),
            np.asarray(jax.random.randint(k2, (B, 4, 3), 0, hi, dtype=jnp.int32)))
    got = C.minibatch_draws(pkey, B, fanout, "cpu")
    for u, w in zip(got, want):
        np.testing.assert_array_equal(u.numpy(), w)
    for lo, hi_ in ((0, 2), (2, B)):
        block = C.minibatch_draws(pkey, hi_ - lo, fanout, "cpu", row0=lo)
        for u, w in zip(block, want):
            np.testing.assert_array_equal(u.numpy(), w[lo:hi_])

    rng = np.random.default_rng(4)
    deg = rng.integers(0, 5, n)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    seeds = rng.choice(n, B, replace=False).astype(np.int32)
    tree = C.minibatch_tree(torch.from_numpy(indptr), torch.from_numpy(indices),
                            torch.from_numpy(seeds), got)
    # the reference cell's sampler, as its train_step runs it
    r_indptr, r_indices = jnp.asarray(indptr, jnp.int32), jnp.asarray(indices)

    def sample(frontier, k, fan):
        start = r_indptr[frontier]
        d = r_indptr[frontier + 1] - start
        u = jax.random.randint(k, frontier.shape + (fan,), 0, hi, dtype=jnp.int32)
        offs = u % jnp.maximum(d, 1)[..., None]
        nbr = r_indices[jnp.minimum(start[..., None] + offs, r_indices.shape[0] - 1)]
        m = jnp.broadcast_to(d[..., None] > 0, nbr.shape)
        return jnp.where(m, nbr, 0), m

    l1, m1 = sample(jnp.asarray(seeds), k1, 4)
    l2, m2 = sample(l1, k2, 3)
    ids = np.concatenate([seeds, np.asarray(l1).reshape(-1), np.asarray(l2).reshape(-1)])
    emask = np.concatenate([np.asarray(m1).reshape(-1),
                            np.asarray(m2 & m1[..., None]).reshape(-1)])
    np.testing.assert_array_equal(tree[0].numpy(), ids)
    np.testing.assert_array_equal(tree[3].numpy(), emask)


# --------------------------------------------------------------------------
# the serve launcher and the smoke inputs
# --------------------------------------------------------------------------

def _ref_serve_ids(argv) -> str:
    buf = io.StringIO()
    old = sys.argv
    sys.argv = ["serve"] + argv
    try:
        with contextlib.redirect_stdout(buf):
            ref_serve.main()
    finally:
        sys.argv = old
    return buf.getvalue().splitlines()[3]


def test_serve_prompts_are_the_reference_s():
    """`randint(key(1), (batch, prompt_len), 0, vocab)` bit for bit."""
    cfg = small_variant(LM_ARCHS["qwen3-0.6b"].CONFIG)
    want = jax.random.randint(jax.random.key(1), (4, 32), 0, cfg.vocab, dtype=jnp.int32)
    got = serve.prompts(cfg, 4, 32, "cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_launcher_samples_the_reference_s_tokens(capsys):
    """`python -m repro_torch.launch.serve --temperature 0.8` from the seed
    alone prints the reference launcher's sampled token ids: its weights
    within ulps, its prompts and each step's `categorical(key(100 + i))`
    the reference's."""
    argv = ["--arch", "qwen3-0.6b", "--batch", "2", "--prompt-len", "8", "--gen", "6",
            "--temperature", "0.8"]
    want = _ref_serve_ids(argv)
    serve.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[3] == want


def test_generate_samples_categorical_under_key_base():
    """`generate(temperature=T, key_base=b)` step i is `categorical(key(b +
    i), logits / T)` of that step's logits."""
    cfg = small_variant(LM_ARCHS["qwen3-0.6b"].CONFIG)
    params = tf.init_lm(prng.key(0), cfg, device="cpu")
    toks = serve.prompts(cfg, 2, 5, "cpu")
    got, _, _, _ = serve.generate(params, cfg, toks, 3, temperature=0.5, key_base=40)
    logits, cache = tf.prefill(params, cfg, toks, max_len=8)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    for i in range(3):
        assert torch.equal(got[:, i], tok)
        logits, cache = tf.decode_step(params, cfg, cache, tok)
        tok = prng.categorical(prng.key(40 + i), logits / 0.5)


def test_deepfm_smoke_inputs_are_the_reference_s():
    """The smoke's fields `randint(key(1))` and labels `uniform(key(2)) >
    0.5` bit for bit, the model from `key(0)` within the tolerance."""
    model, fields, labels = DF.smoke_inputs("cpu")
    np.testing.assert_array_equal(fields.numpy(), np.asarray(jax.random.randint(
        jax.random.key(1), (16, 39), 0, 32, dtype=jnp.int32)))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(
        (jax.random.uniform(jax.random.key(2), (16,)) > 0.5).astype(jnp.float32)))
    want = jax.tree.map(np.asarray, ref_deepfm.deepfm_init(jax.random.key(0),
                                                           ref_deepfm_cfg.SMOKE_CONFIG))
    _assert_close_bits(_torch_bits(model.embed), _bits(want["embed"]), "embed")


def test_lm_smoke_inputs_are_the_reference_s():
    """`lm_smoke`'s tokens `randint(key(1), (2, 32))` bit for bit and its
    weights `init_lm(key(0))` within the tolerance."""
    rcfg, cfg = _lm_pair("mixtral-8x22b")
    params, tokens = LC.smoke_inputs(cfg, "cpu")
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jax.random.randint(
        jax.random.key(1), (2, 32), 0, rcfg.vocab, dtype=jnp.int32)))
    ref = rtf.init_lm(jax.random.key(0), rcfg)
    _assert_close_bits(_torch_bits(params["embed"]), _bits(ref["embed"]), "embed")


def test_gnn_smoke_inputs_are_the_reference_s():
    """`gnn_smoke`'s features `normal(key(0), (n, 8))`, coordinates
    `normal(key(1), (n, 3))` within 4 ulps, labels `randint(key(2))` bit
    for bit."""
    n = 120
    feats, coords, labels = C.smoke_inputs(n, "cpu")
    assert _ulps("f32", _torch_bits(feats)[1], _bits(jax.random.normal(
        jax.random.key(0), (n, 8)))[1]) <= F32_ULPS
    assert _ulps("f32", _torch_bits(coords)[1], _bits(jax.random.normal(
        jax.random.key(1), (n, 3)))[1]) <= F32_ULPS
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jax.random.randint(
        jax.random.key(2), (n,), 0, 4, dtype=jnp.int32)))
