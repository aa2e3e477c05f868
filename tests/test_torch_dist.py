"""The port's partition-spec policies against the JAX reference's, on the
CPU: `data_axes`, `batch_spec`, `lm_param_specs` (the five full CONFIGs,
`fsdp` off and on), `cache_specs`, `deepfm_specs` (CONFIG and SMOKE, the
MLP weights through `nn.Linear`'s (out, in) transpose) and `zero1_specs`,
each port spec turned into a `jax.sharding.PartitionSpec` and held `==`
to the reference's.  The reference runs on `AbstractMesh`es over
`jax.eval_shape` trees and the port on `MeshShape`s over "meta" tensors:
nothing allocates weights.  Also the spec -> DTensor placement rule."""
import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from _lm_parity import ARCHS, configs
from repro.configs import deepfm as ref_deepfm_cfg
from repro.dist import sharding as RS
from repro.models import transformer as rtf
from repro.models.deepfm import deepfm_init
from repro.train.optimizer import zero1_specs as ref_zero1_specs
from repro_torch.configs import deepfm as DF
from repro_torch.dist import sharding as S
from repro_torch.models import transformer as tf
from repro_torch.models.deepfm import DeepFM
from repro_torch.train import tree as T
from repro_torch.train.optimizer import zero1_specs

MESHES = [
    (("data", "model"), (1, 1)),
    (("data", "model"), (4, 1)),
    (("data", "model"), (2, 4)),
    (("data", "model"), (1, 8)),
    (("data", "model"), (16, 16)),
    (("pod", "data", "model"), (2, 4, 8)),
]
MESH_IDS = ["x".join(map(str, s)) + ("-pod" if len(n) == 3 else "") for n, s in MESHES]


def meshes(i):
    names, sizes = MESHES[i]
    return AbstractMesh(sizes, names), S.MeshShape(names, sizes)


def jp(spec: S.P) -> JP:
    return JP(*spec)


@pytest.fixture(scope="module")
def lm_trees():
    """arch -> (the reference's eval_shape tree, the port's meta tree) of
    its full CONFIG, made once."""
    out = {}
    for arch in ARCHS:
        ref_cfg, cfg = configs(arch, "CONFIG")
        ref = jax.eval_shape(lambda k, c=ref_cfg: rtf.init_lm(k, c), jax.random.key(0))
        port = T.tree_map(lambda s: torch.empty(s[0], dtype=s[1], device="meta"),
                          tf.param_shapes(cfg),
                          is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
                          and isinstance(x[1], torch.dtype))
        out[arch] = (ref, port)
    return out


def assert_same_specs(port_specs, ref_specs, is_ref_leaf=None):
    """Leaf for leaf, in both packages' flatten order (dict keys sorted)."""
    got = T.leaves(port_specs)
    want = jax.tree_util.tree_leaves(ref_specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, S.P)
        assert jp(g) == w, (g, w)


@pytest.mark.parametrize("i", range(len(MESHES)), ids=MESH_IDS)
def test_data_axes_and_batch_spec(i):
    ref_mesh, mesh = meshes(i)
    assert S.data_axes(mesh) == RS.data_axes(ref_mesh)
    for extra in range(3):
        assert jp(S.batch_spec(mesh, extra)) == RS.batch_spec(ref_mesh, extra)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("i", range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_param_specs_equal_reference(lm_trees, arch, i, fsdp):
    ref_mesh, mesh = meshes(i)
    ref, port = lm_trees[arch]
    want = RS.lm_param_specs(ref, ref_mesh, fsdp=fsdp)
    got = S.lm_param_specs(port, mesh, fsdp=fsdp)
    assert T.flatten(got)[1] == T.flatten(port)[1]
    assert_same_specs(got, want)


def test_lm_param_specs_fsdp_on_nemotron(lm_trees):
    """The pod mesh's FSDP leaves name both batch axes as one entry."""
    ref_mesh, mesh = meshes(5)
    got = S.lm_param_specs(lm_trees["nemotron-4-340b"][1], mesh, fsdp=True)
    entries = {e for spec in T.leaves(got) for e in spec}
    assert ("pod", "data") in entries and "model" in entries


@pytest.mark.parametrize("i", range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_specs_equal_reference_on_lm_trees(lm_trees, arch, i):
    """As the reference's train cell calls it: over the data axes, their size."""
    ref_mesh, mesh = meshes(i)
    ref, port = lm_trees[arch]
    dp = RS.data_axes(ref_mesh)
    want = ref_zero1_specs(RS.lm_param_specs(ref, ref_mesh), ref, mesh_axis=dp,
                           mesh_size=RS._axis_size(ref_mesh, dp))
    got = zero1_specs(S.lm_param_specs(port, mesh), port, mesh_axis=S.data_axes(mesh),
                      mesh_size=S._axis_size(mesh, S.data_axes(mesh)))
    assert_same_specs(got, want)


def test_zero1_specs_substrate_case():
    """tests/test_train_substrate.py::test_zero1_specs on the port."""
    params = {"a": torch.empty((64, 8), device="meta"), "b": torch.empty((7,), device="meta")}
    specs = {"a": S.P(None, "model"), "b": S.P(None)}
    z = zero1_specs(specs, params, mesh_axis="data", mesh_size=16)
    assert jp(z["a"]) == JP("data", "model")
    assert jp(z["b"]) == JP(None)
    ref = ref_zero1_specs({"a": JP(None, "model"), "b": JP(None)},
                          {"a": jax.ShapeDtypeStruct((64, 8), "float32"),
                           "b": jax.ShapeDtypeStruct((7,), "float32")},
                          mesh_axis="data", mesh_size=16)
    assert jp(z["a"]) == ref["a"] and jp(z["b"]) == ref["b"]


@pytest.mark.parametrize("batch", [8, 3])
@pytest.mark.parametrize("i", range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch, i, batch):
    ref_mesh, mesh = meshes(i)
    ref_cfg, cfg = configs(arch, "CONFIG")
    want = RS.cache_specs(ref_cfg, ref_mesh, batch, 4096)
    got = S.cache_specs(cfg, mesh, batch, 4096)
    assert isinstance(got, tf.DecodeCache)
    assert sorted(got.data) == sorted(want.data)
    for k in got.data:
        assert jp(got.data[k]) == want.data[k], k
    assert jp(got.pos) == want.pos and got.length == want.length


def _ref_deepfm_leaves(specs):
    """The reference's DeepFM spec tree as {port name: spec}."""
    ws, bs = specs["mlp"]
    out = {k: specs[k] for k in ("embed", "linear", "bias")}
    for i, (w, b) in enumerate(zip(ws, bs)):
        out[f"mlp.layers.{i}.weight"] = w
        out[f"mlp.layers.{i}.bias"] = b
    return out


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE_CONFIG"])
@pytest.mark.parametrize("i", range(len(MESHES)), ids=MESH_IDS)
def test_deepfm_specs_equal_reference(which, i):
    ref_mesh, mesh = meshes(i)
    ref_cfg, cfg = getattr(ref_deepfm_cfg, which), getattr(DF, which)
    ref = jax.eval_shape(lambda k: deepfm_init(k, ref_cfg), jax.random.key(0))
    want = _ref_deepfm_leaves(RS.deepfm_specs(ref, ref_mesh))
    got = S.deepfm_specs(DF.train_param_shapes(cfg), mesh)
    assert sorted(got) == sorted(want)
    for name, spec in got.items():
        # nn.Linear's (out, in) is the transpose of the reference's (in, out)
        spec = S.P(*reversed(spec)) if name.endswith(".weight") else spec
        assert jp(spec) == want[name], name


def test_deepfm_specs_on_config_shard_the_tables_over_every_axis():
    _, mesh = meshes(2)
    got = S.deepfm_specs(DF.train_param_shapes(DF.CONFIG), mesh)
    assert got["embed"] == S.P(("data", "model"), None)
    assert got["linear"] == S.P(("data", "model"))
    assert got["bias"] == S.P() and got["mlp.layers.3.weight"] == S.P()
    assert got["mlp.layers.0.weight"] == S.P("model", None)


def test_train_param_shapes_are_train_params():
    model = DeepFM(DF.SMOKE_CONFIG, seed=0, device="cpu")
    want = DF.train_params(model)
    got = DF.train_param_shapes(DF.SMOKE_CONFIG)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


def test_placements_of_specs():
    mesh = S.MeshShape(("data", "model"), (2, 4))
    assert S.placements(S.P(("data", "model"), None), mesh) == [Shard(0), Shard(0)]
    assert S.placements(S.P(None, "model"), mesh) == [Replicate(), Shard(1)]
    assert S.placements(S.P(), mesh) == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="out of mesh order"):
        S.placements(S.P(("model", "data")), mesh)
    with pytest.raises(ValueError, match="not in the mesh"):
        S.placements(S.P("pod"), mesh)


def test_spec_is_a_tree_leaf():
    # a spec is no tuple: tree code takes it as one leaf with no is_leaf hook
    assert not isinstance(S.P(), tuple)
    assert tuple(S.P("data", None)) == ("data", None) and S.P(None) != S.P()
    specs = {"a": S.P("data", None), "b": [S.P(), S.P(None)]}
    assert T.leaves(specs) == [S.P("data", None), S.P(), S.P(None)]
    paths = []
    T.tree_map_with_path(lambda p, x: paths.append(p), specs)
    assert paths == [("a",), ("b", 0), ("b", 1)]
