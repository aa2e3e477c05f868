"""The distribution layer across gloo ranks on the CPU: eight `python -c`
processes, one per rank, a `file://` rendezvous under the module's
temporary directory, one launch shared by the tests (a module fixture):

* the eight ranks on a (2, 4) ("data", "model") mesh: `distribute` and
  `shard_batch` blocks, held here to numpy slices by the spec;
  `reshard_checkpoint` of a checkpoint written here on one rank, saved
  again from the eight ranks and restored here, bit-equal (1 -> 8 -> 1),
  and restored by every rank as soon as its placed save returns;
  `moe_ffn_shardmap` (the reference test's `MoEConfig(8, 2, 32,
  capacity_factor=8.0)`, N = 64, D = 16) held to the reference's
  `moe_ffn` output with the same weights (2e-4, the reference test's
  tolerance) and every leaf's gradient of the output's sum, combined by
  `moe_shardmap_grads`, to `jax.grad` of `moe_ffn`'s; one LM step (qwen3
  SMOKE) and one DeepFM step on (2, 4), each returning the loss of the
  step without a mesh (`test_steps_refuse_a_model_axis`, whose name stays
  from when the steps refused a 'model' axis > 1);
* then ranks 0-3 on a (4, 1) mesh: the data-parallel LM train step for qwen3,
  deepseek (MLA, sigmoid router, MTP) and mixtral SMOKE at a capacity
  factor that drops assignments (the drop fraction checked nonzero, and
  per-rank routing checked to keep other slots), and the DeepFM SMOKE
  step through the vocab-parallel bag, each held after 2 steps to the
  step without a mesh in this process, rtol = atol = 1e-5 in f32 (the
  ranks sum the same terms in other orders).
"""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.models.lm_config import MoEConfig as RefMoEConfig
from repro.models.moe import moe_ffn as ref_moe_ffn
from repro_torch.configs import LM_ARCHS
from repro_torch.core import prng
from repro_torch.configs import deepfm as DF
from repro_torch.configs import lm_cells as C
from repro_torch.models import transformer as tf
from repro_torch.models.deepfm import DeepFM
from repro_torch.train import OptConfig, adamw_init
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import tree as T

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = 1e-5
MOE_TOL = 2e-4
LM_CASES = {"qwen3-0.6b": None, "deepseek-v3-671b": None, "mixtral-8x22b": 0.5}
LM_BATCH = (8, 32)        # global (B, S): 2 sequences a rank on four ranks
DEEPFM_BATCH = 64
STEPS = 2
OPT = dict(total_steps=100)
MOE = dict(n_experts=8, top_k=2, d_expert=32, capacity_factor=8.0)
MOE_N, MOE_D = 64, 16


@pytest.fixture(autouse=True)
def no_group_left():
    """Each test starts and ends with no default process group."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


_PRELUDE = """
import json, os, sys
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

rank, size, data = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + os.path.join(data, "rendezvous"),
                        rank=rank, world_size=size)
load = lambda name: np.load(os.path.join(data, name + ".npy"))
meta = json.load(open(os.path.join(data, "meta.json")))
out = {}
def save(name, x):
    np.save(os.path.join(data, name + ".npy"), np.asarray(x))
"""

_EIGHT = _PRELUDE + """
from repro_torch.configs import LM_ARCHS, deepfm as DF, lm_cells as C
from repro_torch.core import prng
from repro_torch.data.pipeline import shard_batch
from repro_torch.dist import distribute, reshard_checkpoint
from repro_torch.dist.sharding import P, batch_spec
from repro_torch.models.lm_config import MoEConfig
from repro_torch.models.moe_shardmap import moe_ffn_shardmap, moe_shardmap_grads
from repro_torch.train import OptConfig
from repro_torch.train import checkpoint as ckpt

mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4), mesh_dim_names=("data", "model"))
out["coord"] = list(mesh.get_coordinate())

# distribute and shard_batch: this rank's blocks
tree = {"w": torch.from_numpy(load("w")), "e": torch.from_numpy(load("e")),
        "b": torch.from_numpy(load("b"))}
specs = {"w": P("data", "model"), "e": P(None, ("data", "model")), "b": P()}
placed = distribute(tree, specs, mesh)
for k, v in placed.items():
    save(f"block_{k}.rank{rank}", v.to_local())
    out[f"full_{k}"] = bool(torch.equal(v.full_tensor(), tree[k]))
tokens = shard_batch(load("tokens"), mesh, batch_spec(mesh, 1))
save(f"block_tokens.rank{rank}", tokens.to_local())

# elastic: grow the one-rank checkpoint onto the mesh, save it from here
spec_fn = lambda t, m: {k: P("data", "model") if v.ndim == 2 else P() for k, v in t.items()}
grown = reshard_checkpoint(os.path.join(data, "ckpt"), 0, mesh, spec_fn)
for k, v in grown.items():
    save(f"grown_{k}.rank{rank}", v.to_local())
    out[f"grown_placements_{k}"] = [str(q) for q in v.placements]
ckpt.save(os.path.join(data, "ckpt"), 1, grown)
# every rank reads it as soon as its save returns (the writer is rank 0)
back = ckpt.restore(os.path.join(data, "ckpt"), 1, device="cpu")
out["restored_after_save"] = {k: bool(np.array_equal(v.numpy(), load(k))) for k, v in back.items()}

# the expert-parallel MoE FFN
cfg = MoEConfig(**meta["moe"])
whole = {k: torch.from_numpy(load("moe_" + k)) for k in meta["moe_leaves"]}
moe_specs = {k: P("model", None, None) if k.startswith("we") else P() for k in whole}
params = distribute(whole, moe_specs, mesh)
leaves = {k: v.to_local().detach().requires_grad_() for k, v in params.items()}
d = mesh.get_coordinate()[0]
x = torch.from_numpy(load("moe_x"))
n_loc = x.shape[0] // mesh.size(0)
y = moe_ffn_shardmap(leaves, x[d * n_loc:(d + 1) * n_loc], cfg, "swiglu", mesh)
save(f"moe_out.rank{rank}", y.detach())
grads = dict(zip(leaves, torch.autograd.grad(y.sum(), list(leaves.values()))))
for k, g in moe_shardmap_grads(grads, params, mesh).items():
    full = g.full_tensor()
    if rank == 0:
        save("moe_grad_" + k, full)

# the steps on the model axis: one LM and one DeepFM step's loss
from repro_torch.dist import data_axes
from repro_torch.models import transformer as tf
from repro_torch.models.deepfm import DeepFM
cfg = LM_ARCHS["qwen3-0.6b"].SMOKE
lm_params, lm_opt = C.place_lm_state(tf.init_lm(prng.key(0), cfg, device="cpu"), mesh)
step = C.make_lm_train_step(cfg, OptConfig(**meta["opt"]), mesh=mesh)
batch = shard_batch((load("lm_tokens0"), load("lm_targets0")), mesh, batch_spec(mesh, 1))
out["model_axis_lm"] = step(lm_params, lm_opt, *batch)[2].item()
model = DeepFM(DF.SMOKE_CONFIG, seed=0, device="cpu")
fm_params, fm_opt = DF.place_deepfm_state(DF.train_params(model), mesh)
out["model_axis_deepfm"] = DF.train_step(
    model, fm_params, fm_opt, shard_batch(load("fields0"), mesh, batch_spec(mesh, 1)),
    shard_batch(load("labels0"), mesh, P(data_axes(mesh))), opt_cfg=OptConfig(**meta["opt"]),
    mesh=mesh)[2].item()
"""

# ranks 0-3 of the eight, a (4, 1) mesh, after the (2, 4) part
_FOUR = """
import dataclasses
from repro_torch.configs import LM_ARCHS, deepfm as DF, lm_cells as C
from repro_torch.core import prng
from repro_torch.data.pipeline import shard_batch
from repro_torch.dist.sharding import P, batch_spec, data_axes
from repro_torch.models import moe as M
from repro_torch.models import transformer as tf
from repro_torch.models.deepfm import DeepFM
from repro_torch.train import OptConfig
from repro_torch.train import tree as T

mesh = DeviceMesh("cpu", torch.arange(4).reshape(4, 1), mesh_dim_names=("data", "model"))
size = 4
drops, assign = [], M.assign_slots

def spy(ids, E, cap):
    # the global plan, and whether this rank's tokens ranked alone would keep
    # other slots
    plan = assign(ids, E, cap)
    n = ids.shape[0] // size
    own = assign(ids[rank * n:(rank + 1) * n], E, M.expert_capacity(n, cfg.moe))
    drops.append((1.0 - plan.keep.float().mean().item(),
                  bool((own.keep != plan.keep[rank * n:(rank + 1) * n]).any())))
    return plan

M.assign_slots = spy
for arch, factor in (meta["lm"].items() if rank < 4 else ()):
    cfg = LM_ARCHS[arch].SMOKE
    if factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))
    params, opt = C.place_lm_state(tf.init_lm(prng.key(0), cfg, device="cpu"), mesh)
    step = C.make_lm_train_step(cfg, OptConfig(**meta["opt"]), mesh=mesh)
    drops.clear()
    losses = []
    for i in range(meta["steps"]):
        tokens, targets = shard_batch((load(f"lm_tokens{i}"), load(f"lm_targets{i}")), mesh,
                                      batch_spec(mesh, 1))
        params, opt, loss, xent = step(params, opt, tokens, targets)
        losses.append([loss.item(), xent.item()])
    full = [x.full_tensor() for x in T.leaves((params, opt.m, opt.v))]
    if rank == 0:
        np.savez(os.path.join(data, f"lm_{arch}.npz"), *[x.numpy() for x in full])
    out[arch] = {"losses": losses, "drops": drops[:]}

if rank < 4:
    model = DeepFM(DF.SMOKE_CONFIG, seed=0, device="cpu")
    params, opt = DF.place_deepfm_state(DF.train_params(model), mesh)
    losses = []
    for i in range(meta["steps"]):
        fields = shard_batch(load(f"fields{i}"), mesh, batch_spec(mesh, 1))
        labels = shard_batch(load(f"labels{i}"), mesh, P(data_axes(mesh)))
        params, opt, loss = DF.train_step(model, params, opt, fields, labels,
                                          opt_cfg=OptConfig(**meta["opt"]), mesh=mesh)
        losses.append(loss.item())
    logits = DF.serve_step(model, fields, params=params, mesh=mesh)
    save(f"deepfm_logits.rank{rank}", logits)
    full = {k: v.full_tensor() for k, v in params.items()}
    if rank == 0:
        np.savez(os.path.join(data, "deepfm.npz"), **{k: v.numpy() for k, v in full.items()})
    out["deepfm"] = {"losses": losses}
"""


_END = """
json.dump(out, open(os.path.join(data, f"out.rank{rank}.json"), "w"))
dist.destroy_process_group()
"""


def _launch(script: str, ranks: int, data: str) -> list:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(ranks), data],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(ranks)]
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log[-4000:]
    return [json.load(open(os.path.join(data, f"out.rank{r}.json"))) for r in range(ranks)]


def _moe_weights():
    rng = np.random.default_rng(0)
    E, F, D = MOE["n_experts"], MOE["d_expert"], MOE_D
    w = {"router": rng.standard_normal((D, E)), "we1": rng.standard_normal((E, D, F)) * 0.1,
         "we3": rng.standard_normal((E, D, F)) * 0.1, "we2": rng.standard_normal((E, F, D)) * 0.1,
         "ws1": rng.standard_normal((D, F)) * 0.1, "ws3": rng.standard_normal((D, F)) * 0.1,
         "ws2": rng.standard_normal((F, D)) * 0.1}
    return ({k: v.astype(np.float32) for k, v in w.items()},
            rng.standard_normal((MOE_N, D)).astype(np.float32))


def _lm_batches(cfg):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        tok = rng.integers(0, cfg.vocab, LM_BATCH).astype(np.int32)
        tgt = np.roll(tok, -1, axis=1)
        tgt[rng.random(LM_BATCH) < 0.1] = -1        # ignored targets, uneven per rank
        out.append((tok, tgt))
    return out


def _deepfm_batches():
    rng = np.random.default_rng(3)
    return [(rng.integers(0, 32, (DEEPFM_BATCH, 39)).astype(np.int32),
             (rng.random(DEEPFM_BATCH) > 0.5).astype(np.float32)) for _ in range(STEPS)]


def _lm_cfg(arch):
    import dataclasses

    cfg = LM_ARCHS[arch].SMOKE
    factor = LM_CASES[arch]
    if factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))
    return cfg


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The one launch: (data dir, host arrays, the one-rank tree, each rank's
    outputs)."""
    data = str(tmp_path_factory.mktemp("ranks"))
    rng = np.random.default_rng(1)
    host = {"w": rng.standard_normal((64, 32)).astype(np.float32),
            "e": rng.standard_normal((16, 8, 4)).astype(np.float32),
            "b": np.arange(10, dtype=np.int32), "tokens": rng.integers(0, 99, (8, 6)).astype(np.int32)}
    for k, v in host.items():
        np.save(os.path.join(data, k + ".npy"), v)
    tree = {"w": torch.from_numpy(host["w"]), "b": torch.from_numpy(host["b"])}
    ckpt.save(os.path.join(data, "ckpt"), 0, tree)          # written on one rank
    weights, x = _moe_weights()
    for k, v in weights.items():
        np.save(os.path.join(data, "moe_" + k + ".npy"), v)
    np.save(os.path.join(data, "moe_x.npy"), x)
    for arch in LM_CASES:
        for i, (tok, tgt) in enumerate(_lm_batches(_lm_cfg(arch))):
            np.save(os.path.join(data, f"lm_tokens{i}.npy"), tok)   # same for every arch:
            np.save(os.path.join(data, f"lm_targets{i}.npy"), tgt)  # the vocabs are equal
    assert len({LM_ARCHS[a].SMOKE.vocab for a in LM_CASES}) == 1
    for i, (f, lab) in enumerate(_deepfm_batches()):
        np.save(os.path.join(data, f"fields{i}.npy"), f)
        np.save(os.path.join(data, f"labels{i}.npy"), lab)
    json.dump({"moe": MOE, "moe_leaves": sorted(weights), "lm": LM_CASES, "steps": STEPS,
               "opt": OPT}, open(os.path.join(data, "meta.json"), "w"))
    return data, host, tree, _launch(_EIGHT + _FOUR + _END, 8, data)





# --------------------------------------------------------------------------
# eight ranks on (2, 4)
# --------------------------------------------------------------------------

def _block(full: np.ndarray, spec_axes, coord) -> np.ndarray:
    """numpy's slice of `full` for mesh coordinate (d, m) of (2, 4):
    spec_axes gives each dim's entry ('data', 'model', 'flat' or None)."""
    d, m = coord
    idx = []
    for dim, entry in enumerate(spec_axes):
        n = full.shape[dim]
        k, i = {"data": (2, d), "model": (4, m), "flat": (8, d * 4 + m), None: (1, 0)}[entry]
        idx.append(slice(i * n // k, (i + 1) * n // k))
    return full[tuple(idx)]


@pytest.mark.parametrize("name, axes", [("w", ("data", "model")), ("e", (None, "flat")),
                                        ("b", (None,)), ("tokens", ("data", None))])
def test_blocks_are_numpy_slices(ranks, name, axes):
    data, host, _, outs = ranks
    for r, out in enumerate(outs):
        got = np.load(os.path.join(data, f"block_{name}.rank{r}.npy"))
        np.testing.assert_array_equal(got, _block(host[name], axes, out["coord"]),
                                      err_msg=f"rank {r}")
        if name != "tokens":
            assert out[f"full_{name}"], r


def test_reshard_checkpoint_grows_onto_eight_ranks(ranks):
    data, host, _, outs = ranks
    for r, out in enumerate(outs):
        for name, axes in (("w", ("data", "model")), ("b", (None,))):
            got = np.load(os.path.join(data, f"grown_{name}.rank{r}.npy"))
            np.testing.assert_array_equal(got, _block(host[name], axes, out["coord"]))
        assert out["grown_placements_w"] == ["S(0)", "S(1)"]
        assert out["grown_placements_b"] == ["R", "R"]


def test_every_rank_restores_right_after_a_placed_save(ranks):
    _, _, tree, outs = ranks
    for r, out in enumerate(outs):
        assert out["restored_after_save"] == {k: True for k in tree}, r


def test_reshard_checkpoint_shrinks_back_bit_equal(ranks):
    data, _, tree, _ = ranks
    assert ckpt.available_steps(os.path.join(data, "ckpt")) == [0, 1]
    back = ckpt.restore(os.path.join(data, "ckpt"), 1, device="cpu")
    assert sorted(back) == sorted(tree)
    for k in tree:
        assert back[k].dtype == tree[k].dtype and torch.equal(back[k], tree[k]), k


@functools.lru_cache(maxsize=1)
def _ref_moe_cached():
    return _ref_moe(*_moe_weights())


def _ref_moe(weights, x):
    """The reference's moe_ffn output and the gradient of its sum."""
    cfg = RefMoEConfig(**MOE)

    def total(p):
        out = ref_moe_ffn(p, jnp.asarray(x), cfg, "swiglu")[0]
        return out.sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        {k: jnp.asarray(v) for k, v in weights.items()})
    return np.asarray(out), {k: np.asarray(v) for k, v in grads.items()}


def test_moe_ffn_shardmap_output_equals_reference_moe_ffn(ranks):
    data, _, _, outs = ranks
    want, _ = _ref_moe_cached()
    n = MOE_N // 2
    for r, out in enumerate(outs):
        d = out["coord"][0]
        got = np.load(os.path.join(data, f"moe_out.rank{r}.npy"))
        np.testing.assert_allclose(got, want[d * n:(d + 1) * n], rtol=MOE_TOL, atol=MOE_TOL,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("leaf", ["router", "we1", "we3", "we2", "ws1", "ws3", "ws2"])
def test_moe_ffn_shardmap_gradient_equals_reference(ranks, leaf):
    """Experts sum over token shards, the router over expert ranks too, the
    shared experts count once over expert ranks."""
    data = ranks[0]
    _, want = _ref_moe_cached()
    got = np.load(os.path.join(data, f"moe_grad_{leaf}.npy"))
    scale = np.abs(want[leaf]).max()
    np.testing.assert_allclose(got, want[leaf], rtol=MOE_TOL, atol=MOE_TOL * scale)


@pytest.mark.parametrize("which", ["lm", "deepfm"])
def test_steps_refuse_a_model_axis(ranks, which):
    """No step refuses 'model' > 1 now: the LM step (qwen3 SMOKE, whose two
    KV heads do not split over four model ranks) and the DeepFM step on
    (2, 4) return the loss of the step without a mesh on every rank."""
    if which == "lm":
        cfg = LM_ARCHS["qwen3-0.6b"].SMOKE
        params = tf.init_lm(prng.key(0), cfg, device="cpu")
        tok, tgt = _lm_batches(cfg)[0]
        want = C.make_lm_train_step(cfg, OptConfig(**OPT))(
            params, adamw_init(params), torch.from_numpy(tok), torch.from_numpy(tgt))[2]
    else:
        model = DeepFM(DF.SMOKE_CONFIG, seed=0, device="cpu")
        params = DF.train_params(model)
        f, lab = _deepfm_batches()[0]
        want = DF.train_step(model, params, adamw_init(params), torch.from_numpy(f),
                             torch.from_numpy(lab), opt_cfg=OptConfig(**OPT))[2]
    for r, out in enumerate(ranks[3]):
        _close(out["model_axis_" + which], want.item(), f"{which} rank {r}")


# --------------------------------------------------------------------------
# four ranks on (4, 1) against the step without a mesh
# --------------------------------------------------------------------------

def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=TOL, atol=TOL,
                               err_msg=what)


@pytest.mark.parametrize("arch", sorted(LM_CASES))
def test_data_parallel_lm_step_equals_one_rank(ranks, arch):
    data, outs = ranks[0], ranks[3][:4]
    cfg = _lm_cfg(arch)
    params = tf.init_lm(prng.key(0), cfg, device="cpu")
    opt = adamw_init(params)
    step = C.make_lm_train_step(cfg, OptConfig(**OPT))
    losses = []
    for tok, tgt in _lm_batches(cfg):
        params, opt, loss, xent = step(params, opt, torch.from_numpy(tok), torch.from_numpy(tgt))
        losses.append([loss.item(), xent.item()])
    for r, out in enumerate(outs):
        _close(out[arch]["losses"], losses, f"{arch} rank {r} losses")
    got = np.load(os.path.join(data, f"lm_{arch}.npz"))
    want = T.leaves((params, opt.m, opt.v))
    assert len(got.files) == len(want)
    for i, w in enumerate(want):
        _close(got[f"arr_{i}"], w.numpy(), f"{arch} leaf {i}")


def test_data_parallel_moe_routes_the_global_batch(ranks):
    """mixtral at capacity factor 0.5: the global plan drops assignments, and
    a rank ranking its own tokens alone would keep other slots."""
    for r, out in enumerate(ranks[3][:4]):
        drops = out["mixtral-8x22b"]["drops"]
        assert drops and all(frac > 0 for frac, _ in drops), r
        assert any(differs for _, differs in drops), r


def test_data_parallel_deepfm_step_equals_one_rank(ranks):
    data, outs = ranks[0], ranks[3][:4]
    model = DeepFM(DF.SMOKE_CONFIG, seed=0, device="cpu")
    params = DF.train_params(model)
    opt = adamw_init(params)
    losses = []
    for f, lab in _deepfm_batches():
        params, opt, loss = DF.train_step(model, params, opt, torch.from_numpy(f),
                                          torch.from_numpy(lab), opt_cfg=OptConfig(**OPT))
        losses.append(loss.item())
    for r, out in enumerate(outs):
        _close(out["deepfm"]["losses"], losses, f"rank {r} losses")
    got = np.load(os.path.join(data, "deepfm.npz"))
    assert sorted(got.files) == sorted(params)
    for k, v in params.items():
        _close(got[k], v.numpy(), k)
    # serving through the placed tables: each rank's block of the logits
    logits = torch.func.functional_call(model, params, (torch.from_numpy(f),))
    n = DEEPFM_BATCH // 4
    for r in range(4):
        got_r = np.load(os.path.join(data, f"deepfm_logits.rank{r}.npy"))
        _close(got_r, logits[r * n:(r + 1) * n].detach().numpy(), f"logits rank {r}")
