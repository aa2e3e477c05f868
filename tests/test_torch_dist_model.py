"""The 'model' axis across gloo ranks on the CPU: four `python -c` processes,
one per rank, a `file://` rendezvous under the module's temporary
directory, one launch shared by the tests (a module fixture), forming a
(2, 2) and a (1, 4) ("data", "model") mesh over the same four ranks:

* the LM train step (`make_lm_train_step(mesh=)` over `place_lm_state`) on
  (2, 2) for the five SMOKE configs, mixtral at a capacity factor that
  drops assignments (the drop fraction checked nonzero) and with 3 experts
  (which do not split over two ranks: each runs its half of every
  expert's hidden units), deepseek with
  `fsdp=True`, and qwen3 with `fuse_qkv` and `fuse_gate` set; qwen3 on
  (1, 4), where its two KV heads do not split over four ranks (the
  attention's leaves gathered whole); each held after 2 steps to the step
  without a mesh in this process, every leaf of the parameters and both
  moments at rtol = atol = 1e-5 in f32 (the ranks sum the same terms in
  other orders);
* deepseek SMOKE's loss and every gradient on (2, 2) (gathered whole)
  held directly to the reference's `jax.value_and_grad(lm_loss)`, the
  weights carried by `lm_params_from_numpy`: the loss within 1e-5, each
  gradient within 1e-5 of its leaf's largest entry;
* `prefill_step(mesh=)` and 4 `serve_step(mesh=)` calls on (2, 2), the
  cache placed by `cache_specs`, for qwen3 (GQA), deepseek (MLA), mixtral
  (its window's ring wraps) and qwen3 placed with FSDP: each rank's
  logits against its sequences' logits without a mesh, 1e-5;
* DeepFM SMOKE on (2, 2) and (1, 4), and on (2, 2) with 1,250 rows (split
  over 'model' alone) and 1,249 (whole): 2 train steps (every parameter
  and moment), serve logits and retrieval scores (the item field's rows
  all on one rank), against the steps without a mesh, 1e-5.
"""
import dataclasses
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

from _lm_parity import configs as lm_configs
from repro.models import transformer as rtf
from repro_torch.configs import LM_ARCHS
from repro_torch.core import prng
from repro_torch.configs import deepfm as DF
from repro_torch.configs import lm_cells as C
from repro_torch.models import transformer as tf
from repro_torch.models.deepfm import DeepFM
from repro_torch.train import OptConfig, adamw_init
from repro_torch.train import tree as T

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = 1e-5
STEPS = 2
OPT = dict(total_steps=100)
LM_BATCH = (4, 32)           # global (B, S): 2 sequences a data rank on (2, 2)
# case -> (arch, config changes, mesh, fsdp)
LM_CASES = {
    "qwen3-0.6b": ("qwen3-0.6b", {}, "22", False),
    "qwen1.5-0.5b": ("qwen1.5-0.5b", {}, "22", False),
    "mixtral-8x22b": ("mixtral-8x22b", {}, "22", False),
    "deepseek-v3-671b": ("deepseek-v3-671b", {}, "22", False),
    "nemotron-4-340b": ("nemotron-4-340b", {}, "22", False),
    "mixtral-drops": ("mixtral-8x22b", {"capacity_factor": 0.5}, "22", False),
    "mixtral-3-experts": ("mixtral-8x22b", {"n_experts": 3}, "22", False),
    "deepseek-fsdp": ("deepseek-v3-671b", {}, "22", True),
    "qwen3-fused": ("qwen3-0.6b", {"fuse_qkv": True, "fuse_gate": True}, "22", False),
    "qwen3-cut-heads": ("qwen3-0.6b", {}, "14", False),
}
# case -> (arch, fsdp, mesh, prompt): 14 tokens keep the stream whole (14 % 8),
# 16 take the sequence-parallel prefill; nemotron on (1, 4), whose two KV
# heads do not split, computes its one query head a rank against a cache
# of both KV heads
SERVE_CASES = {"qwen3-0.6b": ("qwen3-0.6b", False, "22", 14),
               "deepseek-v3-671b": ("deepseek-v3-671b", False, "22", 14),
               "mixtral-8x22b": ("mixtral-8x22b", False, "22", 14),
               "qwen3-fsdp": ("qwen3-0.6b", True, "22", 14),
               "qwen3-seq": ("qwen3-0.6b", False, "22", 16),
               "deepseek-seq": ("deepseek-v3-671b", False, "22", 16),
               "mixtral-seq": ("mixtral-8x22b", False, "22", 16),
               "nemotron-cut-heads": ("nemotron-4-340b", False, "14", 16)}
SERVE = dict(batch=4, max_len=20, steps=4)   # mixtral's 16-slot ring wraps
# case -> (mesh, the last field's rows): SMOKE's 1,248 rows split over all four
# ranks; 1,250 over 'model' alone (they do not split four ways); 1,249 whole
DEEPFM_CASES = {"22": ("22", 32), "14": ("14", 32), "22-model-rows": ("22", 34),
                "22-whole": ("22", 33)}
DEEPFM_BATCH = 64
DEEPFM_CANDIDATES = 64
ITEM_FIELD = 13              # rows 416-447 of 1,248: all on flat rank 1 of 4


def _cfg(arch, changes):
    cfg = LM_ARCHS[arch].SMOKE
    moe = {k: changes[k] for k in ("capacity_factor", "n_experts") if k in changes}
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return dataclasses.replace(cfg, **{k: v for k, v in changes.items() if k not in moe})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The steps held here are SMOKE-sized: one intra-op thread each, as the
    ranks run, so that they do not wait on a pool of threads that the
    other test workers crowd."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_group_left():
    """Each test starts and ends with no default process group."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


_SCRIPT = """
import dataclasses, json, os, sys, time
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
def save_blocks(name, leaves):
    # this rank's block of each DTensor leaf (no collective: the test
    # process puts the blocks together by their placements)
    np.savez(os.path.join(data, f"{name}.rank{rank}.npz"),
             *[x.to_local().detach().numpy() for x in leaves])
    return {"placements": [[str(q) for q in x.placements] for x in leaves],
            "shapes": [list(x.shape) for x in leaves]}

from repro_torch.configs import LM_ARCHS, deepfm as DF, lm_cells as C
from repro_torch.core import prng
from repro_torch.data.pipeline import shard_batch
from repro_torch.dist import P, batch_spec, data_axes
from repro_torch.dist.collectives import data_group
from repro_torch.models import transformer as tf
from repro_torch.models.deepfm import DeepFM
from repro_torch.train import OptConfig
from repro_torch.train import tree as T
from repro_torch.train.optimizer import partial_grads

meshes = {k: DeviceMesh("cpu", torch.arange(4).reshape(s), mesh_dim_names=("data", "model"))
          for k, s in (("22", (2, 2)), ("14", (1, 4)))}

def config(arch, changes):
    cfg = LM_ARCHS[arch].SMOKE
    moe = {k: changes[k] for k in ("capacity_factor", "n_experts") if k in changes}
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return dataclasses.replace(cfg, **{k: v for k, v in changes.items() if k not in moe})

drops, moe_ffn = [], tf.moe_ffn
def spy(*a, **k):
    y, metrics = moe_ffn(*a, **k)
    drops.append(float(metrics.drop_frac))
    return y, metrics
tf.moe_ffn = spy

# the bytes autograd saves at each layer boundary (a checkpointed layer's
# tensor inputs: the carry, and the positions), the heads each attention
# computes, and whether the layers ran sequence-parallel
carry, heads, seqs = [], set(), []
checkpointed, flash, decode_attention, seq_rule = (tf._checkpointed, tf.flash_attention,
                                                   tf.decode_attention, tf._seq)
def counted(policy, fn, *args):
    saved = []
    def pack(t):
        saved.append(t)
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = checkpointed(policy, fn, *args)
    carry.append([[list(t.shape), t.element_size()] for t in saved if t.is_floating_point()])
    return out
def flash_spy(q, k, v, **kw):
    heads.add((q.shape[2], k.shape[2]))
    return flash(q, k, v, **kw)
def decode_spy(q, k, v, valid):
    heads.add((q.shape[1], k.shape[2]))
    return decode_attention(q, k, v, valid)
def seq_spy(tp, S):
    seqs.append(seq_rule(tp, S))
    return seqs[-1]
tf._checkpointed, tf.flash_attention, tf.decode_attention, tf._seq = (
    counted, flash_spy, decode_spy, seq_spy)

# the train steps
for name, (arch, changes, m, fsdp) in meta["lm"].items():
    cfg, mesh = config(arch, changes), meshes[m]
    params, opt = C.place_lm_state(tf.init_lm(prng.key(0), cfg, device="cpu"), mesh,
                                   fsdp=fsdp)
    step = C.make_lm_train_step(cfg, OptConfig(**meta["opt"]), mesh=mesh, fsdp=fsdp)
    drops.clear(), carry.clear(), heads.clear(), seqs.clear()
    losses = []
    for i in range(meta["steps"]):
        batch = shard_batch((load(f"lm_tokens{i}"), load(f"lm_targets{i}")), mesh,
                            batch_spec(mesh, 1))
        params, opt, loss, xent = step(params, opt, *batch)
        losses.append([loss.item(), xent.item()])
    out[name] = {"losses": losses, "drops": drops[:], "coord": list(mesh.get_coordinate()),
                 "mesh": list(mesh.shape), "carry": carry[:], "heads": sorted(heads),
                 "seq": seqs[:],
                 **save_blocks(f"lm_{name}", T.leaves((params, opt.m, opt.v)))}

# prefill and decode under cache_specs
s = meta["serve"]
for name, (arch, fsdp, m, prompt) in meta["serve_cases"].items():
    cfg, mesh = config(arch, {}), meshes[m]
    prompts = load(f"prompts{prompt}")
    params, _ = C.place_lm_state(tf.init_lm(prng.key(0), cfg, device="cpu"), mesh,
                                 fsdp=fsdp)
    heads.clear(), seqs.clear()
    logits, cache = C.prefill_step(params, cfg, shard_batch(prompts, mesh, batch_spec(mesh, 1)),
                                   s["max_len"], mesh=mesh, fsdp=fsdp)
    steps = [logits]
    dec = load(f"decode_tokens{prompt}")
    for i in range(s["steps"]):
        toks = shard_batch(dec[i], mesh, P(data_axes(mesh)))
        logits, cache = C.serve_step(params, cfg, cache, toks, mesh=mesh, fsdp=fsdp)
        steps.append(logits)
    save(f"serve_{name}.rank{rank}", torch.stack(steps))
    out["serve_" + name] = {"placements": {k: [str(q) for q in v.placements]
                                           for k, v in cache.data.items()},
                            "pos": int(cache.pos), "coord": list(mesh.get_coordinate()),
                            "heads": sorted(heads), "seq": seqs[:],
                            "cache_heads": next(iter(cache.data.values())).to_local().shape[-2]}

# DeepFM on both meshes, and on (2, 2) with tables that do not split four ways
for name, (m, last) in meta["deepfm"].items():
    mesh = meshes[m]
    cfg = dataclasses.replace(DF.SMOKE_CONFIG, field_vocabs=(32,) * 38 + (last,))
    model = DeepFM(cfg, seed=0, device="cpu")
    params, opt = DF.place_deepfm_state(DF.train_params(model), mesh)
    losses = []
    for i in range(meta["steps"]):
        fields = shard_batch(load(f"fields{i}"), mesh, batch_spec(mesh, 1))
        labels = shard_batch(load(f"labels{i}"), mesh, P(data_axes(mesh)))
        params, opt, loss = DF.train_step(model, params, opt, fields, labels,
                                          opt_cfg=OptConfig(**meta["opt"]), mesh=mesh)
        losses.append(loss.item())
    save(f"deepfm{name}_logits.rank{rank}",
         DF.serve_step(model, fields, params=params, mesh=mesh))
    flat = tuple(mesh.mesh_dim_names)
    cands = shard_batch(load("cands"), mesh, P(flat))
    save(f"deepfm{name}_scores.rank{rank}",
         DF.retrieval_step(model, torch.from_numpy(load("user")), cands, meta["item_field"],
                           params=params, mesh=mesh))
    names = list(params) + ["m/" + k for k in opt.m] + ["v/" + k for k in opt.v]
    out["deepfm" + name] = {"losses": losses, "coord": list(mesh.get_coordinate()),
                            "mesh": list(mesh.shape), "rows": params["embed"].to_local().shape[0],
                            "names": names,
                            **save_blocks(f"deepfm{name}", list(params.values())
                                          + list(opt.m.values()) + list(opt.v.values()))}

# deepseek's loss and gradients on (2, 2), the reference's weights
# (written by the test process while the ranks ran the steps above)
while not os.path.exists(os.path.join(data, "ref_weights.npz")):
    time.sleep(0.05)
cfg, mesh = config("deepseek-v3-671b", {}), meshes["22"]
ref = np.load(os.path.join(data, "ref_weights.npz"))
tree = {}
for key in ref.files:
    node = tree
    *head, last = key.split("/")
    for h in head:
        node = node.setdefault(h, {})
    node[last] = ref[key]
whole = tf.lm_params_from_numpy(tree, cfg, device="cpu")
placed, _ = C.place_lm_state(whole, mesh)
dp, tp = data_group(mesh, "the gradient check")
tok, tgt = shard_batch((load("lm_tokens0"), load("lm_targets0")), mesh, batch_spec(mesh, 1))
loss, _, grads = C.lm_loss_and_grads(T.tree_map(lambda x: x.to_local(), placed), cfg,
                                     tok.to_local(), tgt.to_local(), dp=dp, tp=tp)
grads = partial_grads(grads, placed, mesh, set(data_axes(mesh)))
full = [g.full_tensor() for g in T.leaves(grads)]
if rank == 0:
    np.savez(os.path.join(data, "grads.npz"), *[g.numpy() for g in full])
out["grad_loss"] = dp.all_reduce(loss).item()

json.dump(out, open(os.path.join(data, f"out.rank{rank}.json"), "w"))
dist.destroy_process_group()
"""


def _start(script: str, ranks: int, data: str) -> list:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-c", script, str(r), str(ranks), data],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for r in range(ranks)]


def _outputs(procs: list, data: str) -> list:
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log[-4000:]
    return [json.load(open(os.path.join(data, f"out.rank{r}.json")))
            for r in range(len(procs))]


def _lm_batches():
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        tok = rng.integers(0, 128, LM_BATCH).astype(np.int32)
        tgt = np.roll(tok, -1, axis=1)
        tgt[rng.random(LM_BATCH) < 0.1] = -1        # ignored targets, uneven per rank
        out.append((tok, tgt))
    return out


def _serve_inputs(prompt: int):
    rng = np.random.default_rng(5)
    return (rng.integers(0, 128, (SERVE["batch"], prompt)).astype(np.int32),
            rng.integers(0, 128, (SERVE["steps"], SERVE["batch"])).astype(np.int32))


def _deepfm_inputs():
    rng = np.random.default_rng(3)
    batches = [(rng.integers(0, 32, (DEEPFM_BATCH, 39)).astype(np.int32),
                (rng.random(DEEPFM_BATCH) > 0.5).astype(np.float32)) for _ in range(STEPS)]
    return batches, rng.integers(0, 32, 39).astype(np.int32), rng.integers(
        0, 32, DEEPFM_CANDIDATES).astype(np.int32)


def _ref_deepseek():
    """The reference's deepseek SMOKE config and weights (jitted `init_lm`)."""
    ref_cfg, _ = lm_configs("deepseek-v3-671b")
    return ref_cfg, jax.jit(rtf.init_lm, static_argnums=1)(jax.random.key(0), ref_cfg)


def _ref_loss_and_grads(ref_cfg, ref_params):
    """The reference's `jax.value_and_grad(lm_loss)` on batch 0 (jitted):
    (loss, every leaf's gradient as numpy, in tree order)."""
    tok, tgt = _lm_batches()[0]
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: rtf.lm_loss(p, ref_cfg, jnp.asarray(tok), jnp.asarray(tgt)), has_aux=True))(
        ref_params)
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The one launch: (data dir, the reference's deepseek loss and
    gradients, made while the ranks run, each rank's outputs)."""
    data = str(tmp_path_factory.mktemp("ranks"))
    for i, (tok, tgt) in enumerate(_lm_batches()):
        np.save(os.path.join(data, f"lm_tokens{i}.npy"), tok)
        np.save(os.path.join(data, f"lm_targets{i}.npy"), tgt)
    assert {LM_ARCHS[a].SMOKE.vocab for a, *_ in LM_CASES.values()} == {128}
    for prompt in {c[3] for c in SERVE_CASES.values()}:
        prompts, dec = _serve_inputs(prompt)
        np.save(os.path.join(data, f"prompts{prompt}.npy"), prompts)
        np.save(os.path.join(data, f"decode_tokens{prompt}.npy"), dec)
    batches, user, cands = _deepfm_inputs()
    for i, (f, lab) in enumerate(batches):
        np.save(os.path.join(data, f"fields{i}.npy"), f)
        np.save(os.path.join(data, f"labels{i}.npy"), lab)
    np.save(os.path.join(data, "user.npy"), user)
    np.save(os.path.join(data, "cands.npy"), cands)
    json.dump({"lm": LM_CASES, "steps": STEPS, "opt": OPT, "serve": SERVE,
               "serve_cases": SERVE_CASES, "deepfm": DEEPFM_CASES, "item_field": ITEM_FIELD},
              open(os.path.join(data, "meta.json"), "w"))
    procs = _start(_SCRIPT, 4, data)
    try:
        # the reference's weights, handed over as the ranks reach their
        # gradient check (renamed into place whole), then its loss and
        # gradients
        ref_cfg, ref_params = _ref_deepseek()
        np.savez(os.path.join(data, "ref_weights.tmp.npz"),
                 **{"/".join(str(k.key) for k in path): np.asarray(leaf)
                    for path, leaf in jax.tree_util.tree_leaves_with_path(ref_params)})
        os.replace(os.path.join(data, "ref_weights.tmp.npz"),
                   os.path.join(data, "ref_weights.npz"))
        ref = _ref_loss_and_grads(ref_cfg, ref_params)
        return data, ref, _outputs(procs, data)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _whole(data: str, file: str, key: str, outs: list) -> list:
    """Each leaf whole, put together from every rank's block (`save_blocks`
    wrote them to `file`, their placements under `key`): a dim sharded
    over mesh dims is cut in torch.chunk's sizes, the mesh dims taken in
    order, as `dist.sharding.Sharding.block` cuts it."""
    info = [out[key] for out in outs]
    blocks = [np.load(os.path.join(data, f"{file}.rank{r}.npz")) for r in range(len(outs))]
    leaves = []
    for i, (pl, shape) in enumerate(zip(info[0]["placements"], info[0]["shapes"])):
        full = np.zeros(shape, dtype=blocks[0][f"arr_{i}"].dtype)
        for r, rank_info in enumerate(info):
            lo, n = [0] * len(shape), list(shape)
            for j, q in enumerate(pl):
                if q.startswith("S("):
                    d = int(q[2:-1])
                    size = -(-n[d] // rank_info["mesh"][j])
                    c = rank_info["coord"][j]
                    lo[d] += min(c * size, n[d])
                    n[d] = max(min(size, n[d] - c * size), 0)
            full[tuple(slice(a, a + b) for a, b in zip(lo, n))] = blocks[r][f"arr_{i}"]
        leaves.append(full)
    return leaves


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=TOL, atol=TOL,
                               err_msg=what)


# --------------------------------------------------------------------------
# the LM train step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_lm_step_on_a_model_axis_equals_one_rank(ranks, case):
    data, _, outs = ranks
    arch, changes, _, _ = LM_CASES[case]
    cfg = _cfg(arch, changes)
    params = tf.init_lm(prng.key(0), cfg, device="cpu")
    opt = adamw_init(params)
    step = C.make_lm_train_step(cfg, OptConfig(**OPT))
    losses = []
    for tok, tgt in _lm_batches():
        params, opt, loss, xent = step(params, opt, torch.from_numpy(tok), torch.from_numpy(tgt))
        losses.append([loss.item(), xent.item()])
    for r, out in enumerate(outs):
        _close(out[case]["losses"], losses, f"{case} rank {r} losses")
    got = _whole(data, f"lm_{case}", case, outs)
    want = T.leaves((params, opt.m, opt.v))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w.numpy(), f"{case} leaf {i}")


@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_the_layer_boundary_carry_is_this_ranks_block_of_S(ranks, case):
    """Under remat "full" autograd saves one float tensor at each layer
    boundary, the layer's input: B_local x S/m x D, the reference's
    P(dp, "model", None) carry (`_make_layer_fn`), on (2, 2) and (1, 4),
    every layer of both steps."""
    arch, changes, mesh, _ = LM_CASES[case]
    cfg = _cfg(arch, changes)
    B, S = LM_BATCH
    n_data, n_model = (2, 2) if mesh == "22" else (1, 4)
    want = [[[B // n_data, S // n_model, cfg.d_model], 4]]
    for out in ranks[2]:
        assert out[case]["seq"] == [True] * STEPS
        assert out[case]["carry"] == [want] * (cfg.n_layers * STEPS), out[case]["carry"]


def test_query_heads_split_where_the_kv_heads_do_not(ranks):
    """qwen3 SMOKE on (1, 4): 4 query heads, 2 KV heads.  Each rank's
    attention holds H/m = 1 query head and the 1 KV head it reads (ranks
    0-1 KV head 0, ranks 2-3 KV head 1); its loss and every leaf equal one
    rank's (`test_lm_step_on_a_model_axis_equals_one_rank`)."""
    for out in ranks[2]:
        assert out["qwen3-cut-heads"]["heads"] == [[1, 1]]


def test_lm_step_on_a_model_axis_drops_as_one_rank(ranks):
    """mixtral at capacity factor 0.5: every MoE layer of every step drops
    assignments on every rank, the same fraction on every rank."""
    outs = ranks[2]
    fracs = [out["mixtral-drops"]["drops"] for out in outs]
    assert fracs[0] and all(f > 0 for f in fracs[0])
    assert all(f == fracs[0] for f in fracs)


def test_deepseek_gradients_on_a_model_axis_equal_the_reference(ranks):
    data, (loss, want), outs = ranks
    for r, out in enumerate(outs):
        _close(out["grad_loss"], loss, f"rank {r} loss")
    got = np.load(os.path.join(data, "grads.npz"))
    assert len(got.files) == len(want)
    for i, w in enumerate(want):
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[f"arr_{i}"] - w).max())
        assert err <= TOL * scale, f"gradient leaf {i}: {err:.3e} > {TOL} x {scale:.3e}"


# --------------------------------------------------------------------------
# prefill and decode under cache_specs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_serving_on_a_model_axis_equals_one_rank(ranks, case):
    data, _, outs = ranks
    arch, _, mesh, prompt = SERVE_CASES[case]
    cfg = LM_ARCHS[arch].SMOKE
    params = tf.init_lm(prng.key(0), cfg, device="cpu")
    prompts, dec = _serve_inputs(prompt)
    logits, cache = C.prefill_step(params, cfg, torch.from_numpy(prompts), SERVE["max_len"])
    want = [logits]
    for i in range(SERVE["steps"]):
        logits, cache = C.serve_step(params, cfg, cache, torch.from_numpy(dec[i]))
        want.append(logits)
    want = torch.stack(want).numpy()
    n_data, n_model = (2, 2) if mesh == "22" else (1, 4)
    n = SERVE["batch"] // n_data
    # MLA's latents and KV heads that do not split stay whole
    heads = "S(3)" if cfg.mla is None and cfg.n_kv_heads % n_model == 0 else "R"
    for r, out in enumerate(outs):
        d = out["serve_" + case]["coord"][0]
        got = np.load(os.path.join(data, f"serve_{case}.rank{r}.npy"))
        _close(got, want[:, d * n:(d + 1) * n], f"{case} rank {r} logits")
        assert out["serve_" + case]["pos"] == prompt + SERVE["steps"]
        for k, pl in out["serve_" + case]["placements"].items():
            assert pl == ["S(1)", heads], (k, pl)


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_prefill_is_sequence_parallel_where_the_prompt_splits(ranks, case):
    """Prefill runs its layers sequence-parallel where S % 8 == 0 and S
    splits over the model ranks (the reference's rule): a prompt of 16
    tokens does, one of 14 keeps the residual stream whole."""
    _, _, mesh, prompt = SERVE_CASES[case]
    for out in ranks[2]:
        assert out["serve_" + case]["seq"] == [prompt % 8 == 0], out["serve_" + case]["seq"]


def test_decode_where_the_kv_heads_do_not_split_reads_the_whole_cache(ranks):
    """nemotron SMOKE on (1, 4): 4 query heads split one a rank, its 2 KV
    heads do not.  Each rank writes both KV heads into its cache (whole,
    replicated over 'model', as the reference's cache_specs places it) and
    its prefill and decode attention read the one KV head its query head
    reads; the logits equal one rank's
    (`test_serving_on_a_model_axis_equals_one_rank`)."""
    for out in ranks[2]:
        assert out["serve_nemotron-cut-heads"]["heads"] == [[1, 1]]
        assert out["serve_nemotron-cut-heads"]["cache_heads"] == 2


# --------------------------------------------------------------------------
# DeepFM over (data, model)
# --------------------------------------------------------------------------

def _deepfm_one_rank(last: int):
    cfg = dataclasses.replace(DF.SMOKE_CONFIG, field_vocabs=(32,) * 38 + (last,))
    model = DeepFM(cfg, seed=0, device="cpu")
    params = DF.train_params(model)
    opt = adamw_init(params)
    batches, user, cands = _deepfm_inputs()
    losses = []
    for f, lab in batches:
        params, opt, loss = DF.train_step(model, params, opt, torch.from_numpy(f),
                                          torch.from_numpy(lab), opt_cfg=OptConfig(**OPT))
        losses.append(loss.item())
    with torch.no_grad():
        logits = torch.func.functional_call(model, params, (torch.from_numpy(batches[-1][0]),))
        model.load_state_dict(params, strict=False)
        scores = model.retrieval_score(torch.from_numpy(user), torch.from_numpy(cands),
                                       ITEM_FIELD)
    return params, opt, losses, logits.numpy(), scores.numpy()


@pytest.mark.parametrize("case", sorted(DEEPFM_CASES))
def test_deepfm_on_a_model_axis_equals_one_rank(ranks, case):
    data, _, outs = ranks
    mesh, last = DEEPFM_CASES[case]
    params, opt, losses, logits, scores = _deepfm_one_rank(last)
    rows = {32: 1248 // 4, 34: 1250 // 2, 33: 1249}[last]     # the rank's rows of the tables
    for r, out in enumerate(outs):
        _close(out["deepfm" + case]["losses"], losses, f"rank {r} losses")
        assert out["deepfm" + case]["rows"] == rows
    got = dict(zip(outs[0]["deepfm" + case]["names"], _whole(data, "deepfm" + case, "deepfm" + case, outs)))
    want = dict(params)
    want.update({"m/" + k: v for k, v in opt.m.items()})
    want.update({"v/" + k: v for k, v in opt.v.items()})
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        _close(got[k], v.numpy(), k)
    n_data = 2 if mesh == "22" else 1
    for r, out in enumerate(outs):
        d = out["deepfm" + case]["coord"][0]
        n = DEEPFM_BATCH // n_data
        _close(np.load(os.path.join(data, f"deepfm{case}_logits.rank{r}.npy")),
               logits[d * n:(d + 1) * n], f"logits rank {r}")
        n = DEEPFM_CANDIDATES // 4
        _close(np.load(os.path.join(data, f"deepfm{case}_scores.rank{r}.npy")),
               scores[r * n:(r + 1) * n], f"scores rank {r}")
