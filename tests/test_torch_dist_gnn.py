"""The full-graph GNN step with the graph split over gloo ranks on the CPU
(`dist.graph`, `gnn_cells.full_graph_step(split=)`, the `ogb_products`
cell's placement): three worlds of 2, 3 and 4 `python -c` ranks, launched
together once for the module (a module fixture), each with a `file://`
rendezvous under the module's temporary directory:

* the placed step on a (2, 1), a (3, 1) (unequal vertex blocks: 17, 16
  and 17 of 50) and a (4, 1) mesh, and on (2, 2), which must give what
  (4, 1) gives, for gin-tu, pna, egnn and mace at ogb_products' d_feat of
  100 and its 47 classes (each arch's own widths), held after 2 steps to
  the step without a split in this process: every rank's loss, both
  steps' gradients (summed over the ranks), the parameters, m and v;
* the same on a graph with a rank that owns no edge, vertices with no
  in-edge, masked input edges and shards that `partition_edges` pads;
* the step without a split, and the placed step's loss, against the
  reference's own `_full_graph_cell(ref_a, "ogb_products")` step (jitted
  on a one-device mesh, the weights drawn by the reference's `init` and
  carried by `gnn_params_from_numpy`);
* minibatch_lg's step on (2, 1), (4, 1) and (2, 2) given the key: each
  rank's draws are its data block's rows of the reference cell's draw
  for the whole batch.

pna and egnn run in f64 in both packages, as `chip_smoke.py`'s
GNN_CPU_F64 does (their f32 gradients are ill-conditioned); gin-tu and
mace in f32.  In both packages the cross-entropy runs in f32 (`_xent`
casts the logits) and the AdamW moments are f32, whatever the model's
dtype.  Tolerances, against the step without a split (the ranks sum the
same terms in other orders): the loss within 1e-6 relative (f32 sums of
the vertices' cross-entropy; up to 3.4e-7 seen); each gradient leaf, m and
v within 1e-5 of their largest for gin-tu and mace (up to 1.3e-6 seen) and
1e-4 for pna and egnn, tests/test_torch_gnn.py's f64 tolerance (v as
√v, the gradient's scale, since v holds its squares; up to
2.9e-5 seen, PNA on the edge-case graph: where a vertex has one in-edge
its std is sqrt(0 + 1e-8), whose gradient multiplies the f32
cross-entropy's last-bit differences by 5,000); a parameter whose
gradient is at least 1e-3 of its leaf's largest at both steps within
1e-3 · (lr₁ + lr₂) plus two f32 ulps, and every other one within
2 · (lr₁ + lr₂) plus two ulps (AdamW's normalised step of a gradient
entry near 0 can take either sign).  Against the reference:
tests/test_torch_gnn.py's tolerances (the loss 1e-5 relative, m and √v
1e-4 of their largest, the parameters by the same rule at one step; an
EGNN bias of one entry whose gradient cancels to 1e-5 of the others' sits
5.7e-5 from the reference's, where the two f32 cross-entropies round
apart).
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from repro.configs import egnn as ref_egnn_cfg
from repro.configs import gin_tu as ref_gin_cfg
from repro.configs import gnn_cells as ref_cells
from repro.configs import mace as ref_mace_cfg
from repro.configs import pna as ref_pna_cfg
from repro.train import optimizer as RO
from repro_torch.configs import GNN_ARCHS
from repro_torch.configs import gnn_cells as C
from repro_torch.core import prng
from repro_torch.dist.graph import split_edges, split_graph
from repro_torch.dist.lookup import TableSplit, block_rows, row_block
from repro_torch.graphs.generators import erdos_renyi
from repro_torch.graphs.partition import partition_edges, partition_rows
from repro_torch.models import gnn as G
from repro_torch.train import optimizer as O

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ("gin-tu", "pna", "egnn", "mace")
F64 = ("pna", "egnn")
REF_ARCHS = {"gin-tu": ref_gin_cfg.GNN, "pna": ref_pna_cfg.GNN, "egnn": ref_egnn_cfg.GNN,
             "mace": ref_mace_cfg.GNN}
SHAPE = ref_cells.GNN_SHAPES["ogb_products"]
D_FEAT, N_OUT = SHAPE["d_feat"], SHAPE["n_out"]
STEPS = 2
LOSS_TOL = 1e-6
GRAD_TOL = {"gin-tu": 1e-5, "pna": 1e-4, "egnn": 1e-4, "mace": 1e-5}
# world size -> [(graph, mesh shape)]
WORLDS = {2: [("main", (2, 1))], 3: [("main", (3, 1))],
          4: [("main", (4, 1)), ("main", (2, 2)), ("edges", (4, 1))]}
MAIN_N, MAIN_DEG = 50, 6.0
EDGES_N = 40                      # four blocks of 10; the last gets no edge
# minibatch_lg's tables split over the flat mesh: world size -> meshes
MINI_MESHES = {2: [(2, 1)], 4: [(4, 1), (2, 2)]}
MINI_ARCHS = ("gin-tu", "egnn")   # f32 rows summed as int32, f64 rows as int64
MINI_CASES = ("mixed", "one_block")
MINI_N, MINI_B, MINI_FANOUT = 50, 8, (3, 2)   # 50 rows: blocks of 25, 17 and 13 (padded)
MINI_KEY = 31                     # the step from a key draws at the cell's own fanout
TAKE_KINDS = ("one_block", "every_block")


def _main_graph():
    g = erdos_renyi(MAIN_N, avg_deg=MAIN_DEG, seed=1, device="cpu")
    return g.senders.numpy(), g.receivers.numpy(), g.edge_mask.numpy()


def _edges_graph():
    """Directed half-edges on 40 vertices: none into [30, 40) (rank 3 of 4
    owns no edge, yet its vertices send), none into 5 or 17, and a few
    masked edges (no self-loops: a masked self-loop makes EGNN's gradient
    non-finite, the reference's behaviour and not what this case checks)."""
    rng = np.random.default_rng(2)
    s = rng.integers(0, EDGES_N, 150)
    r = rng.integers(0, 30, 150)
    keep = (s != r) & (r != 5) & (r != 17)
    s, r = s[keep].astype(np.int32), r[keep].astype(np.int32)
    mask = rng.random(s.shape[0]) > 0.1
    return s, r, mask


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, D_FEAT)).astype(np.float32),
            rng.standard_normal((n, 3)).astype(np.float32),
            rng.integers(0, N_OUT, n).astype(np.int32))


def _graphs():
    out = {}
    for name, edges, n in (("main", _main_graph(), MAIN_N), ("edges", _edges_graph(), EDGES_N)):
        s, r, mask = edges
        feats, coords, labels = _rows(n, seed=len(name))
        out[name] = dict(senders=s, receivers=r, mask=mask, feats=feats, coords=coords,
                         labels=labels)
    return out


def _dtype(arch):
    return np.float64 if arch in F64 else np.float32


def _mini_inputs(case):
    """A minibatch_lg batch on a CSR of MINI_N vertices (degrees 0-5: some
    vertices have none), features of ogb_products' width with a fifth of
    their entries -0.0, MINI_B seeds and their draws at MINI_FANOUT.
    "mixed": seeds over every vertex; "one_block": every seed in [0, 13),
    the first block on 4 ranks (and inside the first on 2)."""
    from repro_torch.graphs.sampler import DRAW_HIGH

    rng = np.random.default_rng(7 if case == "mixed" else 8)
    deg = rng.integers(0, 6, MINI_N)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    feats, coords, labels = _rows(MINI_N, seed=9)
    feats[rng.random(feats.shape) < 0.2] = -0.0
    pool = 13 if case == "one_block" else MINI_N
    f1, f2 = MINI_FANOUT
    return dict(indptr=indptr, indices=rng.integers(0, MINI_N, int(indptr[-1])).astype(np.int32),
                feats=feats, coords=coords, labels=labels,
                seeds=rng.choice(pool, MINI_B, replace=False).astype(np.int32),
                u1=rng.integers(0, DRAW_HIGH, (MINI_B, f1)).astype(np.int32),
                u2=rng.integers(0, DRAW_HIGH, (MINI_B, f1, f2)).astype(np.int32))


def _mini_key_draws():
    """The reference cell's draws under key(MINI_KEY) for the whole
    batch (its `k1, k2 = split(key)`, at minibatch_lg's fanout)."""
    k1, k2 = jax.random.split(jax.random.key(MINI_KEY))
    f1, f2 = ref_cells.GNN_SHAPES["minibatch_lg"]["fanout"]
    hi = np.iinfo(np.int32).max
    return dict(u1=np.asarray(jax.random.randint(k1, (MINI_B, f1), 0, hi, dtype=np.int32)),
                u2=np.asarray(jax.random.randint(k2, (MINI_B, f1, f2), 0, hi, dtype=np.int32)))


def _take_inputs():
    """Tables of MINI_N rows for `TableSplit.take` (f32 with -0.0 and a NaN
    of a set payload, f64 with -0.0, int32, bool) and each world's ids, a
    row per rank: "one_block" every id in the second block, "every_block"
    every row once and 20 more."""
    rng = np.random.default_rng(10)
    f32 = rng.standard_normal((MINI_N, 7)).astype(np.float32)
    f32[::4, 1] = -0.0
    f32.view(np.uint32)[3, 2] = 0x7FC12345
    f64 = rng.standard_normal((MINI_N, 3))
    f64[1::5, 0] = -0.0
    out = dict(f32=f32, f64=f64, i32=rng.integers(-9, 9, MINI_N).astype(np.int32),
               mask=rng.random(MINI_N) < 0.5)
    for size in WORLDS:
        blk = -(-MINI_N // size)
        lo, hi = blk, min(2 * blk, MINI_N)
        out[f"ids_one_block_{size}"] = rng.integers(lo, hi, (size, 24)).astype(np.int32)
        out[f"ids_every_block_{size}"] = np.stack([
            np.concatenate([rng.permutation(MINI_N), rng.integers(0, MINI_N, 20)])
            for _ in range(size)]).astype(np.int64)
    return out


def _ref_weights(arch):
    """The reference config's parameters (its `init`, jitted), numpy, the
    arch's dtype."""
    tree = jax.jit(REF_ARCHS[arch].init, static_argnums=(1, 2))(jax.random.key(0), D_FEAT,
                                                                 N_OUT)
    return jax.tree.map(lambda x: np.asarray(x, _dtype(arch)), tree)


# --------------------------------------------------------------------------
# the rank processes
# --------------------------------------------------------------------------

_SCRIPT = """
import json, os, sys, time
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

rank, size, data = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
world = os.path.join(data, f"world{size}")
dist.init_process_group("gloo", init_method="file://" + os.path.join(world, "rendezvous"),
                        rank=rank, world_size=size)
from repro_torch.configs import GNN_ARCHS, gnn_cells as C
from repro_torch.core import prng
from repro_torch.dist.graph import split_graph
from repro_torch.train import optimizer as O
import torch.distributed.tensor

# the inputs and the reference's weights, written by the test process
# while the ranks start
while not os.path.exists(os.path.join(data, "meta.json")):
    time.sleep(0.05)
meta = json.load(open(os.path.join(data, "meta.json")))

grads, placed_update = [], O.adamw_update_placed
def recording(cfg, g, *args, **kw):
    # each step's gradient, summed over the ranks (a collective on every rank)
    grads.append({k: v.full_tensor().numpy() for k, v in g.items()})
    return placed_update(cfg, g, *args, **kw)
O.adamw_update_placed = recording

out = {}
for graph, shape in meta["worlds"][str(size)]:
    mesh = DeviceMesh("cpu", torch.arange(size).reshape(shape), mesh_dim_names=("data", "model"))
    inp = np.load(os.path.join(data, f"graph_{graph}.npz"))
    n = inp["feats"].shape[0]
    split = split_graph(inp["senders"], inp["receivers"], inp["mask"], n, mesh)
    rows = [split.rows(torch.from_numpy(inp[k])) for k in ("feats", "coords", "labels")]
    for arch in meta["archs"]:
        dt = torch.float64 if arch in meta["f64"] else torch.float32
        a = GNN_ARCHS[arch]
        model = a.init(meta["d_feat"], meta["n_out"], seed=0, device="cpu")
        w = np.load(os.path.join(data, f"weights_{arch}.npz"))
        model.load_state_dict({k: torch.from_numpy(w[k]) for k in w.files})
        model.to(dt)
        params, opt = C.place_gnn_state(C.train_params(model), mesh)
        feats, coords = (x.to(dt) for x in rows[:2])
        grads.clear()
        losses = []
        for _ in range(meta["steps"]):
            params, opt, loss = C.full_graph_step(a, model, params, opt, feats, coords,
                                                  *split.edges, rows[2], split=split)
            losses.append(loss.item())
        name = f"{graph}_{arch}_{shape[0]}x{shape[1]}"
        out[name] = {"losses": losses, "edges": int(split.senders.numel()),
                     "block": [split.lo, split.hi, split.block]}
        if rank == 0:
            leaves = {f"p/{k}": v.to_local() for k, v in params.items()}
            leaves.update({f"m/{k}": v.to_local() for k, v in opt.m.items()})
            leaves.update({f"v/{k}": v.to_local() for k, v in opt.v.items()})
            arrays = {k: v.detach().numpy() for k, v in leaves.items()}
            for i, g in enumerate(grads):
                arrays.update({f"g{i}/{k}": v for k, v in g.items()})
            np.savez(os.path.join(world, f"{name}.npz"), **arrays)

# minibatch_lg's tables split over the flat mesh (dist.lookup): the
# split step against the replicated step on the same mesh, bit for bit
from repro_torch.dist.lookup import TableSplit
from repro_torch.dist.sharding import local

def bits(x):
    return x.view({torch.float32: torch.int32, torch.float64: torch.int64}.get(x.dtype, x.dtype))

def same(x, y):
    return x.shape == y.shape and x.dtype == y.dtype and torch.equal(bits(x), bits(y))

for shape in meta["mini_meshes"].get(str(size), []):
    mesh = DeviceMesh("cpu", torch.arange(size).reshape(shape), mesh_dim_names=("data", "model"))
    tables = TableSplit.of(mesh)
    dp = shape[0]
    coord = mesh.get_coordinate()[0]
    for case in meta["mini_cases"]:
        inp = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(data, f"mini_{case}.npz")).items()}
        whole = [inp[k] for k in ("indices", "feats", "coords", "labels")]
        blocks = [tables.block(x) for x in whole]
        seeds = inp["seeds"].chunk(dp)[coord]
        draws = tuple(inp[k].chunk(dp)[coord] for k in ("u1", "u2"))
        for arch in meta["mini_archs"]:
            dt = torch.float64 if arch in meta["f64"] else torch.float32
            a = GNN_ARCHS[arch]
            model = a.init(meta["d_feat"], meta["n_out"], seed=0, device="cpu")
            w = np.load(os.path.join(data, f"weights_{arch}.npz"))
            model.load_state_dict({k: torch.from_numpy(w[k]) for k in w.files})
            model.to(dt)
            feats, coords = (x.to(dt) for x in whole[1:3])
            fblocks = [blocks[0], *(x.to(dt) for x in blocks[1:3]), blocks[3]]
            tree = C.minibatch_tree(inp["indptr"], whole[0], seeds, draws)
            tree_s = C.minibatch_tree(inp["indptr"], fblocks[0], seeds, draws, tables)
            rows = C.minibatch_rows(tree, feats, coords, whole[3], seeds)
            rows_s = C.minibatch_rows(tree_s, *fblocks[1:], seeds, tables)
            runs = {}
            for name, tabs, split in (("replicated", [whole[0], feats, coords, whole[3]], None),
                                      ("split", fblocks, tables)):
                params, opt = C.place_gnn_state(C.train_params(model), mesh)
                losses = []
                for _ in range(meta["steps"]):
                    params, opt, loss = C.minibatch_step(a, model, params, opt, draws,
                                                         inp["indptr"], *tabs, seeds, mesh=mesh,
                                                         tables=split)
                    losses.append(loss)
                leaves = {f"p/{k}": local(v) for k, v in params.items()}
                leaves.update({f"m/{k}": local(v) for k, v in opt.m.items()})
                leaves.update({f"v/{k}": local(v) for k, v in opt.v.items()})
                runs[name] = (losses, leaves)
            (lr, vr), (ls, vs) = runs["replicated"], runs["split"]
            out[f"mini_{case}_{arch}_{shape[0]}x{shape[1]}"] = {
                "losses": [x.item() for x in ls],
                "losses_equal": all(same(x, y) for x, y in zip(lr, ls)),
                "leaves_differ": sorted(k for k in vr if not same(vr[k], vs[k])),
                "n_leaves": len(vr),
                "tree_equal": all(same(x, y) for x, y in zip(tree, tree_s)),
                "rows_equal": [same(x, y) for x, y in zip(rows, rows_s)],
                "blocks": [list(b.shape) for b in blocks],
            }
    # the step from a key: this rank's rows of the reference's draw
    inp = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(data, "mini_mixed.npz")).items()}
    want = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(data, "mini_key.npz")).items()}
    seeds = inp["seeds"].chunk(dp)[coord]
    rows = tuple(want[k].chunk(dp)[coord] for k in ("u1", "u2"))
    arch = meta["mini_archs"][0]
    a = GNN_ARCHS[arch]
    model = a.init(meta["d_feat"], meta["n_out"], seed=0, device="cpu")
    w = np.load(os.path.join(data, f"weights_{arch}.npz"))
    model.load_state_dict({k: torch.from_numpy(w[k]) for k in w.files})
    seen, tree_fn = [], C.minibatch_tree
    def capture(indptr, indices, seeds, draws, tables=None):
        seen.append(draws)
        return tree_fn(indptr, indices, seeds, draws, tables)
    runs = {}
    for name, arg in (("key", prng.Key(*meta["mini_key"])), ("rows", rows)):
        params, opt = C.place_gnn_state(C.train_params(model), mesh)
        losses = []
        C.minibatch_tree = capture if name == "key" else tree_fn
        for _ in range(meta["steps"]):
            params, opt, loss = C.minibatch_step(a, model, params, opt, arg, inp["indptr"],
                                                 inp["indices"], inp["feats"], inp["coords"],
                                                 inp["labels"], seeds, mesh=mesh)
            losses.append(loss)
        runs[name] = losses
    C.minibatch_tree = tree_fn
    out[f"mini_key_{shape[0]}x{shape[1]}"] = {
        "draws_equal": [all(same(x, y) for x, y in zip(d, rows)) for d in seen],
        "row_shapes": [list(x.shape) for x in rows],
        "losses_equal": all(same(x, y) for x, y in zip(runs["key"], runs["rows"])),
    }

# take(block, ids) against the whole table's rows, bit for bit
if "take" in meta:
    mesh = DeviceMesh("cpu", torch.arange(size).reshape(size, 1), mesh_dim_names=("data", "model"))
    tables = TableSplit.of(mesh)
    t = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(data, "take.npz")).items()}
    for kind in meta["take"]:
        ids = t[f"ids_{kind}_{size}"][rank]
        got = {k: tables.take(tables.block(t[k]), ids) for k in ("f32", "f64", "i32", "mask")}
        out[f"take_{kind}_{size}"] = {
            "equal": {k: same(v, t[k][ids.long()]) for k, v in got.items()},
            "owners": sorted(set((ids.long() // -(-t["f32"].shape[0] // size)).tolist())),
        }
json.dump(out, open(os.path.join(world, f"out.rank{rank}.json"), "w"))
dist.destroy_process_group()
"""


def _start(size: int, data: str) -> list:
    os.makedirs(os.path.join(data, f"world{size}"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-c", _SCRIPT, str(r), str(size), data],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for r in range(size)]


def _finish(procs: list, size: int, data: str) -> dict:
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log[-4000:]
    world = os.path.join(data, f"world{size}")
    outs = [json.load(open(os.path.join(world, f"out.rank{r}.json"))) for r in range(size)]
    arrays = {name: os.path.join(world, f"{name}.npz") for name in outs[0]}
    return {name: dict(ranks=[o[name] for o in outs],
                       arrays=dict(np.load(path)) if os.path.exists(path) else {})
            for name, path in arrays.items()}


# --------------------------------------------------------------------------
# the steps in this process: without a split, and the reference's
# --------------------------------------------------------------------------

def _port_model(arch, tree):
    model = GNN_ARCHS[arch].init(D_FEAT, N_OUT, seed=0, device="cpu")
    model.load_state_dict(G.gnn_params_from_numpy(arch, tree))
    return model.to({np.float32: torch.float32, np.float64: torch.float64}[_dtype(arch)])


def _unsplit_steps(arch, tree, graph):
    """STEPS steps of the step without a split: (losses, each step's
    gradients, the state after each step)."""
    a = GNN_ARCHS[arch]
    model = _port_model(arch, tree)
    dt = next(model.parameters()).dtype
    feats, coords = (torch.from_numpy(graph[k]).to(dt) for k in ("feats", "coords"))
    edges = [torch.from_numpy(graph[k]) for k in ("senders", "receivers", "mask")]
    labels = torch.from_numpy(graph["labels"])
    grads, update = [], C.adamw_update

    def recording(cfg, g, *args, **kw):
        grads.append({k: v.numpy() for k, v in g.items()})
        return update(cfg, g, *args, **kw)

    params = C.train_params(model)
    opt = O.adamw_init(params)
    losses, states = [], []
    C.adamw_update = recording
    try:
        for _ in range(STEPS):
            params, opt, loss = C.full_graph_step(a, model, params, opt, feats, coords, *edges,
                                                  labels)
            losses.append(float(loss))
            states.append((params, opt))
    finally:
        C.adamw_update = update
    return losses, grads, states


def _mini_whole_losses(arch, tree, mini):
    """STEPS minibatch steps without a mesh on the whole batch: the losses."""
    a = GNN_ARCHS[arch]
    model = _port_model(arch, tree)
    dt = next(model.parameters()).dtype
    t = {k: torch.from_numpy(v) for k, v in mini.items()}
    params = C.train_params(model)
    opt = O.adamw_init(params)
    losses = []
    for _ in range(STEPS):
        params, opt, loss = C.minibatch_step(a, model, params, opt, (t["u1"], t["u2"]),
                                             t["indptr"], t["indices"], t["feats"].to(dt),
                                             t["coords"].to(dt), t["labels"], t["seeds"])
        losses.append(float(loss))
    return losses


def _ref_step(arch, tree, graph):
    """One step of the reference's ogb_products cell (jitted, one device):
    (params, AdamW state, loss)."""
    dt = _dtype(arch)
    with jax.enable_x64(dt == np.float64):
        step = jax.jit(ref_cells._full_graph_cell(REF_ARCHS[arch], "ogb_products").build(
            Mesh(np.array(jax.devices()[:1]), ("data",)))[0])
        new, new_opt, loss = step(tree, RO.adamw_init(tree), graph["feats"].astype(dt),
                                  graph["coords"].astype(dt), graph["senders"],
                                  graph["receivers"], graph["mask"], graph["labels"])
        return jax.tree.map(np.asarray, (new, new_opt)) + (float(loss),)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one launch of the three worlds, and in this process meanwhile the
    reference's steps and the steps without a split."""
    data = str(tmp_path_factory.mktemp("gnn_ranks"))
    procs = {size: _start(size, data) for size in WORLDS}
    try:
        graphs = _graphs()
        for name, arrays in graphs.items():
            np.savez(os.path.join(data, f"graph_{name}.npz"), **arrays)
        minis = {case: _mini_inputs(case) for case in MINI_CASES}
        for case, arrays in minis.items():
            np.savez(os.path.join(data, f"mini_{case}.npz"), **arrays)
        np.savez(os.path.join(data, "mini_key.npz"), **_mini_key_draws())
        np.savez(os.path.join(data, "take.npz"), **_take_inputs())
        trees = {arch: _ref_weights(arch) for arch in ARCHS}
        for arch, tree in trees.items():
            np.savez(os.path.join(data, f"weights_{arch}.npz"),
                     **{k: v.numpy() for k, v in G.gnn_params_from_numpy(arch, tree).items()})
        meta = {"worlds": {str(k): v for k, v in WORLDS.items()}, "archs": list(ARCHS),
                "f64": list(F64), "d_feat": D_FEAT, "n_out": N_OUT, "steps": STEPS,
                "mini_meshes": {str(k): v for k, v in MINI_MESHES.items()},
                "mini_cases": list(MINI_CASES), "mini_archs": list(MINI_ARCHS),
                "mini_key": list(prng.key(MINI_KEY)),
                "take": list(TAKE_KINDS)}
        with open(os.path.join(data, "meta.tmp"), "w") as f:
            json.dump(meta, f)
        os.replace(os.path.join(data, "meta.tmp"), os.path.join(data, "meta.json"))
        ref = {arch: _ref_step(arch, trees[arch], graphs["main"]) for arch in ARCHS}
        unsplit = {(g, arch): _unsplit_steps(arch, trees[arch], graphs[g])
                   for g in graphs for arch in ARCHS}
        mini_whole = {(case, arch): _mini_whole_losses(arch, trees[arch], minis[case])
                      for case in MINI_CASES for arch in MINI_ARCHS}
        placed = {}
        for size, ps in procs.items():
            placed.update(_finish(ps, size, data))
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return dict(trees=trees, ref=ref, unsplit=unsplit, placed=placed, mini_whole=mini_whole)


# --------------------------------------------------------------------------
# checks
# --------------------------------------------------------------------------

def _scaled_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    return err / scale if scale else err


def _lrs():
    return [float(O.schedule(C.TRAIN_OPT, t)) for t in range(1, STEPS + 1)]


def _params_close(got, want, grads, lrs, what):
    """The parameters' rule (module docstring): `grads` the steps'
    gradients of this leaf."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    resolved = np.ones(want.shape, bool)
    for g in grads:
        resolved &= np.abs(g) >= 1e-3 * np.abs(g).max()
    ulps = 2 * np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    tol = np.where(resolved, 1e-3 * sum(lrs), 2 * sum(lrs)) + ulps
    bad = np.abs(got - want) > tol
    assert not bad.any(), f"{what}: {int(bad.sum())} entries off, worst " \
                          f"{float(np.abs(got - want).max()):.3g}"


def _hold_to_unsplit(runs, graph, arch, shape):
    name = f"{graph}_{arch}_{shape[0]}x{shape[1]}"
    placed = runs["placed"][name]
    losses, grads, states = runs["unsplit"][(graph, arch)]
    tol = GRAD_TOL[arch]
    for r, rank in enumerate(placed["ranks"]):
        np.testing.assert_allclose(rank["losses"], losses, rtol=LOSS_TOL,
                                   err_msg=f"{name} rank {r}'s losses")
    arrays = placed["arrays"]
    for i, g in enumerate(grads):
        for k, want in g.items():
            err = _scaled_err(arrays[f"g{i}/{k}"], want)
            assert err <= tol, f"{name} step {i + 1} gradient {k}: {err:.3g}"
    params, opt = states[-1]
    for k in params:
        err = _scaled_err(arrays[f"m/{k}"], opt.m[k].numpy())
        assert err <= tol, f"{name} m/{k}: {err:.3g}"
        err = _scaled_err(np.sqrt(arrays[f"v/{k}"]), np.sqrt(opt.v[k].numpy()))
        assert err <= tol, f"{name} v/{k}: {err:.3g}"
        _params_close(arrays[f"p/{k}"], params[k].numpy(), [g[k] for g in grads], _lrs(),
                      f"{name} p/{k}")
    return placed


@pytest.mark.parametrize("ranks", (2, 3, 4))
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_step_matches_the_step_without_a_split(runs, arch, ranks):
    """ogb_products' placed step on (ranks, 1) after 2 steps: every rank's
    loss, both steps' gradients, the parameters, m and v."""
    placed = _hold_to_unsplit(runs, "main", arch, (ranks, 1))
    bounds = partition_rows(MAIN_N, ranks)
    assert [r["block"][:2] for r in placed["ranks"]] == [
        [int(bounds[i]), int(bounds[i + 1])] for i in range(ranks)]
    assert sum(r["edges"] for r in placed["ranks"]) == _main_graph()[0].shape[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_a_2x2_mesh_splits_as_4x1(runs, arch):
    """(2, 2) splits the vertices over its four ranks in flat order, as
    (4, 1) does: the same blocks and edges a rank, the same losses, and
    the step held to the step without a split as (4, 1)'s is."""
    a = _hold_to_unsplit(runs, "main", arch, (2, 2))
    b = runs["placed"][f"main_{arch}_4x1"]
    assert [r["block"] for r in a["ranks"]] == [r["block"] for r in b["ranks"]]
    assert [r["edges"] for r in a["ranks"]] == [r["edges"] for r in b["ranks"]]
    np.testing.assert_allclose([r["losses"] for r in a["ranks"]],
                               [r["losses"] for r in b["ranks"]], rtol=LOSS_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_edge_cases_match_the_step_without_a_split(runs, arch):
    """A rank that owns no edge (it still joins every collective), vertices
    with no in-edge (PNA's max / min / std and EGNN's 1/deg at 0 in-edges),
    masked input edges and the shards' padding, on (4, 1)."""
    placed = _hold_to_unsplit(runs, "edges", arch, (4, 1))
    edges = [r["edges"] for r in placed["ranks"]]
    assert edges[3] == 0 and min(edges[:3]) > 0, edges
    s, r, mask = _edges_graph()
    assert not mask.all() and not np.isin([5, 17], r).any()


@pytest.mark.parametrize("arch", ARCHS)
def test_step_without_a_split_matches_the_reference_cell(runs, arch):
    """The port's step (one rank, no split) against the reference's
    ogb_products cell step: the loss, m, v and the parameters after one
    step (m, the clipped gradient's tenth, tells which entries are
    resolved)."""
    new, new_opt, ref_loss = runs["ref"][arch]
    losses, _, states = runs["unsplit"][("main", arch)]
    np.testing.assert_allclose(losses[0], ref_loss, rtol=1e-5)
    params, opt = states[0]
    want = {k: G.gnn_params_from_numpy(arch, t) for k, t in
            (("p", new), ("m", new_opt.m), ("v", new_opt.v))}
    assert int(opt.step) == int(new_opt.step) == 1
    for k in params:
        assert _scaled_err(opt.m[k].numpy(), want["m"][k].numpy()) <= 1e-4, k
        assert _scaled_err(np.sqrt(opt.v[k].numpy()), np.sqrt(want["v"][k].numpy())) <= 1e-4, k
        _params_close(params[k].numpy(), want["p"][k].numpy(), [want["m"][k].numpy()],
                      _lrs()[:1], f"{arch} p/{k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_loss_matches_the_reference_cell(runs, arch):
    """The placed step's loss on (3, 1) and (2, 2), every rank's, against
    the reference cell's on the same weights and graph."""
    ref_loss = runs["ref"][arch][2]
    for name in (f"main_{arch}_3x1", f"main_{arch}_2x2"):
        for rank in runs["placed"][name]["ranks"]:
            np.testing.assert_allclose(rank["losses"][0], ref_loss, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("case", MINI_CASES)
@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (2, 2)])
@pytest.mark.parametrize("arch", MINI_ARCHS)
def test_split_tables_step_is_the_replicated_step_bit_for_bit(runs, arch, shape, case):
    """minibatch_lg's step with `indices`, the features, coordinates and
    labels split by rows over the flat mesh (`minibatch_step(tables=)`)
    against the same step on whole tables on the same mesh, after 2 steps,
    on every rank: the sampled tree, the rows read (features with -0.0
    entries), both losses and every leaf of the parameters, m and v, bit
    for bit; each rank's blocks ceil(50 / R) rows; the loss the whole
    batch's step without a mesh gives (rtol 1e-5: the ranks sum the
    batch's terms in another order)."""
    name = f"mini_{case}_{arch}_{shape[0]}x{shape[1]}"
    ranks = runs["placed"][name]["ranks"]
    blk = -(-MINI_N // (shape[0] * shape[1]))
    for r, rank in enumerate(ranks):
        assert rank["tree_equal"] and rank["rows_equal"] == [True] * 3, (name, r)
        assert rank["losses_equal"], (name, r, rank["losses"])
        assert rank["leaves_differ"] == [] and rank["n_leaves"] > 0, (name, r)
        assert rank["blocks"] == [[-(-len(_mini_inputs(case)["indices"]) // len(ranks))],
                                  [blk, D_FEAT], [blk, 3], [blk]], (name, r)
        np.testing.assert_allclose(rank["losses"], runs["mini_whole"][(case, arch)], rtol=1e-5,
                                   err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("shape", [(2, 1), (4, 1), (2, 2)])
def test_minibatch_step_from_a_key_draws_its_rows_of_the_reference_draw(runs, shape):
    """minibatch_lg's step on a mesh, given the key: every rank, model ranks
    included, samples its block of seeds from its data block's rows of the
    reference cell's draw for the whole batch (the key's draw from the
    block's start counter), at each of 2 steps, and its losses are bit for
    bit those of the step given those rows."""
    dp = shape[0]
    for r, rank in enumerate(runs["placed"][f"mini_key_{shape[0]}x{shape[1]}"]["ranks"]):
        assert rank["draws_equal"] == [True] * STEPS, (shape, r)
        f1, f2 = ref_cells.GNN_SHAPES["minibatch_lg"]["fanout"]
        assert rank["row_shapes"] == [[MINI_B // dp, f1], [MINI_B // dp, f1, f2]], (shape, r)
        assert rank["losses_equal"], (shape, r)


@pytest.mark.parametrize("kind", TAKE_KINDS)
@pytest.mark.parametrize("ranks", (2, 3, 4))
def test_take_returns_the_tables_rows_bit_for_bit(runs, ranks, kind):
    """`TableSplit.take` on (ranks, 1), each rank its own ids: ids all in
    the second block (one rank holds every row asked for), and ids that
    cover every block; f32 (-0.0, a NaN's payload), f64, int32 and bool
    tables of 50 rows, which 3 and 4 ranks split into padded blocks."""
    for r, rank in enumerate(runs["placed"][f"take_{kind}_{ranks}"]["ranks"]):
        assert rank["equal"] == {"f32": True, "f64": True, "i32": True, "mask": True}, r
        assert rank["owners"] == ([1] if kind == "one_block" else list(range(ranks))), r


# --------------------------------------------------------------------------
# the split on the host
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ranks", (1, 2, 3, 4))
def test_split_deals_every_edge_once(ranks):
    """Over the ranks, the split's edges are the graph's, each once, on its
    receiver's rank in `partition_edges`' order; every sender row lies in
    its owner's block of the gathered rows, every receiver in the rank's
    block, and no sentinel slot is left."""
    s, r, mask = _edges_graph()
    n = EDGES_N
    bounds = partition_rows(n, ranks)
    block = -(-n // ranks)
    _, want_r, want_m = partition_edges(s, r, n, ranks)
    got = []
    for rank in range(ranks):
        lo, hi, blk, rows, rcv, m = split_edges(s, r, mask, n, ranks, rank)
        assert (lo, hi, blk) == (bounds[rank], bounds[rank + 1], block)
        assert rows.dtype == rcv.dtype == np.int64 and m.dtype == bool
        assert ((rcv >= 0) & (rcv < hi - lo)).all()
        owner, off = rows // block, rows % block
        assert (off < bounds[owner + 1] - bounds[owner]).all()
        np.testing.assert_array_equal(rcv + lo, want_r[rank][want_m[rank]])
        got += list(zip(bounds[owner] + off, rcv + lo, m))
    assert sorted(got) == sorted(zip(s.tolist(), r.tolist(), mask.tolist()))


def test_split_of_a_rank_without_edges_is_empty():
    lo, hi, block, rows, rcv, m = split_edges(*_edges_graph(), EDGES_N, 4, 3)
    assert (lo, hi, block) == (30, 40, 10)
    assert rows.shape == rcv.shape == m.shape == (0,)


def test_split_refuses_fewer_vertices_than_ranks():
    with pytest.raises(ValueError, match="do not split"):
        split_edges(np.zeros(1, np.int32), np.ones(1, np.int32), np.ones(1, bool), 3, 4, 0)


def test_products_inputs_are_the_shape_at_any_scale():
    """The stand-in at 300 vertices: ogb_products' widths, classes and
    average degree (2E / N of the shape, before duplicates are dropped),
    every edge real and in range, the same draws for the same seed."""
    n = 300
    s, r, mask, feats, coords, labels = C.products_inputs(n, seed=3, device="cpu")
    assert feats.shape == (n, D_FEAT) and feats.dtype == torch.float32
    assert coords.shape == (n, 3) and labels.dtype == torch.int32
    assert int(labels.min()) >= 0 and int(labels.max()) < N_OUT
    assert bool(mask.all()) and int(s.max()) < n and int(r.max()) < n
    drawn = 2 * int(n * (2 * SHAPE["n_edges"] / SHAPE["n_nodes"]) / 2)
    assert 0.8 * drawn < s.shape[0] <= drawn
    again = C.products_inputs(n, seed=3, device="cpu")
    for x, y in zip((s, r, mask, feats, coords, labels), again):
        assert torch.equal(x, y)
    assert C.products_nodes(0.25) == 612_257 and C.products_nodes() == SHAPE["n_nodes"]


@pytest.fixture
def one_rank_mesh():
    from torch.distributed.device_mesh import DeviceMesh

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int64),
                     mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


def test_products_part_on_one_rank_is_the_whole(one_rank_mesh):
    """On one rank the part is the whole stand-in: every row and edge, in
    the edge list's order, senders as their own rows."""
    split, feats, coords, labels = C.products_part(one_rank_mesh, 200, seed=1)
    s, r, mask, *whole = C.products_inputs(200, seed=1, device="cpu")
    assert (split.lo, split.hi, split.block, split.n_nodes) == (0, 200, 200, 200)
    for got, want in zip((split.senders, split.receivers, split.mask), (s, r, mask)):
        assert torch.equal(got, want.to(got.dtype))
    for got, want in zip((feats, coords, labels), whole):
        assert torch.equal(got, want)
    g = split_graph(s.numpy(), r.numpy(), mask.numpy(), 200, one_rank_mesh)
    assert torch.equal(g.senders, split.senders)


def test_tiled_gin_refuses_a_split():
    model = G.GIN(4, 8, 2, 3, device="cpu")
    with pytest.raises(ValueError, match="segment"):
        model(torch.zeros((2, 4)), torch.zeros(1, dtype=torch.int32),
              torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.bool),
              backend="tiled", split=object())


@pytest.mark.parametrize("n, ranks", [(50, 4), (50, 3), (48, 4), (7, 4), (3, 4), (5, 1)])
def test_row_block_cuts_equal_blocks_padded_with_zeros(n, ranks):
    """Every rank's block has ceil(n / ranks) rows; the blocks in rank
    order are the table, then zero rows (a whole block of them where the
    table ends before it); each block in storage of its own."""
    x = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3) + 1
    blk = block_rows(n, ranks)
    assert blk == -(-n // ranks)
    parts = [row_block(x, ranks, r) for r in range(ranks)]
    assert all(p.shape == (blk, 3) and p.dtype == x.dtype for p in parts)
    cat = torch.cat(parts)
    assert torch.equal(cat[:n], x) and not cat[n:].any()
    parts[0][0] = 0
    assert x[0, 0] == 1


def test_take_on_one_rank_is_indexing(one_rank_mesh):
    """On one rank the block is the whole table (its own copy) and `take`
    is indexing, bit for bit (-0.0 and a NaN's payload kept); a bf16 table
    has no lookup (its rows would sum as int16, which NCCL lacks)."""
    tables = TableSplit.of(one_rank_mesh)
    x = torch.randn((9, 4))
    x[2, 1] = -0.0
    x.view(torch.int32)[5, 0] = 0x7FC12345
    block = tables.block(x.numpy())
    assert block.shape == x.shape and tables.rows(block) == 9
    ids = torch.tensor([[2, 5], [5, 8], [0, 2]], dtype=torch.int32)
    got = tables.take(block, ids)
    assert got.shape == (3, 2, 4) and torch.equal(got.view(torch.int32),
                                                 x[ids.long()].view(torch.int32))
    with pytest.raises(ValueError, match="no lookup"):
        tables.take(block.to(torch.bfloat16), ids)


def test_split_tables_need_the_steps_mesh(one_rank_mesh):
    """`minibatch_step(tables=)` without the mesh the tables are split over
    refuses: its gradients would not be summed over the batch ranks."""
    with pytest.raises(ValueError, match="need the step's mesh"):
        C.minibatch_step(None, None, {}, None, None, None, None, None, None, None, None,
                         tables=TableSplit.of(one_rank_mesh))
