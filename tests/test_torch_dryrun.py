"""The dry run's pieces on the CPU: `launch.dryrun._affine` against the
reference's; rank 0's argument bytes on a fake (2, 4) group against the
reference's `memory_analysis().argument_size_in_bytes` of the same train
cell (tests/test_distributed.py's small-mesh config, the reference on 8
fake XLA devices in a subprocess); `perf.counting.CountingMode` (a matrix
product's FLOPs, an add's bytes, collective bytes by type on a fake group
of 8, the peak of a known sequence of allocations); the four kernel
wrappers' fake branches (shapes and dtypes of the plain version's outputs,
the bytes of the bound's arithmetic in `chip_smoke.py`, the plain version
never called); `core.distributed.mis_round` applied 1, 2 and 3 times
against the reference's `build_distributed_mis` with `max_rounds` = k;
and `run_cell` end to end on (16, 16) for tcmis × G2, deepfm × serve_p99
and qwen3-0.6b × decode_32k.  Every fake group is destroyed after its
test."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from conftest import run_multidevice
from test_torch_hybrid import _port_graph

from repro.core import distributed as ref_dist
from repro.core.heuristics import make_priorities as ref_make_priorities
from repro.core.tiling import build_block_tiles as ref_build_block_tiles
from repro.graphs.generators import powerlaw as ref_powerlaw
from repro_torch.configs import common as C
from repro_torch.configs import qwen3_0_6b
from repro_torch.core import distributed as D
from repro_torch.core.heuristics import Priorities
from repro_torch.core.spmv import _NEG
from repro_torch.core.tiling import build_block_tiles
from repro_torch.graphs.generators import erdos_renyi
from repro_torch.hopper import embedding_bag as E
from repro_torch.hopper import tc_spmv as K
from repro_torch.launch import dryrun as DR
from repro_torch.perf.counting import CountingMode
from repro_torch.train import optimizer as O

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the bounds' arithmetic)


@pytest.fixture(autouse=True)
def no_group_left():
    """Each test starts and ends with no default process group."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# the extrapolation
# --------------------------------------------------------------------------

def _reference_affine():
    """`repro.launch.dryrun._affine`.  Importing that module sets XLA_FLAGS
    to 512 host devices (its first lines), which would reach every later
    JAX backend and subprocess of this process: the variable is put back."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import _affine
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return _affine


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_affine_equals_the_reference(seed):
    rng = np.random.default_rng(seed)

    def sample():
        kinds = rng.choice(["all-gather", "all-reduce", "reduce-scatter", "all-to-all"],
                           size=rng.integers(1, 4), replace=False)
        return dict(flops=float(rng.uniform(1e9, 1e12)),
                    bytes_accessed=float(rng.uniform(1e6, 1e9)),
                    collectives={str(k): int(rng.integers(0, 10 ** 8)) for k in kinds})

    a, b = sample(), sample()
    la, lb, lfull = 2, 4, int(rng.integers(5, 100))
    assert DR._affine(a, b, la, lb, lfull) == _reference_affine()(a, b, la, lb, lfull)


# --------------------------------------------------------------------------
# argument bytes against the reference's memory analysis
# --------------------------------------------------------------------------

SMALL_LM = dict(d_model=128, n_heads=8, n_kv_heads=4, d_head=16, vocab=512)
SMALL_SHAPE = dict(seq_len=64, global_batch=8, kind="train")


def test_argument_bytes_equal_the_references_on_a_2x4_mesh(monkeypatch):
    """Rank 0's placed state and tokens of the train cell at
    tests/test_distributed.py's small config (qwen3's SMOKE widened) on
    (data=2, model=4): the bytes the reference's compiled cell takes as
    arguments.  No leaf differs."""
    out = run_multidevice(f"""
        import dataclasses
        import jax
        from repro.configs import common as RC
        from repro.configs.qwen3_0_6b import SMOKE

        RC.LM_SHAPES["train_4k"] = {SMALL_SHAPE!r}
        mesh = jax.make_mesh((2, 4), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        cfg = dataclasses.replace(SMOKE, **{SMALL_LM!r})
        cell = RC._lm_train_cell("qwen3-small", cfg, "train_4k")
        with mesh:
            fn, inputs, shardings = cell.build(mesh, variant="memory")
            compiled = jax.jit(fn, in_shardings=shardings).lower(*inputs).compile()
        print("ARGUMENT_BYTES", compiled.memory_analysis().argument_size_in_bytes)
    """)
    want = int(out.split("ARGUMENT_BYTES")[1].split()[0])
    monkeypatch.setitem(C.LM_SHAPES, "train_4k", SMALL_SHAPE)
    cfg = dataclasses.replace(qwen3_0_6b.SMOKE, **SMALL_LM)
    cell = C._lm_train_cell("qwen3-small", cfg, "train_4k")
    with DR.fake_group((2, 4), ("data", "model")) as mesh:
        got = DR.count_pass(cell, mesh, "memory")["memory"]
    assert got["argument_bytes"] == want
    assert got["total_per_device"] >= got["argument_bytes"] + got["output_bytes"]


SMALL_MINIBATCH = dict(n_nodes=1000, n_edges=5000, d_feat=16, n_out=5, batch_nodes=16,
                      fanout=(3, 2))


def test_minibatch_argument_bytes_equal_the_references_on_a_2x4_mesh(monkeypatch):
    """Rank 0's arguments of egnn's minibatch_lg cell with the shape cut
    to 1,000 vertices (`SMALL_MINIBATCH`, in both packages) on (data=2,
    model=4): the tables split over the flat mesh as the reference places
    them (`indptr` whole, `indices`, features, coordinates and labels an
    eighth each), so the bytes are the reference's compiled cell's, less
    its 8-byte PRNG key, plus the port's draws, which stand for the key:
    b · f1 · (1 + f2) int32s for rank 0's b = 8 seeds.  egnn reads every
    table (gin-tu reads no coordinates, and jax.jit drops an argument the
    computation does not use from its count)."""
    out = run_multidevice(f"""
        import jax
        from repro.configs import egnn
        from repro.configs import gnn_cells as RG

        RG.GNN_SHAPES["minibatch_lg"] = {SMALL_MINIBATCH!r}
        mesh = jax.make_mesh((2, 4), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        cell = RG._minibatch_cell(egnn.GNN)
        with mesh:
            fn, inputs, shardings = cell.build(mesh, variant="memory")
            compiled = jax.jit(fn, in_shardings=shardings).lower(*inputs).compile()
        print("ARGUMENT_BYTES", compiled.memory_analysis().argument_size_in_bytes)
    """)
    want = int(out.split("ARGUMENT_BYTES")[1].split()[0])
    from repro_torch.configs import GNN_ARCHS
    from repro_torch.configs import gnn_cells as G

    monkeypatch.setitem(G.GNN_SHAPES, "minibatch_lg", SMALL_MINIBATCH)
    cell = G._minibatch_cell(GNN_ARCHS["egnn"])
    with DR.fake_group((2, 4), ("data", "model")) as mesh:
        got = DR.count_pass(cell, mesh, "memory")["memory"]
    f1, f2 = SMALL_MINIBATCH["fanout"]
    b = SMALL_MINIBATCH["batch_nodes"] // 2
    assert got["argument_bytes"] == want - 8 + b * f1 * (1 + f2) * 4
    assert got["total_per_device"] >= got["argument_bytes"] + got["output_bytes"]


def test_a_memory_pass_counts_the_carry_at_its_block_of_S(monkeypatch):
    """The train cell at the small config above on a fake (data=2,
    model=4) group: every layer input that remat saves (a checkpointed
    layer's float tensor argument, seen by `saved_tensors_hooks`) is rank
    0's block of S, (B/2, S/4, D): a quarter of its whole size.  This is
    the term by which the dry run's records moved when the residual
    stream became sequence-parallel."""
    from repro_torch.models import transformer as tf

    saved = []
    checkpointed = tf._checkpointed

    def counted(policy, fn, *args):
        floats = []

        def pack(t):
            if t.is_floating_point():
                floats.append((tuple(t.shape), t.element_size()))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = checkpointed(policy, fn, *args)
        saved.append(floats)
        return out

    monkeypatch.setattr(tf, "_checkpointed", counted)
    monkeypatch.setitem(C.LM_SHAPES, "train_4k", SMALL_SHAPE)
    cfg = dataclasses.replace(qwen3_0_6b.SMOKE, **SMALL_LM)
    cell = C._lm_train_cell("qwen3-small", cfg, "train_4k")
    with DR.fake_group((2, 4), ("data", "model")) as mesh:
        DR.count_pass(cell, mesh, "memory")
    B, S, D = SMALL_SHAPE["global_batch"], SMALL_SHAPE["seq_len"], SMALL_LM["d_model"]
    assert len(saved) == cfg.n_layers
    for floats in saved:
        (shape, itemsize), = floats         # a quarter of the whole (B / 2, S, D)
        assert shape == (B // 2, S // 4, D) and itemsize == 4


# --------------------------------------------------------------------------
# the counting mode
# --------------------------------------------------------------------------

def test_counting_mode_counts_flops_bytes_and_the_peak():
    fm = FakeTensorMode()
    with fm:
        a = torch.empty((64, 32))
        b = torch.empty((32, 16))
        counter = CountingMode(fm)
        counter.track((a, b))
        with counter:
            c = a @ b                                   # 2mnk FLOPs
            mm_bytes = counter.bytes
            d = c + c                                   # 2 reads + 1 write
            add_bytes = counter.bytes - mm_bytes
            e = torch.empty((1000,))                    # allocates, moves nothing
            del e
            f = torch.zeros((250,))                     # writes 1000 bytes
            v = f.view(25, 10)                          # a view: 0 bytes, no new storage
        memory = counter.finish((d, v))
    assert counter.flops == 2 * 64 * 32 * 16
    assert mm_bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert add_bytes == 3 * 64 * 16 * 4
    assert counter.bytes == mm_bytes + add_bytes + 1000
    args = (64 * 32 + 32 * 16) * 4
    # live: args, c, d, then e (4000) on top, freed before f (1000) arrives
    assert memory["argument_bytes"] == args
    assert memory["total_per_device"] == args + 2 * 64 * 16 * 4 + 4000
    assert memory["output_bytes"] == 64 * 16 * 4 + 1000 and memory["alias_bytes"] == 0


def test_counting_mode_sorts_collectives_by_kind_and_link():
    with DR.fake_group((2, 4), ("data", "model"), "cpu") as mesh:
        model, data = mesh.get_group("model"), mesh.get_group("data")
        fm = FakeTensorMode()
        with fm:
            x = torch.empty((8, 4))
            counter = CountingMode(fm)
            with counter:
                dist.all_reduce(x, group=model)                 # ranks 0-3: one node
                out = x.new_empty((16, 4))
                dist.all_gather_into_tensor(out, x, group=data)  # ranks 0, 4
                part = x.new_empty((2, 4))
                dist.reduce_scatter_tensor(part, x, group=model)
    assert counter.collectives == {"all-reduce": 128, "all-gather": 256, "reduce-scatter": 32}
    assert counter.collective_links == {"nvlink": 416, "net": 0}
    with DR.fake_group((2, 8), ("data", "model"), "cpu") as mesh:
        fm = FakeTensorMode()
        with fm:
            x = torch.empty((8, 4))
            counter = CountingMode(fm)
            with counter:
                dist.all_reduce(x, group=mesh.get_group("data"))   # ranks 0, 8: two nodes
    assert counter.collective_links == {"nvlink": 0, "net": 128}
    assert counter.bytes == 0 and counter.flops == 0


def test_counting_mode_refuses_an_op_on_a_dtensor():
    """DTensor would run the op on global shapes first, which the counts
    cannot tell from the step's own ops: the steps compute on blocks."""
    from torch.distributed.tensor import DTensor, Replicate

    with DR.fake_group((2, 4), ("data", "model"), "cpu") as mesh:
        fm = FakeTensorMode()
        with fm:
            x = DTensor.from_local(torch.empty((8, 4)), mesh, [Replicate(), Replicate()],
                                   run_check=False)
            counter = CountingMode(fm)
            with counter, pytest.raises(NotImplementedError, match="DTensor"):
                x + x
            with counter:
                y = x.to_local() + x.to_local()
    assert y.shape == (8, 4) and counter.bytes == 3 * 8 * 4 * 4


# --------------------------------------------------------------------------
# the fake branches
# --------------------------------------------------------------------------

def _raise(*args, **kwargs):
    raise AssertionError("the plain version ran on fake tensors")


def _faked(fm, x):
    return None if x is None else fm.from_tensor(x)


def test_tc_spmv_fake_branch(monkeypatch):
    g = erdos_renyi(300, avg_deg=8.0, seed=1, device="cpu")
    tiled = build_block_tiles(g, tile_size=16)
    T, L = tiled.tile_size, 8
    rhs = torch.rand((tiled.n_block_cols * T, L), generator=torch.Generator().manual_seed(0))
    flags = torch.ones((tiled.n_block_cols,), dtype=torch.int32)
    want = K.tc_spmv(tiled, rhs, col_flags=flags)
    monkeypatch.setattr(K, "tc_spmv_plain", _raise)
    monkeypatch.setattr(K, "_launch", _raise)
    fm = FakeTensorMode()
    fields = {f.name: getattr(tiled, f.name) for f in dataclasses.fields(tiled)}
    with fm:
        fake = dataclasses.replace(tiled, **{k: _faked(fm, v) for k, v in fields.items()
                                             if isinstance(v, torch.Tensor)})
        counter = CountingMode(fm)
        launches = K.tc_spmv.launches
        with counter:
            got = K.tc_spmv(fake, _faked(fm, rhs), col_flags=_faked(fm, flags))
    assert K.tc_spmv.launches == launches
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    rec = counter.kernels["tc_spmv"]
    assert rec.launches == 1
    assert rec.bytes == chip_smoke.bound_spmv(tiled, flags, L, fused=False)[2]
    assert rec.flops == 2 * tiled.n_tiles * T * T * L


def test_bag_fake_branches(monkeypatch):
    gen = torch.Generator().manual_seed(0)
    V, D, B, K_ = 500, 10, 16, 6
    table = torch.randn((V, D), generator=gen)
    idx = torch.randperm(V, generator=gen)[: B * K_].reshape(B, K_).to(torch.int32)
    w = torch.rand((B, K_), generator=gen)
    g_out = torch.randn((B, D), generator=gen)
    extra = torch.randn((B, K_, D), generator=gen)
    fwd = E.embedding_bag(table, idx, w)
    bwd = E.embedding_bag_backward(g_out, idx, w, V, extra=extra)
    plan = E.sort_slots(idx, V)
    for name in ("_bag_sum_plain", "embedding_bag_backward_plain", "sort_slots_plain",
                 "_launch", "_launch_backward"):
        monkeypatch.setattr(E, name, _raise)
    fm = FakeTensorMode()
    with fm:
        ft, fi, fw, fg, fx = (fm.from_tensor(x) for x in (table, idx, w, g_out, extra))
        counter = CountingMode(fm)
        counts = (E.embedding_bag.launches, E.embedding_bag_backward.launches,
                  E.sort_slots.calls)
        with counter:
            got_fwd = E.embedding_bag(ft, fi, fw)
            got_bwd = E.embedding_bag_backward(fg, fi, fw, V, extra=fx)
            got_plan = E.sort_slots(fi, V)
    assert counts == (E.embedding_bag.launches, E.embedding_bag_backward.launches,
                      E.sort_slots.calls)
    assert (got_fwd.shape, got_fwd.dtype) == (fwd.shape, fwd.dtype)
    assert (got_bwd.shape, got_bwd.dtype) == (bwd.shape, bwd.dtype)
    for f in dataclasses.fields(plan):
        a, b = getattr(got_plan, f.name), getattr(plan, f.name)
        assert (a.shape, a.dtype) == (b.shape, b.dtype), f.name
    recs = counter.kernels
    assert recs["embedding_bag"].bytes == chip_smoke.bound_bag(table, idx, w)[0][2]
    assert recs["embedding_bag"].flops == chip_smoke.bound_bag(table, idx, w)[0][3]
    bound = chip_smoke.bound_bag_backward(V, g_out, idx, w, extra)
    assert (recs["embedding_bag_backward"].bytes, recs["embedding_bag_backward"].flops) == \
        (bound[2], bound[3])
    n = B * K_
    assert recs["sort_slots"].bytes == 4 * n + 3 * 4 * n + 4 * (n + 1) + 4


def test_a_wrapper_without_a_fake_branch_refuses_fake_tensors():
    from repro_torch.hopper.launch import on_cpu

    with FakeTensorMode():
        with pytest.raises(ValueError, match="fake"):
            on_cpu(torch.empty(3))


# --------------------------------------------------------------------------
# the round function
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3])
def test_mis_round_k_times_equals_the_reference_at_max_rounds_k(k):
    ref_g = ref_powerlaw(3000, avg_deg=8.0, seed=4)         # 3 rounds
    ref_pri = ref_make_priorities("h3", jax.random.key(3), ref_g.n_nodes, ref_g.degrees())
    mesh = jax.make_mesh((1,), ("shard",))
    want = ref_dist.build_distributed_mis(
        ref_dist.shard_tiled(ref_build_block_tiles(ref_g, tile_size=16), 1), mesh,
        ref_dist.DistConfig(max_rounds=k))(ref_pri)

    sharded = D.shard_tiled(build_block_tiles(_port_graph(ref_g), tile_size=16), 1)
    D.process_group(torch.device("cpu"))
    slab, T, n = sharded.slab(0), sharded.tile_size, sharded.n_padded

    def gather(x):
        return D.gather_bool(x, T)

    def pad(a):
        x = torch.from_numpy(np.asarray(a).copy())
        return torch.nn.functional.pad(x, (0, n - x.shape[0]), value=_NEG)

    pri = Priorities(select=pad(ref_pri.select), resolve=pad(ref_pri.resolve))
    alive = gather(torch.arange(n, dtype=torch.int32) < sharded.n_nodes)
    in_mis = torch.zeros(n, dtype=torch.bool)
    rhs = torch.zeros((n, 8), dtype=torch.float32)
    for _ in range(k):
        alive, in_mis = D.mis_round(slab, gather, pri.select, pri.resolve, alive, in_mis, rhs,
                                    off=0, two_pass=True)
    assert int(want.rounds) == k
    np.testing.assert_array_equal(in_mis.numpy(), np.asarray(want.in_mis))


# --------------------------------------------------------------------------
# end to end
# --------------------------------------------------------------------------

REF_KEYS = {"arch", "shape", "mesh", "kind", "note", "status", "devices", "times", "memory",
            "cost", "cost_method", "roofline", "model_flops_global"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "total_per_device"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant", "step_time_s",
                 "model_flops", "useful_flop_fraction", "mfu"}


@pytest.mark.parametrize("arch, shape, kernels", [
    ("tcmis", "G2", {"tc_spmv"}),
    ("deepfm", "serve_p99", {"embedding_bag"}),
    ("qwen3-0.6b", "decode_32k", set()),
])
def test_run_cell_on_the_production_mesh(tmp_path, arch, shape, kernels):
    from repro_torch.configs import tcmis

    if arch == "tcmis":                 # the stand-in on the CPU
        for T in (128, 64, 32, 16):
            tcmis._occupancy_ratio(shape, T, tcmis.RCM, "cpu")
    rec = DR.run_cell(arch, shape, "single", str(tmp_path), skip_existing=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert REF_KEYS <= set(rec) and {"kernels", "hardware", "torch"} <= set(rec)
    assert set(rec["memory"]) == MEMORY_KEYS and ROOFLINE_KEYS <= set(rec["roofline"])
    assert rec["devices"] == 256 and rec["hardware"] == DR.HARDWARE
    assert set(rec["kernels"]) == kernels
    assert rec["memory"]["total_per_device"] >= rec["memory"]["argument_bytes"] > 0
    assert rec["cost"]["flops"] > 0 and rec["roofline"]["step_time_s"] > 0
    with open(tmp_path / f"{arch}__{shape}__single.json") as f:
        assert json.load(f)["status"] == "ok"
    assert not dist.is_initialized()


@pytest.mark.parametrize("shape", ["minibatch_lg", "molecule"])
def test_gnn_batch_cells_count_the_gradient_all_reduce(tmp_path, shape):
    """The data-parallel GNN cells sum each replicated parameter's gradient
    over the batch ranks: the record counts an all-reduce of at least the
    parameters' bytes, and a collective term."""
    from repro_torch.configs import GNN_ARCHS
    from repro_torch.configs import gnn_cells as G

    rec = DR.run_cell("gin-tu", shape, "single", str(tmp_path), skip_existing=False)
    assert rec["status"] == "ok", rec.get("traceback")
    d_out = 1 if shape == "molecule" else G.GNN_SHAPES[shape]["n_out"]
    model = GNN_ARCHS["gin-tu"].init(G.GNN_SHAPES[shape]["d_feat"], d_out, seed=0,
                                     device="cpu")
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    assert rec["cost"]["collectives"]["all-reduce"] >= param_bytes
    assert rec["roofline"]["collective_s"] > 0
    assert not dist.is_initialized()


_DP_SCRIPT = r"""
import json, sys
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

rank, data = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + data + "/rendezvous", rank=rank,
                        world_size=2)
from repro_torch.configs import GNN_ARCHS, gnn_cells as C
from repro_torch.dist.sharding import local

meta = json.load(open(data + "/meta.json"))
arrays = np.load(data + "/inputs.npz")
args = [torch.from_numpy(arrays[k]) for k in meta["args"]]
args = [x.chunk(2)[rank] if k in meta["split"] else x for k, x in zip(meta["args"], args)]
a = GNN_ARCHS[meta["arch"]]
mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
model = a.init(meta["d_in"], meta["n_out"], seed=0, device="cpu")
params, opt = C.place_gnn_state(C.train_params(model), mesh)
if meta["shape"] == "molecule":
    new, _, loss = C.molecule_step(a, model, params, opt, *args, mesh=mesh)
else:
    u1, u2, *rest = args
    new, _, loss = C.minibatch_step(a, model, params, opt, (u1, u2), *rest, mesh=mesh)
np.savez(data + f"/out{rank}.npz", loss=loss.numpy(),
         **{k: local(v).numpy() for k, v in new.items()})
dist.destroy_process_group()
"""


def _gnn_batch(shape: str):
    """Seeded inputs of a small batch: (arg names in the step's order, the
    names split over the batch ranks, arrays, d_in, n_out)."""
    from repro_torch.graphs.sampler import DRAW_HIGH

    rng = np.random.default_rng(3)
    if shape == "molecule":
        B, N, E, d = 4, 6, 10, 16
        arrays = dict(feats=rng.standard_normal((B, N, d), dtype=np.float32),
                      coords=rng.standard_normal((B, N, 3), dtype=np.float32),
                      senders=rng.integers(0, N, (B, E)).astype(np.int32),
                      receivers=rng.integers(0, N, (B, E)).astype(np.int32),
                      mask=rng.random((B, E)) < 0.8,
                      energy=rng.standard_normal(B).astype(np.float32))
        return list(arrays), list(arrays), arrays, d, 1
    n, deg, d, n_out, B = 40, 5, 8, 5, 4
    arrays = dict(u1=rng.integers(0, DRAW_HIGH, (B, 3)).astype(np.int32),
                  u2=rng.integers(0, DRAW_HIGH, (B, 3, 2)).astype(np.int32),
                  indptr=np.arange(0, n * deg + 1, deg, dtype=np.int32),
                  indices=rng.integers(0, n, n * deg).astype(np.int32),
                  feats=rng.standard_normal((n, d), dtype=np.float32),
                  coords=rng.standard_normal((n, 3), dtype=np.float32),
                  labels=rng.integers(0, n_out, n).astype(np.int32),
                  seeds=rng.choice(n, B, replace=False).astype(np.int32))
    return list(arrays), ["u1", "u2", "seeds"], arrays, d, n_out


@pytest.mark.parametrize("arch, shape", [("gin-tu", "molecule"), ("egnn", "molecule"),
                                         ("gin-tu", "minibatch_lg")])
def test_gnn_batch_step_over_two_ranks_equals_the_whole_batch(tmp_path, arch, shape):
    """`molecule_step(mesh=)` / `minibatch_step(mesh=)` on two gloo ranks,
    each with half the batch, give every rank the one-process step's loss
    and new parameters on the whole batch (f32; rtol 1e-5, atol 1e-6):
    the gradients are summed over the batch ranks."""
    from repro_torch.configs import GNN_ARCHS
    from repro_torch.configs import gnn_cells as G

    names, split, arrays, d_in, n_out = _gnn_batch(shape)
    data = str(tmp_path)
    np.savez(os.path.join(data, "inputs.npz"), **arrays)
    with open(os.path.join(data, "meta.json"), "w") as f:
        json.dump(dict(arch=arch, shape=shape, args=names, split=split, d_in=d_in,
                       n_out=n_out), f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _DP_SCRIPT, str(r), data], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        for p in procs:
            log, _ = p.communicate(timeout=240)
            assert p.returncode == 0, log[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    a = GNN_ARCHS[arch]
    model = a.init(d_in, n_out, seed=0, device="cpu")
    params = G.train_params(model)
    opt = O.adamw_init(params)
    args = [torch.from_numpy(arrays[k]) for k in names]
    if shape == "molecule":
        new, _, loss = G.molecule_step(a, model, params, opt, *args)
    else:
        new, _, loss = G.minibatch_step(a, model, params, opt, tuple(args[:2]), *args[2:])
    for r in range(2):
        got = np.load(os.path.join(data, f"out{r}.npz"))
        np.testing.assert_allclose(got["loss"], loss.numpy(), rtol=1e-5, atol=1e-6)
        for k, v in new.items():
            np.testing.assert_allclose(got[k], v.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("n_shared", [0, 1])
def test_moe_static_buffer_on_one_rank_equals_the_buffer_sized_from_the_routing(n_shared):
    """The dry run's expert buffer at its static bound
    (`MoEConfig.buf_pspec` set) on a one-rank gloo group: the data-parallel
    route's output and drop fraction are those of the buffer sized from
    the routing (one rank's bound holds every kept assignment; f32, rtol
    and atol 1e-6)."""
    from test_torch_lm_moe import _moe_params

    from repro_torch.dist.collectives import DataGroup
    from repro_torch.models import moe as M
    from repro_torch.models.lm_config import MoEConfig

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    rng = np.random.default_rng(5)
    cfg = MoEConfig(n_experts=8, top_k=2, d_expert=8, n_shared=n_shared, capacity_factor=0.5)
    p = {k: torch.from_numpy(v)
         for k, v in _moe_params(rng, 8, 16, 8, n_shared, "swiglu").items()}
    x = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    out, metrics = M.moe_ffn(p, x, cfg, "swiglu", dp=DataGroup(None))
    static = dataclasses.replace(cfg, buf_pspec=(None, ("data",), None))
    out_s, metrics_s = M.moe_ffn(p, x, static, "swiglu", dp=DataGroup(None))
    assert float(metrics.drop_frac) > 0          # capacity binds: some assignments dropped
    np.testing.assert_allclose(out_s.numpy(), out.numpy(), rtol=1e-6, atol=1e-6)
    assert float(metrics_s.drop_frac) == float(metrics.drop_frac)


def test_a_memory_pass_past_its_limit_falls_back_to_two_depths(tmp_path):
    """A full-depth memory pass that runs past `memory_limit` is abandoned;
    the cell's memory then comes from 2- and 4-layer passes, affine in the
    layer count, and the record says so."""
    rec = DR.run_cell("qwen3-0.6b", "decode_32k", "single", str(tmp_path),
                      skip_existing=False, memory_limit=1e-3)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["memory_method"].startswith("affine layer extrapolation L∈{2,4} → 28")
    a, b = rec["memory_samples"]["memory_a"], rec["memory_samples"]["memory_b"]
    want = a["total_per_device"] + (b["total_per_device"] - a["total_per_device"]) * 13
    assert rec["memory"]["total_per_device"] == int(want)
    assert not dist.is_initialized()
