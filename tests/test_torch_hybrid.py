"""The port's hybrid dense/sparse tile routing against the JAX reference.

Partitions are held to the reference's array for array (dense sub-tiling,
its row_starts, the sentinel-padded COO tail) on the same graphs, tile
sizes, storages and thresholds.  Every port engine that routes by a
partition is held to the reference engine of the same name on the same
partition with the reference's priorities (the reference's Pallas engines
run in interpret mode, as its own tests run them on the CPU): the same
MIS, rounds and telemetry buffers.  Then the cases of tests/test_hybrid.py
that need no batching, deltas or disk cache, run on the port: routing is
an execution choice, so `hybrid="forced"` gives exactly the MIS of
`hybrid="off"`.  Everything is exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import SolveOptions as RefOptions
from repro.api import Solver as RefSolver
from repro.api.plan import Plan as RefPlan
from repro.api.plan import plan_cache_key as ref_plan_cache_key
from repro.api.plan import resolve_hybrid_threshold as ref_resolve_hybrid_threshold
from repro.core import heuristics as ref_heur
from repro.core import tiling as ref_tiling
from repro.core.tc_mis import _run_phases_impl, _tc_mis_impl
from repro.graphs.generators import erdos_renyi as ref_erdos_renyi
from repro.graphs.generators import grid2d as ref_grid2d
from repro.graphs.generators import powerlaw as ref_powerlaw
from repro_torch.api import Plan, PlanCache, Solver, SolveOptions, plan_from_arrays
from repro_torch.api import plan as port_plan
from repro_torch.core import engine as port_engine
from repro_torch.core import tiling
from repro_torch.core.heuristics import Priorities
from repro_torch.core.tc_mis import run_phases, run_tc_mis
from repro_torch.core.validate import is_valid_mis
from repro_torch.device import to_torch, words_to_numpy
from repro_torch.graphs import erdos_renyi, powerlaw
from repro_torch.graphs.graph import from_edges
from repro_torch.perf import hybrid_density_threshold
from test_torch_solver import _plan_arrays

HYBRID_ENGINES = ("tiled_ref", "tiled_pallas", "fused_pallas")
# (storage, frontier, phase1): every round body a partition can meet
ROUND_BODIES = [
    ("int8", "dense", "segment"), ("int8", "dense", "tiled"),
    ("bitpack", "dense", "segment"), ("bitpack", "dense", "tiled"),
    ("bitpack", "bitwise", "segment"), ("bitpack", "bitwise", "tiled"),
]
# all-dense (1), mixed (2, 8) and all-but-all-sparse (64), all-sparse (10**6)
THRESHOLDS = (1, 2, 8, 64, 10**6)


def _ref_graph(kind):
    if kind == "powerlaw":
        return ref_powerlaw(384, avg_deg=6.0, seed=11)
    return ref_erdos_renyi(300, avg_deg=5.0, seed=3)


def _port_graph(ref_g):
    """The reference graph's edges handed over as numpy."""
    E = ref_g.n_edges
    return from_edges(np.asarray(ref_g.senders)[:E], np.asarray(ref_g.receivers)[:E],
                      ref_g.n_nodes, device="cpu")


def _tiles_np(t):
    return words_to_numpy(t) if t.dtype == torch.int32 else t.numpy()


def _assert_tiling_equal(got, want):
    np.testing.assert_array_equal(_tiles_np(got.tiles), np.asarray(want.tiles))
    for name in ("tile_rows", "tile_cols", "row_starts"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    for name in ("n_tiles", "n_nodes", "tile_size", "n_block_rows", "n_block_cols", "storage"):
        assert getattr(got, name) == getattr(want, name), name


def _assert_partition_equal(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    for name in ("threshold", "n_dense_tiles", "n_sparse_tiles", "sp_nnz"):
        assert getattr(got, name) == getattr(want, name), name
    _assert_tiling_equal(got.dense, want.dense)
    assert got.dense.partition is None
    # the port keeps the tail's real entries; the reference pads them to a
    # power of two with the sentinel id, which the port's tail never reads
    nnz, n_padded = want.sp_nnz, want.dense.n_padded
    np.testing.assert_array_equal(got.tail_rows.numpy(), np.asarray(want.sp_rows)[:nnz])
    np.testing.assert_array_equal(got.tail_cols.numpy(), np.asarray(want.sp_cols)[:nnz])
    assert got.tail_rows.dtype == got.tail_cols.dtype == torch.int64
    for pad in (np.asarray(want.sp_rows)[nnz:], np.asarray(want.sp_cols)[nnz:]):
        assert nnz + pad.shape[0] == tiling.next_pow2(max(nnz, 8))
        assert (pad == n_padded).all()


def _hybrid_plan_arrays(ref_plan):
    """`_plan_arrays` with the meta record naming the plan's hybrid policy."""
    arrays = _plan_arrays(ref_plan)
    arrays["meta"][8] = ("off", "auto", "forced").index(ref_plan.hybrid)
    arrays["meta"][9] = ref_plan.hybrid_threshold
    return arrays


def _port_priorities(pri):
    return Priorities(torch.tensor(np.asarray(pri.select)),
                      None if pri.resolve is None else torch.tensor(np.asarray(pri.resolve)))


# --------------------------------------------------------------------------
# the partition, array for array
# --------------------------------------------------------------------------

@pytest.mark.parametrize("threshold", THRESHOLDS)
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [16, 32])
@pytest.mark.parametrize("kind", ["powerlaw", "erdos_renyi"])
def test_partition_matches_reference(kind, T, storage, threshold):
    ref_g = _ref_graph(kind)
    ref_tiled = ref_tiling.build_block_tiles(ref_g, tile_size=T, storage=storage)
    tiled = tiling.build_block_tiles(_port_graph(ref_g), tile_size=T, storage=storage)
    np.testing.assert_array_equal(tiling.tile_nnz(tiled), np.asarray(ref_tiling.tile_nnz(ref_tiled)))
    _assert_partition_equal(tiling.partition_tiles(tiled, threshold),
                            ref_tiling.partition_tiles(ref_tiled, threshold))
    for mode in ("forced", "auto"):
        got = tiling.attach_partition(tiled, mode=mode, threshold=threshold)
        want = ref_tiling.attach_partition(ref_tiled, mode=mode, threshold=threshold)
        _assert_partition_equal(got.partition, want.partition)
    assert tiling.attach_partition(got, mode="off").partition is None


@pytest.mark.parametrize("T", [16, 32])
def test_to_storage_rebuilds_the_partition_like_reference(T):
    ref_g = _ref_graph("powerlaw")
    ref_tiled = ref_tiling.attach_partition(
        ref_tiling.build_block_tiles(ref_g, tile_size=T), mode="forced", threshold=8)
    tiled = tiling.attach_partition(
        tiling.build_block_tiles(_port_graph(ref_g), tile_size=T), mode="forced", threshold=8)
    for storage in ("bitpack", "int8"):
        ref_tiled, tiled = ref_tiled.to_storage(storage), tiled.to_storage(storage)
        _assert_tiling_equal(dataclasses.replace(tiled, partition=None),
                             dataclasses.replace(ref_tiled, partition=None))
        _assert_partition_equal(tiled.partition, ref_tiled.partition)


@pytest.mark.parametrize("T", [8, 16, 32, 64])
def test_gather_frontier_bits_matches_reference_on_sentinel_ids(T):
    rng = np.random.default_rng(T)
    nb, W = 7, tiling.packed_words(T)
    words = rng.integers(0, 1 << 32, (nb, W), dtype=np.uint64).astype(np.uint32)
    ids = np.concatenate([rng.integers(0, nb * T, 200), np.full(9, nb * T)]).astype(np.int32)
    want = np.asarray(ref_tiling.gather_frontier_bits(jnp.asarray(words), jnp.asarray(ids), T))
    # the port's tail passes real ids only; a sentinel id reads what the
    # reference's clamped jnp gather reads, the last block at its slot
    clamped = np.minimum(ids // T, nb - 1) * T + ids % T
    slots = tiling.frontier_bit_slots(to_torch(clamped, "cpu"), T)
    got = tiling.gather_frontier_bits(to_torch(words, "cpu"), slots)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["forced", "auto"])
def test_plan_from_arrays_reattaches_the_partition(mode):
    ref_plan = RefPlan.build(_ref_graph("powerlaw"), tile_size=16, storage="bitpack",
                             hybrid=mode, hybrid_threshold=8)
    assert ref_plan.tiled.partition is not None
    plan = plan_from_arrays(_hybrid_plan_arrays(ref_plan), device="cpu")
    assert (plan.hybrid, plan.hybrid_threshold) == (mode, 8)
    _assert_partition_equal(plan.tiled.partition, ref_plan.tiled.partition)
    off = plan_from_arrays(_plan_arrays(ref_plan), device="cpu")
    assert off.tiled.partition is None and off.hybrid == "off"


# --------------------------------------------------------------------------
# engines: the reference engine of the same name, same partition
# --------------------------------------------------------------------------

@pytest.mark.parametrize("storage, frontier, phase1", ROUND_BODIES)
@pytest.mark.parametrize("engine", HYBRID_ENGINES)
def test_hybrid_engine_matches_reference_engine(engine, storage, frontier, phase1):
    ref_g = _ref_graph("powerlaw")
    kw = dict(engine=engine, frontier=frontier, phase1=phase1)
    for thr in (8, 64):
        ref_plan = RefPlan.build(ref_g, tile_size=32, storage=storage, hybrid="forced",
                                 hybrid_threshold=thr)
        pri = ref_heur.make_priorities("h3", jax.random.key(7), ref_g.n_nodes,
                                       ref_plan.g.degrees())
        want = _tc_mis_impl(ref_plan.g, ref_plan.tiled, jax.random.key(7), RefOptions(**kw),
                            priorities=pri)
        plan = plan_from_arrays(_hybrid_plan_arrays(ref_plan), device="cpu")
        assert plan.tiled.partition is not None
        got = run_tc_mis(plan.g, plan.tiled, None, SolveOptions(**kw),
                         priorities=_port_priorities(pri))
        np.testing.assert_array_equal(got.in_mis.numpy(), np.asarray(want.in_mis))
        assert int(got.rounds) == int(want.rounds)
        assert bool(got.converged) and is_valid_mis(plan.g, got.in_mis)


@pytest.mark.parametrize("engine, frontier, phase1",
                         [(e, f, p) for e in HYBRID_ENGINES
                          for f, p in (("dense", "segment"), ("dense", "tiled"),
                                       ("bitwise", "tiled"))])
def test_hybrid_telemetry_and_twin_equal_reference(engine, frontier, phase1):
    """The telemetry buffer of a partitioned solve (tiles skipped and
    dispatched over the dense partition, the tail's tile count), fill rows
    included, and the profiler twin's result."""
    ref_plan = RefPlan.build(_ref_graph("powerlaw"), tile_size=16, storage="bitpack",
                             hybrid="forced", hybrid_threshold=8)
    pri = ref_heur.make_priorities("h3", jax.random.key(7), ref_plan.g.n_nodes,
                                   ref_plan.g.degrees())
    kw = dict(engine=engine, frontier=frontier, phase1=phase1)
    want, want_buf = _tc_mis_impl(ref_plan.g, ref_plan.tiled, jax.random.key(7),
                                  RefOptions(telemetry=True, **kw), priorities=pri)
    plan = plan_from_arrays(_hybrid_plan_arrays(ref_plan), device="cpu")
    got, buf = run_tc_mis(plan.g, plan.tiled, None, SolveOptions(telemetry=True, **kw),
                          priorities=_port_priorities(pri))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(want_buf))
    np.testing.assert_array_equal(got.in_mis.numpy(), np.asarray(want.in_mis))
    assert (np.asarray(want_buf)[: int(want.rounds), 5] == plan.tiled.partition.n_sparse_tiles).all()

    ref_twin, _ = _run_phases_impl(ref_plan.g, ref_plan.tiled, jax.random.key(7),
                                   RefOptions(**kw), priorities=pri)
    twin, times = run_phases(plan.g, plan.tiled, None, SolveOptions(**kw),
                             priorities=_port_priorities(pri))
    np.testing.assert_array_equal(twin.in_mis.numpy(), np.asarray(ref_twin.in_mis))
    assert int(twin.rounds) == int(ref_twin.rounds) == times["rounds"]


def test_default_options_plan_and_solve_like_reference():
    """`SolveOptions()` as it is: auto-T, auto storage, `hybrid="auto"` at
    the cost model's threshold, the fused engine.  A 3,600-vertex grid
    plans T = 128 bitpack at threshold 640, and every tile goes to the COO
    tail, as G2 does at T = 16: the partition holds no dense tile."""
    ref_g = ref_grid2d(60, 60)
    ref_solver = RefSolver(options=RefOptions())
    ref_plan = ref_solver.plan(ref_g)
    solver = Solver(device="cpu")
    plan = solver.plan(_port_graph(ref_g))
    assert (plan.tile_size, plan.storage) == (ref_plan.tile_size, ref_plan.storage) == (128, "bitpack")
    assert plan.key == ref_plan.key
    assert (plan.hybrid, plan.hybrid_threshold) == ("auto", 640)
    _assert_partition_equal(plan.tiled.partition, ref_plan.tiled.partition)
    assert plan.tiled.partition.n_dense_tiles == 0 and plan.tiled.partition.dense.n_tiles == 0

    want = ref_solver.solve(ref_plan)
    pri = ref_heur.make_priorities("h3", jax.random.key(0), ref_g.n_nodes, ref_plan.g.degrees())
    got = run_tc_mis(plan.g, plan.tiled, None, SolveOptions(), priorities=_port_priorities(pri))
    np.testing.assert_array_equal(got.in_mis.numpy(), np.asarray(want.in_mis))
    assert int(got.rounds) == want.rounds
    res = solver.solve(plan)
    assert res.converged and is_valid_mis(plan.g, torch.from_numpy(res.in_mis_plan))


# --------------------------------------------------------------------------
# tests/test_hybrid.py's cases, on the port
# --------------------------------------------------------------------------

def _mis(g, **kw):
    return Solver(SolveOptions(**kw), device="cpu").solve(g).in_mis


@pytest.mark.parametrize("storage, frontier",
                         [("int8", "dense"), ("bitpack", "dense"), ("bitpack", "bitwise")])
@pytest.mark.parametrize("engine", HYBRID_ENGINES)
def test_hybrid_bit_identity(engine, storage, frontier):
    g = powerlaw(384, avg_deg=6.0, seed=11, device="cpu")
    kw = dict(engine=engine, storage=storage, frontier=frontier, tile_size=32)
    ref = _mis(g, hybrid="off", **kw)
    for thr in (2, 64):       # a mixed partition and a (nearly) all-sparse one
        np.testing.assert_array_equal(_mis(g, hybrid="forced", hybrid_threshold=thr, **kw), ref)


def test_hybrid_all_sparse_and_all_dense_extremes():
    g = erdos_renyi(300, avg_deg=5.0, seed=3, device="cpu")
    ref = _mis(g, engine="tiled_ref", tile_size=32, hybrid="off")
    for thr in (1, 10**6):
        got = _mis(g, engine="tiled_ref", tile_size=32, hybrid="forced", hybrid_threshold=thr)
        np.testing.assert_array_equal(got, ref)


def test_segment_engine_never_partitions():
    g = erdos_renyi(200, avg_deg=4.0, seed=1, device="cpu")
    s = Solver(SolveOptions(engine="segment", hybrid="forced", hybrid_threshold=4),
               device="cpu")
    assert s.plan(g).tiled.partition is None
    np.testing.assert_array_equal(s.solve(g).in_mis, _mis(g, engine="segment", hybrid="off"))
    assert not port_engine.get_engine("segment").supports_hybrid


def test_partition_tiles_exactly_covers_stored_nonzeros():
    g = powerlaw(256, avg_deg=8.0, seed=7, device="cpu")
    tiled = tiling.build_block_tiles(g, tile_size=32)
    nnz = tiling.tile_nnz(tiled)[: tiled.n_tiles]
    thr = 16
    part = tiling.partition_tiles(tiled, thr)
    assert part.threshold == thr
    assert part.n_dense_tiles == int((nnz >= thr).sum())
    assert part.n_sparse_tiles == int(((nnz > 0) & (nnz < thr)).sum())
    assert part.sp_nnz == int(nnz[(nnz > 0) & (nnz < thr)].sum())
    dn = tiling.tile_nnz(part.dense)[: part.dense.n_tiles]
    assert part.dense.n_tiles == part.n_dense_tiles and (dn >= thr).all()
    sp_r, sp_c, n_pad = part.tail_rows.numpy(), part.tail_cols.numpy(), tiled.n_padded
    assert sp_r.shape == sp_c.shape == (part.sp_nnz,)
    assert (sp_r < n_pad).all() and (sp_c < n_pad).all()
    assert int(dn.sum()) + part.sp_nnz == int(nnz.sum())


def test_partition_deterministic_and_padding_excluded():
    g = erdos_renyi(200, avg_deg=6.0, seed=5, device="cpu")
    tiled = tiling.build_block_tiles(g, tile_size=32)
    p1, p2 = tiling.partition_tiles(tiled, 8), tiling.partition_tiles(tiled, 8)
    assert torch.equal(p1.tail_rows, p2.tail_rows) and torch.equal(p1.dense.tiles, p2.dense.tiles)
    assert p1.n_dense_tiles + p1.n_sparse_tiles <= tiled.n_tiles <= tiled.n_tiles_pad


def test_invalid_hybrid_options_rejected():
    with pytest.raises(ValueError, match="hybrid"):
        SolveOptions(hybrid="sometimes")
    with pytest.raises(ValueError, match="hybrid_threshold"):
        SolveOptions(hybrid_threshold=0)
    tiled = tiling.build_block_tiles(erdos_renyi(64, seed=2, device="cpu"), tile_size=32)
    with pytest.raises(ValueError, match="hybrid mode"):
        tiling.attach_partition(tiled, mode="sometimes")


def test_threshold_resolution_prefers_override():
    assert port_plan.resolve_hybrid_threshold(64, "int8", 7) == 7
    for T in (16, 32, 64, 128):
        for storage in ("int8", "bitpack"):
            auto = port_plan.resolve_hybrid_threshold(T, storage, None)
            assert auto == hybrid_density_threshold(T, storage) > 0
            assert auto == ref_resolve_hybrid_threshold(T, storage, None)


def test_auto_gate_skips_tiny_tilings():
    tiled = tiling.build_block_tiles(erdos_renyi(64, avg_deg=4.0, seed=2, device="cpu"),
                                     tile_size=32)
    assert tiling.attach_partition(tiled, mode="auto", threshold=8).partition is None
    assert tiling.attach_partition(tiled, mode="forced", threshold=8).partition is not None


def test_off_mode_cache_key_is_byte_identical_to_legacy():
    g = erdos_renyi(100, avg_deg=4.0, seed=1, device="cpu")
    ref_g = ref_erdos_renyi(100, avg_deg=4.0, seed=1)
    legacy = port_plan.plan_cache_key(g, 32, "none", "int8")
    assert port_plan.plan_cache_key(g, 32, "none", "int8", hybrid="off",
                                    hybrid_threshold=0) == legacy
    hy = port_plan.plan_cache_key(g, 32, "none", "int8", hybrid="forced", hybrid_threshold=8)
    assert hy != legacy
    assert port_plan.plan_cache_key(g, 32, "none", "int8", hybrid="forced",
                                    hybrid_threshold=9) != hy
    assert hy == ref_plan_cache_key(ref_g, 32, "none", "int8", hybrid="forced",
                                    hybrid_threshold=8)
    # a plan cache keys the policy: one graph, two entries
    cache = PlanCache(tile_size=32, device="cpu")
    a, _ = cache.plan(g, hybrid="forced", hybrid_threshold=8)
    b, _ = cache.plan(g)
    assert a.key == port_plan.plan_cache_key(g, 32, None, "int8", "forced", 8)
    assert b.key == port_plan.plan_cache_key(g, 32, None, "int8")
    assert cache.stats["misses"] == 2
    assert Plan.build(g, tile_size=32, hybrid="forced", hybrid_threshold=8, cache=cache) is a


def test_telemetry_reports_routing_split():
    g = powerlaw(300, avg_deg=6.0, seed=14, device="cpu")
    s = Solver(SolveOptions(engine="tiled_ref", tile_size=32, hybrid="forced",
                            hybrid_threshold=8, telemetry=True), device="cpu")
    res = s.solve(g)
    part = s.plan(g).tiled.partition
    rt = res.telemetry
    rt.check_invariants()
    assert rt.rounds == res.rounds and len(rt.tiles_sparse) == rt.rounds
    for dense_n, sparse_n in zip(rt.tiles_dense, rt.tiles_sparse):
        assert sparse_n == part.n_sparse_tiles
        assert 0 <= dense_n <= part.dense.n_tiles_pad
    np.testing.assert_array_equal(res.in_mis, _mis(g, engine="tiled_ref", tile_size=32,
                                                   hybrid="off"))


@pytest.mark.parametrize("engine", HYBRID_ENGINES)
def test_profile_runs_on_a_hybrid_plan(engine):
    g = powerlaw(300, avg_deg=6.0, seed=14, device="cpu")
    for frontier, phase1 in (("dense", "segment"), ("bitwise", "tiled")):
        solver = Solver(SolveOptions(engine=engine, tile_size=16, storage="bitpack",
                                     frontier=frontier, phase1=phase1, hybrid="forced",
                                     hybrid_threshold=8), device="cpu")
        assert solver.plan(g).tiled.partition is not None
        want = solver.solve(g)
        got, times = solver.profile(g)
        np.testing.assert_array_equal(got.in_mis, want.in_mis)
        assert got.rounds == want.rounds == times["rounds"]
