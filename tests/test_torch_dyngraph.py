"""The port's dynamic-graph route against the JAX reference: `EdgeDelta`
(canonical pairs, `content_key`, inverse, mapping), the edge-list and
tile-local patches (`apply_graph_delta`, `apply_delta` on both paths, both
storages, T ∈ {16, 32}, under hybrid "forced" and "auto"), the patched
plan (`patch_plan`: epoch, delta-chained key, RCM mapping, the auto gate),
the warm state and the repaired result (`warm_start`, `repair_solution`
against the reference's `warm_state`, `repair_mis` with the reference's
priorities, every engine and both frontiers), `Solver.update`'s contract,
the drift gauges, the parsers and the streaming readers.

Every comparison is exact: masks, words, int arrays, keys and rounds.  The
reference's Pallas engines run in interpret mode, as its own tests run
them on the CPU."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import SolveOptions as RefOptions
from repro.api.plan import Plan as RefPlan
from repro.api.plan import delta_cache_key as ref_delta_cache_key
from repro.api.plan import patch_plan as ref_patch_plan
from repro.core import heuristics as ref_heur
from repro.core import tiling as ref_tiling
from repro.core.tc_mis import _tc_mis_impl
from repro.dyngraph import drift as ref_drift
from repro.dyngraph import stream as ref_stream
from repro.dyngraph.delta import EdgeDelta as RefDelta
from repro.dyngraph.delta import random_delta as ref_random_delta
from repro.dyngraph.repair import repair_mis as ref_repair_mis
from repro.dyngraph.repair import warm_state as ref_warm_state
from repro.dyngraph.retile import apply_delta as ref_apply_delta
from repro.dyngraph.retile import apply_graph_delta as ref_apply_graph_delta
from repro.graphs.generators import erdos_renyi as ref_erdos_renyi
from repro.graphs.generators import powerlaw as ref_powerlaw
from repro.obs import metrics as ref_metrics
from repro.serve_mis import io as ref_io
from repro_torch.api import Plan, Solver, SolveOptions, delta_cache_key, patch_plan
from repro_torch.core import tiling
from repro_torch.core.engine import engine_names
from repro_torch.core.heuristics import Priorities
from repro_torch.core.tc_mis import run_tc_mis
from repro_torch.core.validate import is_valid_mis
from repro_torch.device import words_to_numpy
from repro_torch.dyngraph import (
    EdgeDelta,
    apply_delta,
    apply_graph_delta,
    dirty_mask,
    drift,
    iter_edges,
    load_delta,
    load_graph_stream,
    parse_delta,
    random_delta,
    repair_solution,
    warm_start,
)
from repro_torch.graphs.graph import from_edges
from repro_torch.obs import metrics
from repro_torch.serve_mis import io
from test_torch_hybrid import _assert_partition_equal, _assert_tiling_equal, _port_graph

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
PORT_ENGINES = ("segment", "tiled_ref", "tiled_pallas", "fused_pallas")
# (engine, frontier, phase1): the dense frontier with the segment max and
# the packed words with the tiled max; the segment engine has no words
REPAIR_CASES = [(e, f, p) for e in PORT_ENGINES
                for f, p in (("dense", "segment"), ("bitwise", "tiled"))
                if e != "segment" or f == "dense"]


def _ref_delta(d):
    return RefDelta(add=d.add, remove=d.remove)


def _ref_graph(kind="er"):
    if kind == "powerlaw":
        return ref_powerlaw(300, avg_deg=6.0, seed=12)
    return ref_erdos_renyi(150, avg_deg=5.0, seed=2)


def _assert_graph_equal(got, want):
    assert (got.n_nodes, got.n_edges) == (want.n_nodes, want.n_edges)
    E = want.n_edges
    np.testing.assert_array_equal(got.senders[:E].numpy(), np.asarray(want.senders)[:E])
    np.testing.assert_array_equal(got.receivers[:E].numpy(), np.asarray(want.receivers)[:E])


def _assert_tiled_equal(got, want):
    """The port's tiling against the reference's, partition included."""
    _assert_tiling_equal(dataclasses.replace(got, partition=None),
                         dataclasses.replace(want, partition=None))
    _assert_partition_equal(got.partition, want.partition)


def _assert_same_tiling(a, b):
    """Two port tilings, array for array, partition included."""
    for name in ("tiles", "tile_rows", "tile_cols", "row_starts"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for name in ("n_tiles", "n_nodes", "tile_size", "n_block_rows", "n_block_cols", "storage"):
        assert getattr(a, name) == getattr(b, name), name
    assert (a.partition is None) == (b.partition is None)
    if a.partition is not None:
        pa, pb = a.partition, b.partition
        assert (pa.threshold, pa.n_dense_tiles, pa.n_sparse_tiles, pa.sp_nnz) == \
            (pb.threshold, pb.n_dense_tiles, pb.n_sparse_tiles, pb.sp_nnz)
        _assert_same_tiling(pa.dense, pb.dense)
        for x, y in zip((pa.tail_rows, pa.tail_cols, *pa.tail_bits),
                        (pb.tail_rows, pb.tail_cols, *pb.tail_bits)):
            assert torch.equal(x, y)


# --------------------------------------------------------------------------
# EdgeDelta
# --------------------------------------------------------------------------

def test_delta_canonicalises_and_keys_like_reference():
    raw = ([3, 1, 1, 2, 5], [1, 3, 1, 4, 5], [7], [6])
    d, ref = EdgeDelta.make(*raw), RefDelta.make(*raw)
    np.testing.assert_array_equal(d.add, ref.add)
    np.testing.assert_array_equal(d.remove, ref.remove)
    np.testing.assert_array_equal(d.touched(), ref.touched())
    assert (d.n_add, d.n_remove, d.is_empty) == (2, 1, False)
    assert d.content_key == ref.content_key
    assert d.inverse().content_key == ref.inverse().content_key != d.content_key
    assert EdgeDelta.make([6, 2], [5, 1], [9], [8]).content_key == \
        EdgeDelta.make([1, 5], [2, 6], [8], [9]).content_key
    assert EdgeDelta.make().content_key == RefDelta.make().content_key
    mapping = np.array([7, 6, 5, 4, 3, 2, 1, 0])
    assert d.mapped(mapping).content_key == ref.mapped(mapping).content_key
    with pytest.raises(ValueError, match="both add and remove"):
        EdgeDelta.make([1], [2], [2], [1])
    with pytest.raises(ValueError, match="grow the vertex set"):
        EdgeDelta.make([1], [99]).check_bounds(50)


@pytest.mark.parametrize("n_add, n_remove, seed", [(5, 5, 1), (12, 0, 3), (0, 9, 7)])
def test_random_delta_equals_reference(n_add, n_remove, seed):
    ref_g = _ref_graph()
    d = random_delta(_port_graph(ref_g), n_add=n_add, n_remove=n_remove, seed=seed)
    want = ref_random_delta(ref_g, n_add=n_add, n_remove=n_remove, seed=seed)
    assert d.content_key == want.content_key
    np.testing.assert_array_equal(d.add, want.add)
    np.testing.assert_array_equal(d.remove, want.remove)


# --------------------------------------------------------------------------
# the edge list and the tiling
# --------------------------------------------------------------------------

def test_apply_graph_delta_equals_reference_and_is_strict():
    ref_g = _ref_graph()
    g = _port_graph(ref_g)
    d = random_delta(g, n_add=5, n_remove=5, seed=1)
    g2 = apply_graph_delta(g, d)
    _assert_graph_equal(g2, ref_apply_graph_delta(ref_g, _ref_delta(d)))
    with pytest.raises(ValueError, match="already in the graph"):
        apply_graph_delta(g2, EdgeDelta(add=d.add, remove=np.zeros((0, 2), np.int64)))
    with pytest.raises(ValueError, match="not in the graph"):
        apply_graph_delta(g2, EdgeDelta(add=np.zeros((0, 2), np.int64), remove=d.remove))
    _assert_graph_equal(apply_graph_delta(g2, d.inverse()), ref_g)
    assert apply_graph_delta(g, EdgeDelta.make()) is g


def _structural_delta(g, T):
    """Empties the first block pair's tile and adds an edge in a far corner
    block (a drained tile and an inserted one)."""
    s, r = g.senders[: g.n_edges].numpy(), g.receivers[: g.n_edges].numpy()
    first = (s // T == 0) & (r // T == 0)
    return EdgeDelta.make([0], [g.n_nodes - 1], s[first], r[first])


def _fast_delta(g, T=16):
    """Removes one of a tile's two or more edges and adds a non-edge in the
    same tile: no tile drains or appears (at T and at any larger T)."""
    s, r = g.senders[: g.n_edges].numpy(), g.receivers[: g.n_edges].numpy()
    fwd = [(int(a), int(b)) for a, b in zip(s, r) if a < b]
    tiles = {}
    for a, b in fwd:
        tiles.setdefault((a // T, b // T), []).append((a, b))
    (i, j), edges = next(kv for kv in sorted(tiles.items()) if len(kv[1]) >= 2)
    have = set(fwd)
    absent = next((a, b) for a in range(i * T, i * T + T) for b in range(j * T, j * T + T)
                  if a < b and (a, b) not in have)
    return EdgeDelta.make([absent[0]], [absent[1]], [edges[0][0]], [edges[0][1]])


@pytest.mark.parametrize("hybrid", ["off", "forced", "auto"])
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [16, 32])
def test_apply_delta_equals_reference_and_rebuild(T, storage, hybrid):
    """Random, structural and fast-path deltas: the port's patched tiling
    equals the reference's patched tiling and a rebuild of the mutated
    graph, array for array, the partition and `tail_bits` included."""
    ref_g = _ref_graph("powerlaw")
    g = _port_graph(ref_g)
    tiled = tiling.build_block_tiles(g, tile_size=T, storage=storage)
    ref_tiled = ref_tiling.build_block_tiles(ref_g, tile_size=T, storage=storage)
    if hybrid != "off":
        tiled = tiling.attach_partition(tiled, mode=hybrid, threshold=16)
        ref_tiled = ref_tiling.attach_partition(ref_tiled, mode=hybrid, threshold=16)
        assert tiled.partition is not None
    for d in (random_delta(g, n_add=12, n_remove=9, seed=3), _structural_delta(g, T),
              _fast_delta(g)):
        got = apply_delta(tiled, d)
        want = ref_apply_delta(ref_tiled, _ref_delta(d))
        _assert_tiled_equal(got, want)
        rebuilt = tiling.build_block_tiles(apply_graph_delta(g, d), tile_size=T,
                                           storage=storage)
        if got.partition is not None:
            rebuilt = dataclasses.replace(
                rebuilt, partition=tiling.partition_tiles(rebuilt, 16))
        _assert_same_tiling(got, rebuilt)
        restored = apply_delta(got, d.inverse())
        _assert_tiled_equal(restored, ref_apply_delta(want, _ref_delta(d).inverse()))
        _assert_same_tiling(restored, tiled)


def test_apply_delta_fast_path_keeps_the_index_tensors():
    g = _port_graph(_ref_graph())
    tiled = tiling.build_block_tiles(g, tile_size=16, storage="bitpack")
    patched = apply_delta(tiled, _fast_delta(g))
    assert patched.tile_rows is tiled.tile_rows
    assert patched.tile_cols is tiled.tile_cols
    assert patched.row_starts is tiled.row_starts
    assert patched.tiles is not tiled.tiles            # edited on a copy
    assert apply_delta(tiled, EdgeDelta.make()) is tiled


def test_apply_delta_on_an_edgeless_graph_matches_reference():
    for n in (1, 40):
        ref_g = ref_erdos_renyi(n, avg_deg=0.0, seed=0)
        g = _port_graph(ref_g)
        for storage in ("int8", "bitpack"):
            tiled = tiling.build_block_tiles(g, tile_size=16, storage=storage)
            d = EdgeDelta.make([0], [n - 1]) if n > 1 else EdgeDelta.make()
            got = apply_delta(tiled, d)
            want = ref_apply_delta(
                ref_tiling.build_block_tiles(ref_g, tile_size=16, storage=storage),
                _ref_delta(d))
            _assert_tiled_equal(got, want)
            if n > 1:
                _assert_tiled_equal(apply_delta(got, d.inverse()),
                                    ref_apply_delta(want, _ref_delta(d).inverse()))


# --------------------------------------------------------------------------
# the patched plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reorder", [None, "rcm"])
@pytest.mark.parametrize("hybrid", ["off", "forced", "auto"])
def test_patch_plan_equals_reference(hybrid, reorder):
    ref_g = _ref_graph("powerlaw")
    kw = dict(tile_size=16, reorder=reorder, storage="bitpack", hybrid=hybrid,
              hybrid_threshold=8)
    ref_plan = RefPlan.build(ref_g, **kw)
    plan = Plan.build(_port_graph(ref_g), **kw)
    assert plan.key == ref_plan.key and plan.graph_key == ref_plan.graph_key
    assert plan.occupancy0 == ref_plan.occupancy0 and plan.epoch == 0
    d = random_delta(_port_graph(ref_g), n_add=20, n_remove=20, seed=5)
    p1 = patch_plan(plan, d)
    want = ref_patch_plan(ref_plan, _ref_delta(d))
    assert p1.key == want.key == delta_cache_key(plan.key, d.content_key)
    assert p1.key == ref_delta_cache_key(ref_plan.key, d.content_key)
    assert (p1.epoch, p1.hybrid, p1.hybrid_threshold) == (1, hybrid, 8 * (hybrid != "off"))
    assert p1.graph_key == want.graph_key
    _assert_graph_equal(p1.g, want.g)
    _assert_tiled_equal(p1.tiled, want.tiled)
    if reorder:
        np.testing.assert_array_equal(p1.perm, want.perm)
    assert plan.apply_delta(EdgeDelta.make()) is plan
    p2 = p1.apply_delta(d.inverse())
    assert p2.epoch == 2 and p2.key != plan.key
    _assert_same_tiling(p2.tiled, plan.tiled)


def test_patch_plan_reruns_the_auto_gate_like_reference():
    """A small graph under the auto gate (no partition: under 16 tiles)
    grows over it with a delta of far-apart edges, and back."""
    ref_g = ref_erdos_renyi(60, avg_deg=1.0, seed=4)
    g = _port_graph(ref_g)
    kw = dict(tile_size=8, storage="int8", hybrid="auto", hybrid_threshold=64)
    plan, ref_plan = Plan.build(g, **kw), RefPlan.build(ref_g, **kw)
    _assert_tiled_equal(plan.tiled, ref_plan.tiled)
    d = random_delta(g, n_add=40, n_remove=0, seed=9)
    p1, want = patch_plan(plan, d), ref_patch_plan(ref_plan, _ref_delta(d))
    _assert_tiled_equal(p1.tiled, want.tiled)
    back = patch_plan(p1, d.inverse())
    _assert_tiled_equal(back.tiled, ref_patch_plan(want, _ref_delta(d).inverse()).tiled)
    assert (plan.tiled.partition is None) == (back.tiled.partition is None)


def test_drift_gauges_equal_reference():
    ref_g = _ref_graph()
    g = _port_graph(ref_g)
    d = random_delta(g, n_add=7, n_remove=4, seed=2)
    assert drift.touched_tile_count(d, 16, 10) == ref_drift.touched_tile_count(d, 16, 10)
    assert drift.dirty_vertex_frac(d, 150) == ref_drift.dirty_vertex_frac(d, 150)
    assert drift.tile_occupancy(900, 37, 16) == ref_drift.tile_occupancy(900, 37, 16)
    before = metrics.REGISTRY.counter("dyngraph.epochs").value
    p1 = patch_plan(Plan.build(g, tile_size=16), d)
    ref_patch_plan(RefPlan.build(ref_g, tile_size=16), _ref_delta(d))
    assert metrics.REGISTRY.counter("dyngraph.epochs").value == before + 1
    gauges = ("dyngraph.epoch", "dyngraph.touched_frac", "dyngraph.dirty_frac",
              "dyngraph.occupancy", "dyngraph.locality_decay")
    for name in gauges:   # a gauge holds the last patch's value
        assert metrics.REGISTRY.gauge(name).value == ref_metrics.REGISTRY.gauge(name).value, name
    assert metrics.REGISTRY.gauge("dyngraph.epoch").value == p1.epoch == 1


# --------------------------------------------------------------------------
# the warm state and the repair
# --------------------------------------------------------------------------

def _repair_case(storage):
    """(reference patched plan, port patched plan, reference key, the
    reference's priorities on the patched graph, the prior MIS on the
    pre-delta graph, the dirty mask) for one delta."""
    ref_g = _ref_graph("powerlaw")
    ref_plan = RefPlan.build(ref_g, tile_size=16, storage=storage)
    key = jax.random.key(3)
    prior = np.asarray(_tc_mis_impl(ref_plan.g, ref_plan.tiled, key,
                                    RefOptions(engine="tiled_ref")).in_mis)
    d = random_delta(_port_graph(ref_g), n_add=6, n_remove=6, seed=13)
    ref_p1 = ref_patch_plan(ref_plan, _ref_delta(d))
    p1 = patch_plan(Plan.build(_port_graph(ref_g), tile_size=16, storage=storage), d)
    pri = ref_heur.make_priorities("h3", key, ref_p1.g.n_nodes, ref_p1.g.degrees())
    dirty = dirty_mask(ref_g.n_nodes, d.touched())
    return ref_p1, p1, key, pri, prior, dirty


def _port_pri(pri):
    return Priorities(torch.tensor(np.asarray(pri.select)),
                      None if pri.resolve is None else torch.tensor(np.asarray(pri.resolve)))


def _np(x):
    return words_to_numpy(x) if x.dtype == torch.int32 else x.numpy()


@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("engine, frontier, phase1", REPAIR_CASES)
def test_warm_state_and_repair_equal_reference(engine, frontier, phase1, storage):
    ref_p1, p1, key, pri, prior, dirty = _repair_case(storage)
    kw = dict(engine=engine, frontier=frontier, phase1=phase1)
    ref_opts, opts = RefOptions(**kw), SolveOptions(**kw)
    want_alive, want_mis = ref_warm_state(ref_p1.g, ref_p1.tiled, ref_opts,
                                          jnp.asarray(prior), jnp.asarray(dirty))
    alive, mis = warm_start(p1.g, p1.tiled, opts, torch.tensor(prior),
                            torch.tensor(dirty))
    np.testing.assert_array_equal(_np(alive), np.asarray(want_alive))
    np.testing.assert_array_equal(_np(mis), np.asarray(want_mis))
    want = ref_repair_mis(ref_p1.g, ref_p1.tiled, key, ref_opts, jnp.asarray(prior),
                          jnp.asarray(dirty), priorities=pri)
    got = run_tc_mis(p1.g, p1.tiled, None, opts, priorities=_port_pri(pri),
                     alive0=alive, in_mis0=mis)
    via = repair_solution(p1.g, p1.tiled, None, opts, torch.tensor(prior),
                          torch.tensor(dirty), priorities=_port_pri(pri))
    np.testing.assert_array_equal(got.in_mis.numpy(), np.asarray(want.in_mis))
    np.testing.assert_array_equal(via.in_mis.numpy(), np.asarray(want.in_mis))
    assert int(got.rounds) == int(via.rounds) == int(want.rounds)
    assert bool(got.converged) and is_valid_mis(p1.g, got.in_mis)


def test_warm_state_on_a_hybrid_plan_covers_the_full_tiling():
    """Under a partition with no dense tile, the covered pass still runs on
    the full tiling (the empty dense half would cover nothing)."""
    ref_p1, p1, key, pri, prior, dirty = _repair_case("bitpack")
    part = tiling.attach_partition(p1.tiled, mode="forced", threshold=10**6)
    assert part.partition.n_dense_tiles == 0
    opts = SolveOptions(engine="fused_pallas")
    want_alive, _ = ref_warm_state(ref_p1.g, ref_p1.tiled, RefOptions(engine="fused_pallas"),
                                   jnp.asarray(prior), jnp.asarray(dirty))
    alive, _ = warm_start(p1.g, part, opts, torch.tensor(prior), torch.tensor(dirty))
    np.testing.assert_array_equal(alive.numpy(), np.asarray(want_alive))


# --------------------------------------------------------------------------
# Solver.update (tests/test_dyngraph.py's contract, on the port)
# --------------------------------------------------------------------------

def _solver(**kw):
    return Solver(SolveOptions(**kw), device="cpu")


@pytest.mark.parametrize("engine", engine_names())
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
def test_repair_valid_and_empty_delta_bit_identical(engine, storage):
    g = _port_graph(ref_erdos_renyi(90, avg_deg=5.0, seed=12))
    solver = _solver(engine=engine, tile_size=8, storage=storage, repair="incremental",
                     phase1="tiled")
    prior = solver.solve(g)
    res = solver.update(prior, random_delta(g, n_add=6, n_remove=6, seed=13))
    assert res.stats["repair"] == "incremental" and res.stats["patch"] == "built"
    assert res.plan.epoch == res.stats["plan_epoch"] == 1
    assert (res.stats["delta_add"], res.stats["delta_remove"]) == (6, 6)
    assert res.converged and is_valid_mis(res.plan.g, torch.from_numpy(res.in_mis_plan))
    res0 = solver.update(prior, EdgeDelta.make())
    assert res0.rounds == 0 and res0.stats["patch"] == "mem"
    np.testing.assert_array_equal(res0.in_mis, prior.in_mis)


@pytest.mark.parametrize("repair", ["incremental", "cold"])
@pytest.mark.parametrize("engine", ["tiled_ref", "fused_pallas"])
def test_solver_update_matches_reference_from_the_seed(engine, repair):
    """A solve and two chained updates, each from the seed alone: the
    port's results are the reference Solver's, MIS and rounds."""
    from repro.api import Solver as RefSolver

    ref_g = _ref_graph("powerlaw")
    kw = dict(engine=engine, tile_size=16, repair=repair, seed=5)
    ref_solver, solver = RefSolver(RefOptions(**kw)), _solver(**kw)
    want, got = ref_solver.solve(ref_g), solver.solve(_port_graph(ref_g))
    for seed in (21, 22):
        np.testing.assert_array_equal(got.in_mis, np.asarray(want.in_mis))
        assert got.rounds == want.rounds
        d = random_delta(got.plan.g, n_add=5, n_remove=5, seed=seed)   # no reorder: original ids
        want = ref_solver.update(want, _ref_delta(d))
        got = solver.update(got, d)
        assert got.stats["repair"] == want.stats["repair"] == repair
    np.testing.assert_array_equal(got.in_mis, np.asarray(want.in_mis))
    assert got.rounds == want.rounds


def test_repair_empty_delta_matches_cold_mode_exactly():
    g = _port_graph(ref_erdos_renyi(90, avg_deg=5.0, seed=14))
    inc = _solver(engine="tiled_ref", tile_size=8, repair="incremental")
    cold = _solver(engine="tiled_ref", tile_size=8, repair="cold")
    prior_i, prior_c = inc.solve(g), cold.solve(g)
    np.testing.assert_array_equal(prior_i.in_mis, prior_c.in_mis)
    ri, rc = inc.update(prior_i, EdgeDelta.make()), cold.update(prior_c, EdgeDelta.make())
    assert (ri.stats["repair"], rc.stats["repair"]) == ("incremental", "cold")
    np.testing.assert_array_equal(ri.in_mis, rc.in_mis)
    np.testing.assert_array_equal(ri.in_mis, prior_i.in_mis)


def test_repair_fewer_rounds_than_cold_on_small_delta():
    g = _port_graph(ref_erdos_renyi(400, avg_deg=8.0, seed=15))
    solver = _solver(engine="tiled_ref", tile_size=16, repair="incremental")
    prior = solver.solve(g)
    res = solver.update(prior, random_delta(g, n_add=4, n_remove=4, seed=16))
    cold = solver.solve(res.plan)
    assert res.rounds < cold.rounds, (res.rounds, cold.rounds)


def test_repair_auto_policy_falls_back_to_cold():
    g = _port_graph(ref_erdos_renyi(60, avg_deg=4.0, seed=17))
    solver = _solver(engine="tiled_ref", tile_size=8, repair="auto", repair_threshold=0.05)
    before = metrics.REGISTRY.counter("repair.cold").value
    res = solver.update(solver.solve(g), random_delta(g, n_add=30, n_remove=30, seed=18))
    assert res.stats["repair"] == "cold"
    assert metrics.REGISTRY.counter("repair.cold").value == before + 1
    assert is_valid_mis(res.plan.g, torch.from_numpy(res.in_mis_plan))
    res2 = solver.update(res, random_delta(res.plan.g, n_add=1, n_remove=0, seed=19))
    assert res2.stats["repair"] == "incremental"


def test_repair_chain_stays_valid_with_rcm():
    """Updates compose over epochs through an RCM permutation: deltas in
    original ids, results in original ids."""
    g = _port_graph(ref_erdos_renyi(120, avg_deg=5.0, seed=20))
    solver = _solver(engine="tiled_ref", tile_size=8, reorder="rcm", repair="incremental")
    res = solver.solve(g)
    rng = np.random.default_rng(21)
    for step in range(3):
        plan = res.plan
        s = plan.g.senders[: plan.g.n_edges].numpy()
        r = plan.g.receivers[: plan.g.n_edges].numpy()
        original = from_edges(plan.perm[s], plan.perm[r], plan.n_nodes, device="cpu")
        res = solver.update(res, random_delta(original, 3, 3, rng=rng))
        assert res.plan.epoch == step + 1
        assert is_valid_mis(res.plan.g, torch.from_numpy(res.in_mis_plan))


def test_update_hybrid_repairs_like_off():
    g = _port_graph(ref_powerlaw(400, avg_deg=6.0, seed=13))
    d = random_delta(g, n_add=3, n_remove=2, seed=1)
    out = {}
    for mode in ("off", "forced"):
        s = _solver(engine="tiled_ref", tile_size=32, hybrid=mode, hybrid_threshold=8,
                    repair="incremental")
        r1 = s.update(s.solve(g), d)
        assert (r1.plan.tiled.partition is not None) == (mode == "forced")
        out[mode] = r1.in_mis
        assert is_valid_mis(apply_graph_delta(g, d), torch.from_numpy(r1.in_mis))
    np.testing.assert_array_equal(out["forced"], out["off"])


# --------------------------------------------------------------------------
# parsers and streams
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny.edges", "tiny.mtx", "tiny.dimacs"])
def test_parsers_and_streams_equal_reference(name):
    path = os.path.join(FIXTURES, name)
    want = ref_io.load_graph(path)
    _assert_graph_equal(io.load_graph(path, device="cpu"), want)
    _assert_graph_equal(load_graph_stream(path, chunk_edges=3, device="cpu"), want)
    assert io.detect_format(path) == ref_io.detect_format(path)
    got_chunks = list(iter_edges(path, chunk_edges=4))
    want_chunks = list(ref_stream.iter_edges(path, chunk_edges=4))
    assert len(got_chunks) == len(want_chunks)
    for (a, b), (c, e) in zip(got_chunks, want_chunks):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, e)


def test_parse_errors_and_delta_files_equal_reference(tmp_path):
    bad = tmp_path / "bad.mtx"
    bad.write_text("%%MatrixMarket matrix coordinate pattern general\n3 3 2\n1 2\n")
    for mod in (io, ref_io):
        with pytest.raises(mod.GraphParseError, match="promised 2 entries"):
            mod.load_graph(str(bad), **({"device": "cpu"} if mod is io else {}))
    lines = ["# a delta", "+ 1 2", "- 3 4", "5 6", "% comment", "-7 8"]
    got, want = parse_delta(lines), ref_stream.parse_delta(lines)
    assert got.content_key == want.content_key
    f = tmp_path / "d.txt"
    f.write_text("\n".join(lines))
    assert load_delta(str(f)).content_key == want.content_key
    with pytest.raises(io.GraphParseError, match="negative"):
        parse_delta(["+ -1 2"])
