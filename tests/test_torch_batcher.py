"""The port's batched route against the JAX reference: `pack_batch`'s
block-diagonal batch (tile arrays, `alive0`, `col_gate`, placed
priorities, `signature()`, the partition of a whole-pack hybrid batch and
the dense-only fallback of a mixed one) and each member's MIS and rounds
from one convergence loop, on every engine and both storages, then
`Solver.solve_many`'s contract (tests/test_api.py, tests/test_serve_mis.py,
tests/test_hybrid.py's batched cases) on the port.

The reference's `pack_batch` runs with its content-derived keys; the port's
takes the reference's member priorities as numpy, and `solve_many` from
the seed alone gives the reference's members.  Everything is exact.
The reference's Pallas engines run in interpret mode, as its own tests run
them on the CPU."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import SolveOptions as RefOptions
from repro.api import Solver as RefSolver
from repro.api.plan import Plan as RefPlan
from repro.core.tc_mis import _tc_mis_impl
from repro.graphs.generators import erdos_renyi as ref_erdos_renyi
from repro.graphs.generators import grid2d as ref_grid2d
from repro.graphs.generators import powerlaw as ref_powerlaw
from repro.graphs.graph import from_edges as ref_from_edges
from repro.serve_mis.batcher import _member_priorities
from repro.serve_mis.batcher import pack_batch as ref_pack_batch
from repro.serve_mis.batcher import request_key
from repro_torch.api import Plan, Solver, SolveOptions
from repro_torch.core import prng
from repro_torch.core.heuristics import Priorities
from repro_torch.core.tc_mis import run_tc_mis
from repro_torch.core.validate import is_valid_mis
from repro_torch.obs import metrics
from repro_torch.serve_mis import Bucket, bucket_for, pack_batch
from repro_torch.serve_mis import request_key as port_request_key
from test_torch_hybrid import _assert_partition_equal, _assert_tiling_equal, _port_graph

# (engine, phase1): every engine on the segment max, the tile engines on
# the tiled max too (a batch counts rounds per vertex: the dense frontier)
ENGINE_CASES = [("segment", "segment"), ("tiled_ref", "segment"), ("tiled_ref", "tiled"),
                ("tiled_pallas", "segment"), ("tiled_pallas", "tiled"),
                ("fused_pallas", "segment"), ("fused_pallas", "tiled")]


def _hetero(seed=0):
    """tests/test_api.py's heterogeneous mix: empty and one-vertex graphs,
    members of several sizes and round counts."""
    empty = np.zeros(0, np.int64)
    return [
        ref_grid2d(3 + seed, 4),
        ref_powerlaw(40 + seed, avg_deg=3.0, seed=seed + 1),
        ref_erdos_renyi(25 + seed, avg_deg=4.0, seed=seed + 2),
        ref_from_edges(empty, empty, 7),
        ref_erdos_renyi(33 + seed, avg_deg=2.0, seed=seed + 3),
        ref_from_edges(empty, empty, 1),
    ]


def _port_pri(select, resolve):
    return Priorities(torch.tensor(np.asarray(select)),
                      None if resolve is None else torch.tensor(np.asarray(resolve)))


def _both_batches(ref_graphs, T, storage, hybrid="off", threshold=None, heuristic="h3"):
    """(reference batch, the port's batch, the port's plans, the members'
    priorities as the port takes them)."""
    kw = dict(tile_size=T, storage=storage, hybrid=hybrid, hybrid_threshold=threshold)
    ref_plans = [RefPlan.build(g, **kw) for g in ref_graphs]
    base = jax.random.key(7)
    keys = [request_key(base, p) for p in ref_plans]
    ref_batch = ref_pack_batch(ref_plans, keys, heuristic)
    pris = [_port_pri(*_member_priorities(p, k, heuristic, None))
            for p, k in zip(ref_plans, keys)]
    plans = [Plan.build(_port_graph(g), **kw) for g in ref_graphs]
    return ref_batch, pack_batch(plans, pris), plans, pris


def _assert_batch_equal(got, want):
    assert got.signature() == want.signature()
    assert tuple(got.bucket) == tuple(want.bucket)
    assert (got.offsets, got.sizes) == (want.offsets, want.sizes)
    assert (got.n_real_edges, got.n_real_tiles) == (want.n_real_edges, want.n_real_tiles)
    # the reference declares its bucket counts, the port its real ones
    assert want.tiled.n_tiles == want.bucket.n_tiles_pad == got.tiled.n_tiles_pad
    assert got.tiled.n_tiles == got.n_real_tiles
    _assert_tiling_equal(dataclasses.replace(got.tiled, partition=None, n_tiles=want.tiled.n_tiles),
                         dataclasses.replace(want.tiled, partition=None))
    _assert_partition_equal(got.tiled.partition, want.tiled.partition)
    np.testing.assert_array_equal(got.alive0.numpy(), np.asarray(want.alive0))
    np.testing.assert_array_equal(got.col_gate.numpy(), np.asarray(want.col_gate))
    np.testing.assert_array_equal(got.priorities.select.numpy(),
                                  np.asarray(want.priorities.select))
    assert (got.priorities.resolve is None) == (want.priorities.resolve is None)
    if got.priorities.resolve is not None:
        np.testing.assert_array_equal(got.priorities.resolve.numpy(),
                                      np.asarray(want.priorities.resolve))
    # the port's batch graph holds the real half-edges only
    assert got.g.n_edges == got.g.e_pad == want.n_real_edges
    assert want.g.n_edges == want.bucket.e_pad
    for a, b in ((got.g.senders, want.g.senders), (got.g.receivers, want.g.receivers)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[: want.n_real_edges])


def _run_both(ref_batch, batch, opts_kw, telemetry=False):
    ref_out = _tc_mis_impl(
        ref_batch.g, ref_batch.tiled, jax.random.key(0), RefOptions(telemetry=telemetry, **opts_kw),
        priorities=ref_batch.priorities, alive0=ref_batch.alive0,
        col_gate=ref_batch.col_gate, member_rounds=True)
    out = run_tc_mis(batch.g, batch.tiled, None, SolveOptions(telemetry=telemetry, **opts_kw),
                     priorities=batch.priorities, alive0=batch.alive0,
                     col_gate=batch.col_gate, member_rounds=True)
    return ref_out, out


@pytest.mark.parametrize("engine, phase1", ENGINE_CASES)
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
def test_packed_batch_equals_reference_and_members_equal_solo(storage, engine, phase1):
    ref_graphs = _hetero()
    ref_batch, batch, plans, pris = _both_batches(ref_graphs, 8, storage)
    _assert_batch_equal(batch, ref_batch)
    opts_kw = dict(engine=engine, phase1=phase1)
    want, got = _run_both(ref_batch, batch, opts_kw)
    assert bool(got.converged) and bool(want.converged)
    np.testing.assert_array_equal(got.in_mis.numpy(), np.asarray(want.in_mis))
    np.testing.assert_array_equal(got.rounds.numpy(), np.asarray(want.rounds))
    for plan, pri, mis, rnd in zip(plans, pris, batch.unpack(got.in_mis),
                                   batch.unpack(got.rounds)):
        solo = run_tc_mis(plan.g, plan.tiled, None, SolveOptions(**opts_kw), priorities=pri)
        np.testing.assert_array_equal(mis, solo.in_mis.numpy())
        assert (int(rnd.max()) if rnd.size else 0) == int(solo.rounds)
        assert is_valid_mis(plan.g, torch.from_numpy(mis))


@pytest.mark.parametrize("engine", ["segment", "tiled_ref", "fused_pallas"])
def test_packed_batch_of_only_empty_graphs_equals_reference(engine):
    """tests/test_serve_mis.py's all-edgeless batch: no real tile, no real
    edge, every slot settled by the trivial rule, on both storages."""
    empty = np.zeros(0, np.int64)
    graphs = [ref_from_edges(empty, empty, n) for n in (3, 1, 9)]
    for storage in ("int8", "bitpack"):
        ref_batch, batch, _, _ = _both_batches(graphs, 8, storage)
        assert batch.n_real_tiles == batch.n_real_edges == batch.tiled.n_tiles == 0
        _assert_batch_equal(batch, ref_batch)
        want, got = _run_both(ref_batch, batch, dict(engine=engine, phase1="tiled"))
        np.testing.assert_array_equal(got.in_mis.numpy(), np.asarray(want.in_mis))
        np.testing.assert_array_equal(got.rounds.numpy(), np.asarray(want.rounds))
        assert int(got.in_mis.sum()) == 13


def test_packed_batch_telemetry_equals_reference():
    ref_batch, batch, _, _ = _both_batches(_hetero(1), 8, "bitpack")
    (want, want_buf), (got, buf) = _run_both(ref_batch, batch, dict(engine="tiled_ref"),
                                             telemetry=True)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(want_buf))
    np.testing.assert_array_equal(got.in_mis.numpy(), np.asarray(want.in_mis))


@pytest.mark.parametrize("T, seeds", [(8, (1, 3)), (16, (0, 2))])
def test_bucket_rounding_is_stable_across_similar_batches(T, seeds):
    a = [Plan.build(_port_graph(g), tile_size=T) for g in _hetero(seeds[0])]
    b = [Plan.build(_port_graph(g), tile_size=T) for g in _hetero(seeds[1])]
    assert bucket_for(a, T) == bucket_for(b, T)
    pa = pack_batch(a, [_first_pri(p) for p in a])
    pb = pack_batch(b, [_first_pri(p) for p in b])
    assert pa.n_real_edges != pb.n_real_edges
    assert pa.signature() == pb.signature()
    assert pa.tiled.n_tiles_pad == pb.tiled.n_tiles_pad == pa.bucket.n_tiles_pad


def _first_pri(plan):
    from repro_torch.core.heuristics import make_priorities

    return make_priorities("h3", prng.key(0), plan.n_nodes, plan.g.degrees())


def test_pack_batch_rejects_what_the_reference_rejects():
    g = _port_graph(ref_grid2d(3, 3))
    p8, p16 = Plan.build(g, tile_size=8), Plan.build(g, tile_size=16)
    with pytest.raises(ValueError, match="tile_size"):
        pack_batch([p8, p16], [_first_pri(p8)] * 2)
    with pytest.raises(ValueError, match="storage"):
        pack_batch([p8, Plan.build(g, tile_size=8, storage="bitpack")], [_first_pri(p8)] * 2)
    with pytest.raises(ValueError, match="too small"):
        pack_batch([p8, p8], [_first_pri(p8)] * 2, bucket=Bucket(8, 1, 8, 8))
    with pytest.raises(ValueError, match="at least one"):
        pack_batch([], [])


# --------------------------------------------------------------------------
# hybrid batches (tests/test_hybrid.py's batched cases)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["tiled_ref", "tiled_pallas", "fused_pallas"])
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
def test_whole_pack_hybrid_batch_equals_reference(storage, engine):
    ref_graphs = [ref_powerlaw(200, avg_deg=5.0, seed=i) for i in range(3)]
    ref_batch, batch, _, _ = _both_batches(ref_graphs, 32, storage, "forced", 8)
    assert batch.tiled.partition is not None and ".h8:" in batch.signature()
    _assert_batch_equal(batch, ref_batch)
    want, got = _run_both(ref_batch, batch, dict(engine=engine))
    np.testing.assert_array_equal(got.in_mis.numpy(), np.asarray(want.in_mis))
    np.testing.assert_array_equal(got.rounds.numpy(), np.asarray(want.rounds))
    off_ref, off, _, _ = _both_batches(ref_graphs, 32, storage)
    assert off.tiled.partition is None and ".h" not in off.signature()
    assert off.signature() == off_ref.signature() != batch.signature()
    _, got_off = _run_both(off_ref, off, dict(engine=engine))
    np.testing.assert_array_equal(got.in_mis.numpy(), got_off.in_mis.numpy())


def test_mixed_mode_batch_falls_back_dense_like_reference():
    ref_graphs = [ref_erdos_renyi(150, avg_deg=4.0, seed=i) for i in range(2)]
    forced = RefPlan.build(ref_graphs[0], tile_size=32, hybrid="forced", hybrid_threshold=8)
    off = RefPlan.build(ref_graphs[1], tile_size=32)
    keys = [jax.random.key(0)] * 2
    ref_batch = ref_pack_batch([forced, off], keys, "h3")
    pris = [_port_pri(*_member_priorities(p, k, "h3", None)) for p, k in zip([forced, off], keys)]
    plans = [Plan.build(_port_graph(ref_graphs[0]), tile_size=32, hybrid="forced",
                        hybrid_threshold=8),
             Plan.build(_port_graph(ref_graphs[1]), tile_size=32)]
    batch = pack_batch(plans, pris)
    assert batch.tiled.partition is None and ref_batch.tiled.partition is None
    _assert_batch_equal(batch, ref_batch)
    # two thresholds: dense-only too
    other = Plan.build(_port_graph(ref_graphs[1]), tile_size=32, hybrid="forced",
                       hybrid_threshold=9)
    assert pack_batch([plans[0], other], pris).tiled.partition is None


# --------------------------------------------------------------------------
# Solver.solve_many (tests/test_api.py's contract, on the port)
# --------------------------------------------------------------------------

def _graphs(seed=0):
    return [_port_graph(g) for g in _hetero(seed)]


@pytest.mark.parametrize("engine", ["segment", "tiled_ref", "fused_pallas"])
def test_solve_many_members_equal_solo_with_own_rounds(engine):
    graphs = _graphs()
    solver = Solver(SolveOptions(engine=engine, tile_size=8), device="cpu")
    results = solver.solve_many(graphs)
    assert [r.placement for r in results] == ["batched"] * len(graphs)
    assert len({r.stats["bucket"] for r in results}) == 1
    for g, res in zip(graphs, results):
        solo = solver.solve(res.plan, key=solver.request_key(res.plan))
        np.testing.assert_array_equal(res.in_mis, solo.in_mis)
        assert res.rounds == solo.rounds
        assert is_valid_mis(g, torch.from_numpy(res.in_mis))
        assert res.stats["batch_ms"] == pytest.approx(res.stats["solve_ms"] * len(graphs))
    assert len({r.rounds for r in results}) > 1, "the mix should span rounds"
    assert solver.stats["batches"] == 1


def test_solve_many_empty_and_singleton_build_no_batch():
    solver = Solver(SolveOptions(engine="tiled_ref", tile_size=8), device="cpu")
    assert solver.solve_many([]) == []
    empty = np.zeros(0, np.int64)
    for ref_g in (ref_erdos_renyi(20, avg_deg=3.0, seed=0), ref_from_edges(empty, empty, 5),
                  ref_from_edges(empty, empty, 1)):
        g = _port_graph(ref_g)
        [res] = solver.solve_many([g])
        assert res.placement == "local" and "bucket" not in res.stats
        assert res.converged and is_valid_mis(g, torch.from_numpy(res.in_mis))
    assert solver.stats["batches"] == 0
    g = _port_graph(ref_erdos_renyi(20, avg_deg=3.0, seed=0))
    [single] = solver.solve_many([g])
    batched = solver.solve_many([g, _port_graph(ref_grid2d(4, 4))])[0]
    np.testing.assert_array_equal(single.in_mis, batched.in_mis)
    assert single.rounds == batched.rounds and batched.placement == "batched"


def test_solve_many_groups_by_tile_size_and_storage_in_input_order():
    """Auto-T and auto storage split a mixed workload into groups; a group
    of one solves alone; results keep the input order."""
    big = _port_graph(ref_grid2d(60, 60))          # T = 128, bitpack
    small = _graphs()                               # T = 8 .. 64, int8
    solver = Solver(SolveOptions(engine="tiled_ref"), device="cpu")
    graphs = [small[0], big, small[1], small[2]]
    results = solver.solve_many(graphs)
    assert [r.plan.n_nodes for r in results] == [g.n_nodes for g in graphs]
    groups = {}
    for r in results:
        groups.setdefault((r.plan.tile_size, r.plan.storage), []).append(r)
    for members in groups.values():
        want = "batched" if len(members) > 1 else "local"
        assert {r.placement for r in members} == {want}
    for r in results:
        solo = solver.solve(r.plan, key=solver.request_key(r.plan))
        np.testing.assert_array_equal(r.in_mis, solo.in_mis)


def test_solve_many_priority_cache_and_custom_generators():
    g = _port_graph(ref_erdos_renyi(40, avg_deg=4.0, seed=1))
    h = _port_graph(ref_erdos_renyi(36, avg_deg=4.0, seed=2))
    solver = Solver(SolveOptions(engine="tiled_ref", tile_size=8), device="cpu")
    hits = metrics.counter("batcher.priority_cache.hits").value
    first = solver.solve_many([g, h])
    assert metrics.counter("batcher.priority_cache.hits").value == hits
    again = solver.solve_many([g, h])
    assert metrics.counter("batcher.priority_cache.hits").value == hits + 2
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a.in_mis, b.in_mis)
    keys = [prng.key(101), prng.key(202)]
    custom = solver.solve_many([g, h], keys=keys)
    assert metrics.counter("batcher.priority_cache.hits").value == hits + 2
    for res, seed in zip(custom, (101, 202)):
        solo = solver.solve(res.plan, key=prng.key(seed))
        np.testing.assert_array_equal(res.in_mis, solo.in_mis)
    with pytest.raises(ValueError, match="keys"):
        solver.solve_many([g, h], keys=keys[:1])


def test_request_generator_ignores_tile_size_and_storage():
    """One graph draws the same priorities in every plan of it, so its
    batched solution is the same whatever the storage."""
    g = _port_graph(ref_powerlaw(90, avg_deg=4.0, seed=4))
    plans = [Plan.build(g, tile_size=T, storage=st) for T in (8, 16) for st in ("int8", "bitpack")]
    keys = [port_request_key(prng.key(3), p) for p in plans]
    assert keys == [keys[0]] * len(keys)
    assert port_request_key(prng.key(4), plans[0]) != keys[0]
    mis = {st: Solver(SolveOptions(engine="tiled_ref", tile_size=8, storage=st),
                      device="cpu").solve_many([g, _port_graph(ref_grid2d(5, 5))])[0].in_mis
           for st in ("int8", "bitpack")}
    np.testing.assert_array_equal(mis["int8"], mis["bitpack"])


@pytest.mark.parametrize("seed", [0, 3])
def test_request_key_matches_reference(seed):
    """The content-derived key folds the reference's way: equal key words
    for the same graph and base seed."""
    for ref_g in _hetero(seed):
        plan = Plan.build(_port_graph(ref_g), tile_size=8)
        ref_plan = RefPlan.build(ref_g, tile_size=8)
        want = request_key(jax.random.key(seed), ref_plan)
        got = port_request_key(prng.key(seed), plan)
        assert tuple(got) == tuple(int(w) for w in jax.random.key_data(want))


@pytest.mark.parametrize("heuristic", ["h3", "ecl"])
def test_solve_many_members_match_reference_from_the_seed(heuristic):
    """One batch, member by member, from `options.seed` alone: the port's
    members are the reference's (MIS and rounds), no priorities handed
    over."""
    ref_graphs = _hetero(1)
    want = RefSolver(RefOptions(engine="tiled_ref", tile_size=8, heuristic=heuristic,
                                seed=7)).solve_many(ref_graphs)
    got = Solver(SolveOptions(engine="tiled_ref", tile_size=8, heuristic=heuristic, seed=7),
                 device="cpu").solve_many([_port_graph(g) for g in ref_graphs])
    assert [r.placement for r in got] == [r.placement for r in want] == ["batched"] * 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.in_mis, np.asarray(b.in_mis))
        assert a.rounds == b.rounds


def test_solve_many_hybrid_equals_off():
    graphs = [_port_graph(ref_powerlaw(200, avg_deg=5.0, seed=i)) for i in range(3)]
    runs = {}
    for mode in ("off", "forced"):
        s = Solver(SolveOptions(engine="tiled_ref", tile_size=32, hybrid=mode,
                                hybrid_threshold=8), device="cpu")
        res = s.solve_many(graphs)
        assert (".h8:" in res[0].stats["bucket"]) == (mode == "forced")
        runs[mode] = [r.in_mis for r in res]
    for a, b in zip(runs["off"], runs["forced"]):
        np.testing.assert_array_equal(a, b)


def test_solve_many_metrics_and_telemetry():
    solver = Solver(SolveOptions(engine="tiled_ref", tile_size=8, telemetry=True), device="cpu")
    results = solver.solve_many(_graphs())
    rt = results[0].telemetry
    assert rt is not None and rt.meta["scope"] == "batch"
    assert rt.meta["batch_size"] == len(results) and rt.meta["frontier"] == "dense"
    assert rt.rounds == max(r.rounds for r in results)
    snap = solver.metrics.snapshot()
    assert snap["solver.batches"] == 1 and snap["solver.solves"] == len(results)
    assert snap["solver.batch_size"]["count"] == 1 and snap["solver.batch_size"]["max"] == 6
    assert "perf.roofline_error_pct" in snap
    assert solver.stats == {"solves": len(results), "batches": 1, "compiles": 0}


def test_solve_many_refuses_the_sharded_route():
    """The route once refused here now runs: with `placement="sharded"`
    every member peels off to its own sharded solve (a one-rank gloo group
    in this process), equal to its local solve under the same request
    key."""
    import torch.distributed as dist

    graphs = _graphs()[:2]
    solver = Solver(SolveOptions(placement="sharded", tile_size=8), device="cpu")
    local = Solver(SolveOptions(placement="local", tile_size=8), device="cpu")
    try:
        results = solver.solve_many(graphs)
    finally:
        dist.destroy_process_group()
    assert [r.placement for r in results] == ["sharded"] * 2
    assert solver.stats == {"solves": 2, "batches": 0, "compiles": 2}
    for res in results:
        assert res.stats["n_shards"] == 1 and res.converged
        want = local.solve(res.plan, key=local.request_key(res.plan))
        np.testing.assert_array_equal(res.in_mis, want.in_mis)
        assert res.rounds == want.rounds
