"""The port's observability against the JAX reference: the round-telemetry
buffer (`SolveOptions(telemetry=True)`), the profiler twin
(`core.tc_mis.run_phases`, `Solver.profile`), `RoundTrace` and span
tracing.

Every parity case plans with the reference, draws the reference's H3
priorities and hands both over as numpy.  The reference's Pallas engines
run in interpret mode, as its own tests run them on the CPU.  Telemetry
buffers must be exactly equal, fill rows included."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.api import SolveOptions as RefOptions
from repro.api.plan import Plan as RefPlan
from repro.core import heuristics as ref_heur
from repro.core.tc_mis import _run_phases_impl, _tc_mis_impl
from repro.graphs.generators import grid2d as ref_grid2d
from repro.graphs.graph import from_edges as ref_from_edges
from repro.obs.rounds import RoundTrace as RefRoundTrace
from repro_torch.api import Solver, SolveOptions, plan_from_arrays
from repro_torch.core.engine import _set_sizes
from repro_torch.core.heuristics import Priorities
from repro_torch.core.tc_mis import run_phases, run_tc_mis
from repro_torch.graphs import grid2d
from repro_torch.obs import (
    COL_ALIVE,
    COL_FRONTIER,
    COL_SELECTED,
    COL_TILES_SKIPPED,
    TELEMETRY_COLS,
    TELEMETRY_FILL,
    JsonlWriter,
    RoundTrace,
    Trace,
    trace_span,
)
from test_torch_solver import _edges, _plan_arrays

PORT_ENGINES = ("segment", "tiled_ref", "tiled_pallas", "fused_pallas")
# (frontier, phase1): the main path's dense frontier with the segment max,
# and the packed path's words with the tiled max; segment has no words
CASES = [(e, f, p) for e in PORT_ENGINES
         for f, p in (("dense", "segment"), ("bitwise", "tiled"))
         if e != "segment" or f == "dense"]


def _ref_graph(kind):
    if kind == "grid":
        return ref_grid2d(24, 24)
    src, dst, n = _edges("random")
    return ref_from_edges(src, dst, n)


def _both(kind, storage):
    """(reference plan, reference priorities, the port's plan, the port's
    priorities) for one graph at T = 16."""
    ref_plan = RefPlan.build(_ref_graph(kind), tile_size=16, storage=storage)
    pri = ref_heur.make_priorities("h3", jax.random.key(7), ref_plan.g.n_nodes,
                                   ref_plan.g.degrees())
    plan = plan_from_arrays(_plan_arrays(ref_plan), device="cpu")
    port_pri = Priorities(torch.tensor(np.asarray(pri.select)),
                          torch.tensor(np.asarray(pri.resolve)))
    return ref_plan, pri, plan, port_pri


@pytest.mark.parametrize("engine, frontier, phase1", CASES)
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("kind", ["grid", "random"])
def test_telemetry_buffer_equals_reference(kind, storage, engine, frontier, phase1):
    ref_plan, ref_pri, plan, pri = _both(kind, storage)
    kw = dict(engine=engine, frontier=frontier, phase1=phase1)
    want, want_buf = _tc_mis_impl(ref_plan.g, ref_plan.tiled, jax.random.key(7),
                                  RefOptions(telemetry=True, **kw), priorities=ref_pri)
    got, buf = run_tc_mis(plan.g, plan.tiled, None, SolveOptions(telemetry=True, **kw),
                          priorities=pri)
    off = run_tc_mis(plan.g, plan.tiled, None, SolveOptions(**kw), priorities=pri)
    assert buf.dtype == torch.int32 and buf.shape == (SolveOptions().max_rounds, TELEMETRY_COLS)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(want_buf))
    np.testing.assert_array_equal(got.in_mis.numpy(), np.asarray(want.in_mis))
    np.testing.assert_array_equal(got.in_mis.numpy(), off.in_mis.numpy())
    assert int(got.rounds) == int(off.rounds) == int(want.rounds)
    assert (buf[int(got.rounds):] == TELEMETRY_FILL).all()


@pytest.mark.parametrize("engine", ["segment", "tiled_ref"])
def test_member_rounds_telemetry_equals_reference(engine):
    """Per-vertex round counters with some vertices dead from the start:
    the row index is max(rnd), as in the reference."""
    ref_plan, ref_pri, plan, pri = _both("random", "int8")
    alive0 = np.random.default_rng(2).random(ref_plan.g.n_nodes) < 0.8
    want, want_buf = _tc_mis_impl(ref_plan.g, ref_plan.tiled, jax.random.key(7),
                                  RefOptions(engine=engine, telemetry=True),
                                  priorities=ref_pri, alive0=alive0, member_rounds=True)
    got, buf = run_tc_mis(plan.g, plan.tiled, None,
                          SolveOptions(engine=engine, telemetry=True), priorities=pri,
                          alive0=torch.from_numpy(alive0), member_rounds=True)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(want_buf))
    np.testing.assert_array_equal(got.rounds.numpy(), np.asarray(want.rounds))


@pytest.mark.parametrize("engine, frontier, phase1", CASES)
def test_run_phases_matches_reference_twin(engine, frontier, phase1):
    ref_plan, ref_pri, plan, pri = _both("grid", "bitpack")
    kw = dict(engine=engine, frontier=frontier, phase1=phase1)
    want, _ = _run_phases_impl(ref_plan.g, ref_plan.tiled, jax.random.key(7),
                               RefOptions(**kw), priorities=ref_pri)
    got, times = run_phases(plan.g, plan.tiled, None, SolveOptions(**kw), priorities=pri)
    np.testing.assert_array_equal(got.in_mis.numpy(), np.asarray(want.in_mis))
    assert int(got.rounds) == int(want.rounds) == times["rounds"]
    assert set(times) == {"phase1", "phase2", "phase3", "rounds"}
    assert all(times[k] >= 0.0 for k in ("phase1", "phase2", "phase3"))


@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_profile_bit_matches_solve_for_every_engine(engine):
    """As the reference's tests/test_api.py holds `Solver.profile` to
    `Solver.solve`, over both storages and frontiers."""
    g = grid2d(20, 20, seed=1, device="cpu")
    for storage in ("int8", "bitpack"):
        for frontier in ("dense", "bitwise"):
            solver = Solver(SolveOptions(engine=engine, tile_size=16, storage=storage,
                                         frontier=frontier, phase1="tiled"), device="cpu")
            want = solver.solve(g)
            got, times = solver.profile(g)
            np.testing.assert_array_equal(got.in_mis, want.in_mis)
            assert got.rounds == want.rounds == times["rounds"]
            assert set(times) == {"phase1", "phase2", "phase3", "rounds"}
            assert got.telemetry is None


def test_solver_telemetry_trace_and_spans():
    """Telemetry of the full tiling (`hybrid="off"`) and, last, of the
    default `hybrid="auto"` plan, whose partition routes this grid's every
    tile to the COO tail."""
    g = grid2d(24, 24, device="cpu")
    opts = dict(engine="fused_pallas", tile_size=16, storage="bitpack", phase1="tiled",
                hybrid="off")
    off = Solver(SolveOptions(**opts), device="cpu").solve(g)
    tr = Trace("req")
    on = Solver(SolveOptions(telemetry=True, **opts), device="cpu").solve(g, trace=tr)
    assert off.telemetry is None
    np.testing.assert_array_equal(on.in_mis, off.in_mis)
    rt = on.telemetry
    rt.check_invariants()
    assert rt.rounds == on.rounds and rt.alive[0] == g.n_nodes
    assert sum(rt.selected) == on.mis_size
    assert rt.tiles_total == on.plan.tiled.n_tiles_pad
    assert all(0 <= k <= rt.tiles_total for k in rt.tiles_skipped)
    assert [d + s for d, s in zip(rt.tiles_dense, rt.tiles_skipped)] == [rt.tiles_total] * rt.rounds
    assert rt.meta == dict(scope="solve", engine="fused_pallas", storage="bitpack",
                           frontier="bitwise", n_nodes=g.n_nodes)
    spans = {(s.name, s.depth) for s in tr.spans}
    assert spans == {("solver.solve", 0), ("solver.plan", 1), ("solver.execute", 1)}
    assert tr.total_ms("solver.solve") >= tr.total_ms("solver.execute")

    auto = Solver(SolveOptions(telemetry=True, **dict(opts, hybrid="auto")),
                  device="cpu").solve(g)
    part = auto.plan.tiled.partition
    np.testing.assert_array_equal(auto.in_mis, off.in_mis)
    assert part.n_dense_tiles == 0 and part.n_sparse_tiles == on.plan.tiled.n_tiles
    rt = auto.telemetry
    rt.check_invariants()
    assert rt.tiles_sparse == [part.n_sparse_tiles] * rt.rounds
    assert [d + s for d, s in zip(rt.tiles_dense, rt.tiles_skipped)] == \
        [part.dense.n_tiles_pad] * rt.rounds


def test_profile_trace_records_each_phase_of_each_round():
    g = grid2d(20, 20, device="cpu")
    tr = Trace("prof")
    res, times = Solver(SolveOptions(tile_size=16), device="cpu").profile(g, trace=tr)
    depth = {}
    for sp in tr.spans:
        depth.setdefault(sp.name, set()).add(sp.depth)
    assert depth == {"solver.profile": {0}, "solver.plan": {1}, "rounds.phase1": {1},
                     "rounds.phase2": {1}, "rounds.phase3": {1}}
    for k in ("phase1", "phase2", "phase3"):
        assert sum(sp.name == f"rounds.{k}" for sp in tr.spans) == res.rounds == times["rounds"]


def test_profiler_trace_puts_spans_among_profiler_events():
    g = grid2d(16, 16, device="cpu")
    solver = Solver(SolveOptions(tile_size=16), device="cpu")
    plan = solver.plan(g)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        solver.solve(plan, trace=Trace("p", profiler=True))
    names = {e.key for e in prof.key_averages()}
    assert {"solver.solve", "solver.plan", "solver.execute"} <= names


def test_jsonl_writer_round_trips_trace_and_rounds(tmp_path):
    g = grid2d(16, 16, device="cpu")
    tr = Trace("w")
    res = Solver(SolveOptions(tile_size=16, telemetry=True), device="cpu").solve(g, trace=tr)
    path = tmp_path / "obs.jsonl"
    w = JsonlWriter(str(path))
    assert not path.exists()
    w.write_trace(tr)
    w.write_rounds(res.telemetry)
    w.close()
    first, second = path.read_text().splitlines()
    assert json.loads(first)["kind"] == "trace"
    assert RoundTrace.from_jsonl_line(second).to_dict() == res.telemetry.to_dict()


# --------------------------------------------------------------------------
# RoundTrace and spans, as the reference's tests/test_obs.py holds its own
# --------------------------------------------------------------------------

def _fake_buffer(rows):
    buf = np.full((8, TELEMETRY_COLS), TELEMETRY_FILL, np.int32)
    for i, (a, f, s, k) in enumerate(rows):
        buf[i, COL_ALIVE] = a
        buf[i, COL_FRONTIER] = f
        buf[i, COL_SELECTED] = s
        buf[i, COL_TILES_SKIPPED] = k
    return buf


def test_roundtrace_roundtrip_and_summary():
    buf = _fake_buffer([(10, 4, 3, 1), (5, 2, 2, 2), (1, 1, 1, 3)])
    rt = RoundTrace.from_buffer(buf, 3, tiles_total=4, meta={"engine": "x"})
    rt.check_invariants()
    assert rt.rounds == 3 and list(rt.alive) == [10, 5, 1]
    line = rt.to_jsonl_line()
    assert json.loads(line)["kind"] == "rounds"
    assert RoundTrace.from_jsonl_line(line).to_dict() == rt.to_dict()
    s = rt.summary()
    assert s["alive0"] == 10 and s["selected_total"] == 6
    assert s["frontier_peak"] == 4


def test_roundtrace_rejects_bad_buffers():
    with pytest.raises(ValueError):
        RoundTrace.from_buffer(np.zeros((4, TELEMETRY_COLS + 1), np.int32), 2)
    # a used row still holding the fill value: the loop never wrote it
    with pytest.raises(ValueError):
        RoundTrace.from_buffer(_fake_buffer([(10, 4, 3, 0)]), 2)
    with pytest.raises(ValueError):
        RoundTrace.from_jsonl_line(json.dumps({"kind": "trace"}))
    # alive must be non-increasing
    rt = RoundTrace.from_buffer(_fake_buffer([(5, 2, 2, 0), (9, 1, 1, 0)]), 2)
    with pytest.raises(AssertionError):
        rt.check_invariants()


def test_roundtrace_from_buffer_equals_reference():
    buf = _fake_buffer([(10, 4, 3, 1), (5, 2, 2, 2), (1, 1, 1, 3)])
    buf[:3, 4] = (7, 6, 5)
    for rounds, total in ((3, 8), (2, 0), (0, 8)):
        got = RoundTrace.from_buffer(buf, rounds, tiles_total=total, meta={"k": 1})
        want = RefRoundTrace.from_buffer(buf, rounds, tiles_total=total, meta={"k": 1})
        assert got.to_dict() == want.to_dict()
        assert got.summary() == want.summary()
        assert got.to_jsonl_line() == want.to_jsonl_line()


def test_trace_span_tree_and_noop():
    tr = Trace("t")
    with trace_span(tr, "outer", k=1):
        with trace_span(tr, "inner"):
            pass
    names = [(s.name, s.depth) for s in tr.spans]
    assert ("outer", 0) in names and ("inner", 1) in names
    d = json.loads(tr.to_jsonl_line())
    assert d["kind"] == "trace" and len(d["spans"]) == 2
    assert [s["name"] for s in d["spans"]] == ["outer", "inner"]
    assert d["spans"][0]["meta"] == {"k": 1}
    # trace=None is a no-op seam, not an error
    with trace_span(None, "ignored") as t:
        assert t is None


# --------------------------------------------------------------------------
# the word popcount torch lacks
# --------------------------------------------------------------------------

def test_set_sizes_match_numpy_bitwise_count():
    """The counterpart of the reference's `_popcount_words` (and `_count`)
    against `np.bitwise_count` on the words' uint32 view: random words, and
    0, -1, INT32_MIN, INT32_MAX and 1 alone and together."""
    rng = np.random.default_rng(0)
    words = rng.integers(0, 1 << 32, (3, 64, 4), dtype=np.uint64).astype(np.uint32)
    edge = np.array([0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 1], np.uint32)
    cases = [words, edge.reshape(1, 5, 1), edge.reshape(5, 1, 1), np.zeros((2, 0, 1), np.uint32)]
    for w in cases:
        got = _set_sizes(torch.from_numpy(w.view(np.int32)))
        assert got.dtype == torch.int32 and got.shape == (w.shape[0],)
        np.testing.assert_array_equal(got.numpy(), np.bitwise_count(w).reshape(w.shape[0], -1).sum(1))
    mask = rng.random((4, 300)) < 0.3
    np.testing.assert_array_equal(_set_sizes(torch.from_numpy(mask)).numpy(), mask.sum(1))


# --------------------------------------------------------------------------
# the metrics registry (repro.obs.metrics)
# --------------------------------------------------------------------------

def _feed(mod, values, name="r"):
    """One registry of `mod` fed a seeded stream of events."""
    reg = mod.MetricsRegistry(name)
    for i, v in enumerate(values):
        reg.counter("events").inc()
        reg.counter("weighted").inc(int(v) % 7)
        reg.gauge("last").set(v)
        reg.histogram("latency_ms").observe(v)
        if i % 3 == 0:
            reg.histogram("sizes").observe(v / 100.0)
    reg.histogram("empty")
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_snapshots_equal_reference(seed):
    from repro.obs import metrics as ref_metrics
    from repro_torch.obs import metrics

    # log-spread values from 10 µs to 100 s, past both ends of the buckets
    values = np.exp(np.random.default_rng(seed).uniform(np.log(0.01), np.log(1e5), 200))
    mine, ref = _feed(metrics, values), _feed(ref_metrics, values)
    assert json.dumps(mine.snapshot()) == json.dumps(ref.snapshot())
    for q in (0.0, 0.1, 0.5, 0.95, 0.99, 1.0, 1.5):
        assert mine.histogram("latency_ms").quantile(q) == \
            ref.histogram("latency_ms").quantile(q)
    assert mine.histogram("empty").quantile(0.5) is None
    # merging replicas: counters add, gauges take the other's, buckets add
    mine.merge(_feed(metrics, values[::2], "other"))
    ref.merge(_feed(ref_metrics, values[::2], "other"))
    assert json.dumps(mine.snapshot()) == json.dumps(ref.snapshot())


def test_metrics_registry_rules_equal_reference():
    from repro.obs import metrics as ref_metrics
    from repro_torch.obs import metrics

    for mod in (metrics, ref_metrics):
        reg = mod.MetricsRegistry()
        reg.counter("x")
        with pytest.raises(TypeError, match="is a counter"):
            reg.gauge("x")
        with pytest.raises(ValueError, match="strictly increasing"):
            mod.Histogram("h", buckets=(1.0, 1.0, 2.0))
        h = mod.Histogram("h", buckets=(1.0, 2.0))
        with pytest.raises(ValueError, match="cannot merge"):
            h.merge(mod.Histogram("g", buckets=(1.0, 3.0)))
    assert metrics.DEFAULT_BUCKETS == ref_metrics.DEFAULT_BUCKETS
    assert metrics.QUANTILES == ref_metrics.QUANTILES
    assert metrics.counter("t.c") is metrics.REGISTRY.counter("t.c")
    assert metrics.histogram("t.h") is metrics.REGISTRY.histogram("t.h")
    assert metrics.gauge("t.g") is metrics.REGISTRY.gauge("t.g")


def test_solver_and_plan_cache_metrics_views():
    """`Solver.stats` and `PlanCache.stats` are views over their registries,
    in the reference's spelling; a telemetry solve sets the cost model's
    error gauges."""
    solver = Solver(SolveOptions(engine="tiled_ref", tile_size=16, telemetry=True),
                    device="cpu")
    g = grid2d(24, 24, device="cpu")
    res = solver.solve(g)
    solver.solve(g)
    assert solver.stats == {"solves": 2, "batches": 0, "compiles": 0}
    assert solver.plans.stats == {"mem_hits": 1, "disk_hits": 0, "misses": 1,
                                  "evicted_stale": 0}
    snap = solver.metrics.snapshot()
    assert snap["solver.solve_ms"]["count"] == 2
    assert snap["perf.roofline_measured_us"] > 0
    assert res.telemetry.rounds == res.rounds
