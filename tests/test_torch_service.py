"""The port's serving front door against the JAX reference: the plan
cache's hybrid defaults, the fused validity check, `MISService` (queue,
batched windows, updates, retention, metrics, the JSONL sink), its CLI
with the `update` verb, and the `serve_graphs` launcher.

`MISService` runs on both packages over the same request stream from the
same seed; the port draws the reference's member priorities under the
same content-derived keys, so every response is equal field for field and
its MIS and rounds bit for bit.  The reference's own service tests then run on the
port.  The reference's Pallas engines run in interpret mode, as its own
tests run them on the CPU."""
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _hypothesis_compat import given, settings, st

from repro.api import SolveOptions as RefOptions
from repro.api import Solver as RefSolver
from repro.api.plan import PlanCache as RefPlanCache
from repro.core.validate import is_valid_mis_jit
from repro.dyngraph import random_delta as ref_random_delta
from repro.graphs.generators import erdos_renyi as ref_erdos_renyi
from repro.graphs.generators import grid2d as ref_grid2d
from repro.graphs.generators import powerlaw as ref_powerlaw
from repro.graphs.graph import from_edges as ref_from_edges
from repro.serve_mis import MISService as RefService
from repro.serve_mis import ServeConfig as RefConfig
from repro.serve_mis import load_graph as ref_load_graph
from repro_torch.api import PlanCache, Solver, SolveOptions
from repro_torch.core.validate import is_independent, is_maximal, is_valid_mis_checks
from repro_torch.dyngraph import EdgeDelta, random_delta
from repro_torch.graphs import erdos_renyi, grid2d
from repro_torch.graphs.graph import from_edges
from repro_torch.launch.serve_graphs import main as serve_graphs_main
from repro_torch.obs import REGISTRY
from repro_torch.obs.report import main as report_main
from repro_torch.serve_mis import MISService, ServeConfig, load_graph
from repro_torch.serve_mis.__main__ import main as serve_main
from test_torch_hybrid import _assert_partition_equal, _assert_tiling_equal, _port_graph

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
FIX_MTX = os.path.join(FIXTURES, "tiny.mtx")
FIX_EDGES = os.path.join(FIXTURES, "tiny.edges")
FIX_DIMACS = os.path.join(FIXTURES, "tiny.dimacs")
FIXTURE_FILES = (FIX_MTX, FIX_EDGES, FIX_DIMACS)


def _service(**kw):
    return MISService(ServeConfig(**kw), device="cpu")


def _empty(n):
    return from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64), n, device="cpu")


# --------------------------------------------------------------------------
# the plan cache plans with its Solver's hybrid policy
# --------------------------------------------------------------------------

@pytest.mark.parametrize("opts_kw", [{}, {"hybrid": "off"}], ids=["default", "off"])
def test_solver_cache_plans_with_the_options_hybrid_policy(opts_kw):
    ref_g = ref_powerlaw(384, avg_deg=6.0, seed=11)
    want, want_status = RefSolver(RefOptions(**opts_kw)).plans.plan(ref_g)
    got, got_status = Solver(SolveOptions(**opts_kw), device="cpu").plans.plan(_port_graph(ref_g))
    assert (got.key, got_status) == (want.key, want_status)
    assert (got.hybrid, got.hybrid_threshold) == (want.hybrid, want.hybrid_threshold)
    assert (got.tiled.partition is None) == (opts_kw.get("hybrid") == "off")
    _assert_tiling_equal(got.tiled, want.tiled)
    _assert_partition_equal(got.tiled.partition, want.tiled.partition)


@pytest.mark.parametrize("threshold", [None, 16])
def test_bare_plan_cache_hybrid_defaults_equal_reference(threshold):
    ref_g = ref_powerlaw(384, avg_deg=6.0, seed=11)
    want, _ = RefPlanCache(hybrid="auto", hybrid_threshold=threshold).plan(ref_g)
    cache = PlanCache(hybrid="auto", hybrid_threshold=threshold, device="cpu")
    got, status = cache.plan(_port_graph(ref_g))
    assert (got.key, got.hybrid_threshold, status) == (want.key, want.hybrid_threshold, "built")
    assert got.tiled.partition is not None
    _assert_partition_equal(got.tiled.partition, want.tiled.partition)
    # a per-call policy still wins over the cache's default
    off, _ = cache.plan(_port_graph(ref_g), hybrid="off")
    assert off.tiled.partition is None and off.key != got.key


# --------------------------------------------------------------------------
# the fused validity check
# --------------------------------------------------------------------------

def _check_masks(path):
    """(reference graph, port graph, masks): empty, full, a solution and
    seeded random masks."""
    ref_g = ref_load_graph(path)
    g = load_graph(path, device="cpu")
    n = g.n_nodes
    res = Solver(SolveOptions(engine="tiled_ref", tile_size=8), device="cpu").solve(g)
    rng = np.random.default_rng(n)
    masks = [np.zeros(n, bool), np.ones(n, bool), res.in_mis]
    masks += [rng.random(n) < p for p in (0.1, 0.3, 0.5)]
    return ref_g, g, masks


@pytest.mark.parametrize("path", FIXTURE_FILES, ids=os.path.basename)
def test_fused_check_equals_reference_jit(path):
    ref_g, g, masks = _check_masks(path)
    for mask in masks:
        want = is_valid_mis_jit(ref_g, jax.numpy.asarray(mask))
        got = is_valid_mis_checks(g, mask)
        assert got == want
        assert got == (is_independent(g, torch.from_numpy(mask)),
                       is_maximal(g, torch.from_numpy(mask)))
        assert is_valid_mis_checks(g, torch.from_numpy(mask)) == want
    assert is_valid_mis_checks(g, masks[2]) == (True, True)
    assert is_valid_mis_checks(g, masks[0]) == (True, False)
    assert is_valid_mis_checks(g, masks[1]) == (False, True)


def test_fused_check_on_edgeless_and_padded_graphs():
    for n in (0, 1, 5):
        g = _empty(n)
        assert is_valid_mis_checks(g, np.ones(n, bool)) == (True, True)
        assert is_valid_mis_checks(g, np.zeros(n, bool)) == (True, n == 0)
    ref_g = ref_erdos_renyi(40, avg_deg=4.0, seed=2)
    E = ref_g.n_edges
    padded = from_edges(np.asarray(ref_g.senders)[:E], np.asarray(ref_g.receivers)[:E], 40,
                        pad_to=E + 13, device="cpu")
    assert padded.e_pad == E + 13
    mask = np.random.default_rng(0).random(40) < 0.4
    assert is_valid_mis_checks(padded, mask) == is_valid_mis_jit(ref_g, jax.numpy.asarray(mask))


@settings(max_examples=30, deadline=None)
@given(n=st.integers(2, 60), p=st.floats(0.0, 1.0), seed=st.integers(0, 2**16))
def test_fused_check_property_equals_reference(n, p, seed):
    ref_g = ref_erdos_renyi(n, avg_deg=3.0, seed=seed)
    mask = np.random.default_rng(seed).random(n) < p
    assert is_valid_mis_checks(_port_graph(ref_g), mask) == \
        is_valid_mis_jit(ref_g, jax.numpy.asarray(mask))


# --------------------------------------------------------------------------
# MISService against the reference's, response for response
# --------------------------------------------------------------------------

def _stream_graphs():
    """(reference graph, port graph) pairs of a mixed stream."""
    ref = [ref_erdos_renyi(30, avg_deg=4.0, seed=5), ref_grid2d(4, 5),
           ref_from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64), 7),
           ref_powerlaw(40, avg_deg=3.0, seed=1), ref_grid2d(3, 3)]
    return [(r, _port_graph(r)) for r in ref]


def _drive(svc, graphs, delta, files):
    """The stream: window 1 the three fixture files and a graph; window 2
    an update of that graph and three solves; window 3 one solve alone."""
    for f in files:
        svc.submit(f)
    rid = svc.submit(graphs[0])
    out = svc.drain()
    svc.submit_update(rid, delta)
    for g in graphs[1:4]:
        svc.submit(g)
    out += svc.drain()
    svc.submit(graphs[4])
    return out + svc.drain()


# the two first cases at T = 8, then ROADMAP.md Queue 3's re-anchor probe:
# h1/h2/h3 x segment/tiled phase 1 x int8/bitpack at T = 16 on fused_pallas,
# RCM on tiled_pallas, T = 32 with three lanes on tiled_ref, and segment
_SERVICE_CONFIGS = [
    pytest.param(dict(tile_size=8, engine="tiled_ref"), id="tiled_ref"),
    pytest.param(dict(tile_size=8, engine="fused_pallas"), id="fused_pallas"),
] + [
    pytest.param(dict(tile_size=16, engine="fused_pallas", heuristic=h, phase1=p1,
                      storage=st), id=f"{h}-{p1}-{st}")
    for h in ("h1", "h2", "h3") for p1 in ("segment", "tiled") for st in ("int8", "bitpack")
] + [
    pytest.param(dict(tile_size=16, engine="tiled_pallas", reorder="rcm"), id="rcm"),
    pytest.param(dict(tile_size=32, engine="tiled_ref", lanes=3), id="T32-lanes3"),
    pytest.param(dict(tile_size=16, engine="segment"), id="segment"),
]


@pytest.mark.parametrize("config", _SERVICE_CONFIGS)
def test_service_responses_equal_reference(config):
    kw = dict(config, max_batch=4, seed=1)
    pairs = _stream_graphs()
    ref_delta = ref_random_delta(pairs[0][0], n_add=1, n_remove=1, seed=4)
    delta = EdgeDelta.make(ref_delta.add[:, 0], ref_delta.add[:, 1],
                           ref_delta.remove[:, 0], ref_delta.remove[:, 1])
    ref_svc = RefService(RefConfig(**kw))
    want = _drive(ref_svc, [r for r, _ in pairs], ref_delta, FIXTURE_FILES)
    svc = _service(**kw)
    got = _drive(svc, [g for _, g in pairs], delta, FIXTURE_FILES)

    assert len(got) == len(want) == 9
    for a, b in zip(got, want):
        assert (a.id, a.source, a.valid, a.independent, a.maximal, a.converged) == \
            (b.id, b.source, b.valid, b.independent, b.maximal, b.converged)
        for k in ("batch_size", "plan_cache", "bucket"):
            assert a.stats[k] == b.stats[k], (a.id, k)
        np.testing.assert_array_equal(a.in_mis, np.asarray(b.in_mis))
        assert (a.rounds, a.mis_size) == (b.rounds, b.mis_size)
        assert set(b.stats) - set(a.stats) <= {"compile"} and a.stats["compile"] == "n/a"
        assert svc._results[a.id].plan.graph_key == ref_svc._results[b.id].plan.graph_key
    update = got[4]
    assert update.stats["repair"] == want[4].stats["repair"] == "incremental"
    assert (update.stats["base_id"], update.stats["plan_epoch"]) == (3, 1)
    if kw.get("heuristic", "h3") == "h3" and kw.get("reorder") is None:
        assert got[2].mis_size == 4      # Petersen's maximum independent set
    assert [r.stats["bucket"] for r in got][-1] == "local"
    assert svc.stats["requests"] == ref_svc.stats["requests"] == 9
    assert svc.stats["batches"] == ref_svc.stats["batches"]
    assert svc.stats["compiles"] == 0


# --------------------------------------------------------------------------
# the reference's service tests, on the port
# --------------------------------------------------------------------------

def _hetero(seed=0):
    """tests/test_serve_mis.py's mixed batch: meshes, hubs, empty and
    singleton graphs."""
    return [_port_graph(g) for g in (
        ref_grid2d(4, 5, seed=seed), ref_powerlaw(40, avg_deg=3.0, seed=seed),
        ref_erdos_renyi(25, avg_deg=4.0, seed=seed),
        ref_from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64), 7),
        ref_from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64), 1),
        ref_load_graph(FIX_DIMACS), ref_erdos_renyi(33, avg_deg=2.0, seed=seed + 1),
        ref_grid2d(3, 3, seed=seed))]


def _solo(svc, plan):
    return svc.solver.solve(plan, key=svc.solver.request_key(plan))


def test_service_end_to_end_with_cache_reuse(tmp_path):
    svc = _service(tile_size=16, engine="tiled_ref", max_batch=8, cache_dir=str(tmp_path), seed=7)
    graphs = _hetero(0)
    for g in graphs:
        svc.submit(g)
    first = svc.drain()
    assert len(first) == 8 and all(r.valid for r in first)
    assert all(r.stats["plan_cache"] == "built" and r.stats["batch_size"] == 8 for r in first)
    assert all(r.stats["compile"] == "n/a" for r in first)
    assert svc.stats == {"requests": 8, "batches": 1, "compiles": 0}
    for g, r in zip(graphs, first):          # each member equals its solo solve
        plan, status = svc.planner.plan(g)
        assert status == "mem"
        assert r.mis_size == _solo(svc, plan).mis_size
    for g in graphs:
        svc.submit(g)
    second = svc.drain()
    assert all(r.stats["plan_cache"] == "mem" for r in second)
    for a, b in zip(first, second):          # content-derived generators
        np.testing.assert_array_equal(a.in_mis, b.in_mis)
    for g in _hetero(3):
        svc.submit(g)
    assert all(r.valid for r in svc.drain())
    # a fresh service reads the plans back from disk
    svc2 = _service(tile_size=16, engine="tiled_ref", max_batch=8, cache_dir=str(tmp_path), seed=7)
    svc2.submit(graphs[0])
    (r,) = svc2.drain()
    assert r.stats["plan_cache"] == "disk" and r.stats["bucket"] == "local"
    np.testing.assert_array_equal(r.in_mis, first[0].in_mis)


def test_service_rejects_unknown_engine_and_missing_card():
    with pytest.raises(ValueError, match="unknown engine"):
        _service(engine="cuda_warp")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            MISService(ServeConfig())


def test_service_partial_batch_and_file_sources():
    svc = _service(tile_size=8, engine="tiled_ref", max_batch=8, seed=1)
    for f in FIXTURE_FILES:
        svc.submit(f)
    out = svc.drain()
    assert [r.source for r in out] == list(FIXTURE_FILES)
    assert all(r.valid for r in out)
    assert svc.stats["batches"] == 1


def test_unconverged_member_does_not_poison_batchmates():
    svc = _service(tile_size=8, engine="tiled_ref", max_batch=2, max_rounds=1)
    svc.submit(_empty(1))
    big = erdos_renyi(40, avg_deg=6.0, seed=0, device="cpu")
    svc.submit(big)
    plan, _ = svc.planner.plan(big)
    assert _solo(svc, plan).rounds == 1 and not _solo(svc, plan).converged
    full = Solver(SolveOptions(engine="tiled_ref", tile_size=8), device="cpu")
    assert full.solve(plan, key=full.request_key(plan)).rounds > 1
    iso, cut = svc.drain()
    assert not iso.converged and iso.valid       # the batch's flag, the member's verdict
    assert not cut.maximal and not cut.valid


def test_service_reports_per_member_rounds():
    svc = _service(tile_size=8, engine="tiled_ref", max_batch=4)
    slow = erdos_renyi(48, avg_deg=6.0, seed=0, device="cpu")
    svc.submit(_empty(4))
    svc.submit(slow)
    r_fast, r_slow = svc.drain()
    plan, _ = svc.planner.plan(slow)
    solo = _solo(svc, plan)
    assert solo.rounds > 1
    assert r_slow.rounds == solo.rounds and r_fast.rounds == 1
    assert r_fast.stats["bucket"] == r_slow.stats["bucket"]


def test_service_update_flow_and_chaining():
    svc = _service(tile_size=8, engine="tiled_ref")
    g = erdos_renyi(80, avg_deg=4.0, seed=22, device="cpu")
    rid = svc.submit(g)
    (base,) = svc.drain()
    assert base.valid
    uid = svc.submit_update(rid, random_delta(g, n_add=4, n_remove=4, seed=23))
    (resp,) = svc.drain()
    assert resp.id == uid and resp.valid
    assert resp.stats["repair"] == "incremental" and resp.stats["plan_cache"] == "built"
    assert resp.stats["plan_epoch"] == 1 and resp.stats["base_id"] == rid
    assert resp.summary()["plan_epoch"] == 1
    prior = svc._results[uid]
    svc.submit_update(uid, random_delta(prior.plan.g, n_add=2, n_remove=1, seed=24))
    (resp2,) = svc.drain()
    assert resp2.valid and resp2.stats["plan_epoch"] == 2
    with pytest.raises(KeyError, match="has not completed"):
        svc.submit_update(999, EdgeDelta.make())


def test_service_bad_delta_yields_error_response_not_crash():
    svc = _service(tile_size=8, engine="tiled_ref")
    g = erdos_renyi(60, avg_deg=4.0, seed=27, device="cpu")
    rid = svc.submit(g)
    svc.drain()
    non_edge = random_delta(g, n_add=1, n_remove=0, seed=28).add
    svc.submit_update(rid, EdgeDelta(add=np.zeros((0, 2), np.int64), remove=non_edge))
    svc.submit(grid2d(5, 5, device="cpu"))          # the window-mate survives
    err, ok = svc.step()
    assert not err.valid and "not in the graph" in err.stats["error"]
    assert err.in_mis.shape == (0,) and err.stats["batch_size"] == 2
    assert ok.valid
    assert svc.metrics_snapshot()["service.errors"] == 1
    with pytest.raises(ValueError, match="grow the vertex set"):
        svc.submit_update(rid, EdgeDelta.make([0], [10_000]))


@pytest.mark.parametrize("repair", ["cold", "incremental"])
def test_service_empty_delta_returns_the_base_response(repair):
    svc = _service(tile_size=8, engine="tiled_ref", repair=repair)
    rid = svc.submit(erdos_renyi(70, avg_deg=4.0, seed=29, device="cpu"))
    (base,) = svc.drain()
    svc.submit_update(rid, EdgeDelta.make())
    (resp,) = svc.drain()
    assert resp.stats["repair"] == repair and resp.stats["plan_cache"] == "mem"
    np.testing.assert_array_equal(resp.in_mis, base.in_mis)


def test_service_update_mixes_with_solves_in_one_step():
    svc = _service(tile_size=8, engine="tiled_ref", max_batch=4)
    g = erdos_renyi(70, avg_deg=4.0, seed=25, device="cpu")
    rid = svc.submit(g)
    svc.drain()
    svc.submit(grid2d(6, 6, device="cpu"))
    svc.submit_update(rid, random_delta(g, 2, 2, seed=26))
    svc.submit(grid2d(5, 7, device="cpu"))
    out = svc.step()                        # one window: solve, update, solve
    assert all(r.valid for r in out)
    assert ["repair" in r.stats for r in out] == [False, True, False]   # pop order


def test_retention_ages_results_out_fifo():
    svc = _service(tile_size=8, engine="tiled_ref", max_batch=1, result_entries=1)
    g = erdos_renyi(30, avg_deg=4.0, seed=3, device="cpu")
    rid = svc.submit(g)
    svc.drain()
    svc.submit(grid2d(4, 4, device="cpu"))           # served first: retires rid
    svc.submit_update(rid, random_delta(g, 1, 1, seed=5))
    solved, aged = svc.drain()
    assert solved.valid and list(svc._results) == [solved.id]
    assert not aged.valid and "aged out of retention" in aged.stats["error"]
    with pytest.raises(KeyError, match="has not completed"):
        svc.submit_update(rid, EdgeDelta.make())


def test_stream_submit_parity():
    svc = _service(tile_size=8, engine="tiled_ref")
    svc.submit(FIX_EDGES)
    svc.submit(FIX_EDGES, stream=True)
    a, b = svc.drain()
    np.testing.assert_array_equal(a.in_mis, b.in_mis)
    assert b.stats["plan_cache"] == "mem"


# --------------------------------------------------------------------------
# observability: trace JSONL, metrics, health
# --------------------------------------------------------------------------

def test_service_telemetry_trace_jsonl(tmp_path):
    trace_path = str(tmp_path / "trace.jsonl")
    svc = _service(engine="tiled_ref", max_batch=4, telemetry=True, trace_path=trace_path)
    svc.submit(erdos_renyi(96, avg_deg=6.0, seed=11, device="cpu"))
    svc.submit(erdos_renyi(96, avg_deg=6.0, seed=12, device="cpu"))
    responses = svc.drain()
    assert all(r.valid for r in responses)
    for r in responses:
        assert r.stats["rounds_summary"]["rounds"] >= r.rounds
        assert "batch_ms" in r.stats and "execute_ms" in r.stats
        assert "compile_ms" not in r.stats
    kinds = [json.loads(line)["kind"] for line in open(trace_path).read().splitlines()]
    assert kinds == ["trace", "rounds"]          # one series for the batch's two members
    snap = svc.metrics_snapshot()
    assert snap["service.requests"] == 2 and svc.stats["requests"] == 2
    for prefix in ("service.", "solver.", "plan_cache.", "batcher."):
        assert any(k.startswith(prefix) for k in snap), prefix
    assert report_main(["report", trace_path]) == 0
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert report_main(["report", str(empty)]) == 2


def test_service_disabled_obs_is_quiet():
    svc = _service(engine="tiled_ref", max_batch=2)
    svc.submit(erdos_renyi(96, avg_deg=6.0, seed=13, device="cpu"))
    (r,) = svc.drain()
    assert svc._trace_writer is None
    assert not {"rounds_summary", "compile_ms", "execute_ms"} & set(r.stats)
    assert r.valid


def test_service_health_drift_and_attribution(tmp_path):
    before = REGISTRY.snapshot().get("dyngraph.epochs", 0)
    svc = _service(engine="tiled_ref", max_batch=2, repair="incremental", telemetry=True,
                   trace_path=str(tmp_path / "trace.jsonl"))
    svc.submit(erdos_renyi(96, avg_deg=6.0, seed=21, device="cpu"))
    svc.submit(erdos_renyi(96, avg_deg=6.0, seed=22, device="cpu"))
    responses = svc.drain()
    assert all(r.valid for r in responses)
    target = responses[0].id
    for step in (1, 2):                       # a chained delta stream
        plan = svc._results[target].plan
        target = svc.submit_update(target, random_delta(plan.g, n_add=4, n_remove=4, seed=step))
        (r,) = svc.drain()
        assert r.valid
    snap = svc.metrics_snapshot()
    assert snap["service.latency_ms.batched"]["count"] == 2
    assert snap["service.latency_ms.update"]["count"] == 2
    for op in ("batched", "update"):
        h = snap[f"service.latency_ms.{op}"]
        assert h["p50"] <= h["p95"] <= h["p99"] <= h["max"]
    assert snap["service.queue_depth"] == 0.0 and snap["service.inflight"] == 0.0
    assert snap["service.steps"] == 3 and snap["service.window"]["count"] == 3
    assert snap["service.span_ms.service.step"]["count"] == 3
    assert "service.span_ms.service.batch" in snap
    assert snap["service.span_ms.service.validate"]["count"] == 4
    assert "service.span_ms.solver.update" in snap
    assert snap["dyngraph.epochs"] == before + 2
    assert snap["dyngraph.epoch"] == 2.0 and snap["dyngraph.occupancy"] > 0.0
    assert 0.0 < snap["dyngraph.dirty_frac"] <= 1.0
    assert snap["perf.roofline_predicted_us"] > 0.0 and snap["perf.roofline_measured_us"] > 0.0
    assert "perf.roofline_error_pct" in snap


# --------------------------------------------------------------------------
# the CLI and the launcher, in process on the CPU
# --------------------------------------------------------------------------

CLI = ["--device", "cpu", "--tile-size", "8", "--engine", "tiled_ref"]


def _records(capsys):
    out = capsys.readouterr().out
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_cli_once_with_update_trace_and_promtext(tmp_path, capsys):
    delta = tmp_path / "g.delta"
    delta.write_text("+ 0 9\n- 0 1\n")
    trace, prom = tmp_path / "trace.jsonl", tmp_path / "metrics.prom"
    rc = serve_main(["--once", *CLI, "--repeat", "2", "--cache-dir", str(tmp_path / "plans"),
                     "--telemetry", "--trace-path", str(trace), "--metrics-path", str(prom),
                     "--update", f"0:{delta}", *FIXTURE_FILES])
    assert rc == 0
    records = _records(capsys)
    assert len(records) == 7 and all(r["valid"] for r in records)
    assert records[-1]["base_id"] == 0 and records[-1]["repair"] == "incremental"
    text = prom.read_text()
    assert "repro_service_requests_total 7" in text
    assert "# TYPE repro_service_latency_ms_update histogram" in text
    assert report_main(["report", str(trace)]) == 0


def test_cli_survives_bad_request_path(capsys):
    rc = serve_main(["--once", *CLI, FIX_MTX, "definitely_missing.edges"])
    assert rc == 1
    records = _records(capsys)
    errors = [r for r in records if "error" in r]
    assert len(errors) == 1 and not errors[0]["valid"]
    assert [r["valid"] for r in records if "error" not in r] == [True]


def test_cli_stream_mode_with_the_update_verb(tmp_path, capsys, monkeypatch):
    delta = tmp_path / "g.delta"
    delta.write_text("- 0 1\n")
    lines = [FIX_MTX, FIX_EDGES, f"update 0 {delta}", "update 0", f"update 77 {delta}",
             FIX_DIMACS, ""]
    monkeypatch.setattr(sys, "stdin", __import__("io").StringIO("\n".join(lines) + "\n"))
    rc = serve_main([*CLI, "--max-batch", "2", "--metrics"])
    assert rc == 1                               # the two bad update lines
    records = _records(capsys)
    served = [r for r in records if "error" not in r]
    assert [r["source"] for r in served] == [FIX_MTX, FIX_EDGES, "<update:0+0-1>", FIX_DIMACS]
    assert all(r["valid"] for r in served) and served[2]["base_id"] == 0
    errors = [r["error"] for r in records if "error" in r]
    assert errors[0] == "usage: update <id> <delta_file>" and "KeyError" in errors[1]


def test_cli_once_needs_files(capsys):
    assert serve_main(["--once", *CLI]) == 2
    assert "needs at least one graph file" in capsys.readouterr().err


def test_serve_graphs_launcher(capsys):
    serve_graphs_main(["--device", "cpu", "--requests", "6", "--scale", "64", "--waves", "2",
                       "--repeat-frac", "0.5", "--tile-size", "8", "--max-batch", "4"])
    out = capsys.readouterr().out.splitlines()
    assert [l.split(":")[0] for l in out] == ["wave 0", "wave 1", "total"]
    assert all("valid=6/6" in l for l in out[:2])
    assert "requests=12" in out[2]
