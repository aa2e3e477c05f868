"""The port's plan cache against the JAX reference's: keys, statuses and
`stats`, the memory LRU, and the disk layer in both directions.  An `.npz`
that the reference's `PlanCache` writes loads in the port's (status
"disk", arrays equal to the reference's plan, the partition re-attached),
and one the port writes loads in the reference's; patched plans persist
under their delta-chained keys and retire their parents the same way in
both.  Everything is exact."""
import os
import warnings

import numpy as np
import pytest
import torch

from repro.api.plan import Plan as RefPlan
from repro.api.plan import PlanCache as RefCache
from repro.api.plan import _legacy_v1_cache_key
from repro.dyngraph.delta import EdgeDelta as RefDelta
from repro.graphs.generators import erdos_renyi as ref_erdos_renyi
from repro.graphs.generators import powerlaw as ref_powerlaw
from repro.serve_mis.io import load_graph as ref_load_graph
from repro_torch.api import Plan, PlanCache, Solver, SolveOptions
from repro_torch.api import plan as port_plan
from repro_torch.dyngraph import random_delta
from repro_torch.serve_mis import io
from test_torch_dyngraph import _assert_graph_equal, _assert_same_tiling, _assert_tiled_equal
from test_torch_hybrid import _port_graph

FIX_MTX = os.path.join(os.path.dirname(__file__), "fixtures", "tiny.mtx")


def _graphs(kind="powerlaw"):
    ref_g = ref_powerlaw(300, avg_deg=6.0, seed=12) if kind == "powerlaw" else \
        ref_erdos_renyi(120, avg_deg=4.0, seed=6)
    return ref_g, _port_graph(ref_g)


def _cache(path, **kw):
    return PlanCache(cache_dir=str(path), device="cpu", **kw)


def _assert_plan_equal(got, want):
    """A port plan against a reference plan: keys, policy, graph, tiling."""
    assert got.key == want.key
    assert (got.epoch, got.hybrid, got.hybrid_threshold, got.reorder) == \
        (want.epoch, want.hybrid, want.hybrid_threshold, want.reorder)
    if not want.epoch:
        # a patched plan keeps its lineage's epoch-0 density in memory; one
        # loaded from disk restarts it at the loaded state, in both packages
        assert got.occupancy0 == want.occupancy0
    assert (got.perm is None) == (want.perm is None)
    if got.perm is not None:
        np.testing.assert_array_equal(got.perm, want.perm)
        np.testing.assert_array_equal(got.inv, want.inv)
    _assert_graph_equal(got.g, want.g)
    _assert_tiled_equal(got.tiled, want.tiled)


# --------------------------------------------------------------------------
# the disk layer, both directions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reorder", [None, "rcm"])
@pytest.mark.parametrize("hybrid", ["off", "forced", "auto"])
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
def test_reference_npz_loads_in_the_port_and_back(storage, hybrid, reorder, tmp_path):
    ref_g, g = _graphs()
    kw = dict(tile_size=16, reorder=reorder, storage=storage)
    ref_plan, st = RefCache(cache_dir=str(tmp_path / "ref"), **kw).plan(
        ref_g, hybrid=hybrid, hybrid_threshold=8)
    assert st == "built"
    port = _cache(tmp_path / "ref", **kw)
    plan, st = port.plan(g, hybrid=hybrid, hybrid_threshold=8)
    assert st == "disk" and port.stats == {
        "mem_hits": 0, "disk_hits": 1, "misses": 0, "evicted_stale": 0}
    _assert_plan_equal(plan, ref_plan)
    assert plan.device == torch.device("cpu")

    mine, st = _cache(tmp_path / "port", **kw).plan(g, hybrid=hybrid, hybrid_threshold=8)
    assert st == "built" and mine.key == ref_plan.key
    back, st = RefCache(cache_dir=str(tmp_path / "port"), **kw).plan(
        ref_g, hybrid=hybrid, hybrid_threshold=8)
    assert st == "disk"
    _assert_plan_equal(mine, back)
    # the two files hold the same arrays, dtypes included
    with np.load(tmp_path / "ref" / f"{ref_plan.key}.npz") as a, \
            np.load(tmp_path / "port" / f"{ref_plan.key}.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_plan_cache_memory_and_disk_layers(tmp_path):
    """tests/test_serve_mis.py's memory / disk case, on the port, with the
    reference's stats beside it."""
    cache = _cache(tmp_path, tile_size=8)
    g = io.load_graph(FIX_MTX, device="cpu")
    plan, status = cache.plan(g)
    assert status == "built"
    assert cache.plan(g)[1] == "mem"
    assert cache.plan(io.load_graph(FIX_MTX, device="cpu"))[1] == "mem"
    cache2 = _cache(tmp_path, tile_size=8)
    plan2, status2 = cache2.plan(g)
    assert status2 == "disk"
    _assert_same_tiling(plan2.tiled, plan.tiled)
    assert cache2.stats == {"mem_hits": 0, "disk_hits": 1, "misses": 0, "evicted_stale": 0}
    ref = RefCache(tile_size=8, cache_dir=str(tmp_path))
    assert ref.plan(ref_load_graph(FIX_MTX))[1] == "disk"
    assert ref.stats == cache2.stats
    snap = cache2.metrics.snapshot()
    assert snap == {f"plan_cache.{k}": v for k, v in cache2.stats.items()}


def test_plan_cache_memory_layer_is_bounded_lru():
    cache = PlanCache(tile_size=8, max_mem_entries=2, device="cpu")
    gs = [_port_graph(ref_erdos_renyi(10 + i, avg_deg=2.0, seed=i)) for i in range(3)]
    for g in gs:
        cache.plan(g)
    assert len(cache._mem) == 2
    assert cache.plan(gs[0])[1] == "built"
    assert cache.plan(gs[2])[1] == "mem"


def test_stale_formats_are_evicted_like_reference(tmp_path):
    """A v1 file at its legacy key and a file of another format version at
    the current key: each is warned about once, deleted, counted and
    rebuilt, as the reference's cache does."""
    ref_g, g = _graphs("er")
    cache = _cache(tmp_path, tile_size=16)
    legacy = cache._path(port_plan._legacy_v1_cache_key(g, 16, None))
    assert os.path.basename(legacy) == f"{_legacy_v1_cache_key(ref_g, 16, None)}.npz"
    np.savez(legacy, meta=np.asarray([1, 2, 3], np.int64))
    key = port_plan.plan_cache_key(g, 16, None, "int8")
    np.savez(cache._path(key), meta=np.asarray([0, 0, 0, 16, 1, 1, 2, 0, 0, 0], np.int64))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        plan, st = cache.plan(g)
    assert st == "built" and plan.key == key
    assert cache.stats["evicted_stale"] == 2 and not os.path.exists(legacy)
    msgs = [str(w.message) for w in caught]
    assert sum("format v2" in m for m in msgs) == 1
    assert sum("v1 key" in m for m in msgs) == 1
    with np.load(cache._path(key)) as z:
        assert int(z["meta"][6]) == port_plan._PLAN_VERSION == 3


def test_plan_cache_off_entries_unaffected_by_hybrid_misses(tmp_path):
    _, g = _graphs("er")
    off = _cache(tmp_path, tile_size=32)
    off.plan(g)
    assert off.plan(g)[1] == "mem"
    _cache(tmp_path, tile_size=32).plan(g, hybrid="forced", hybrid_threshold=4)
    assert _cache(tmp_path, tile_size=32).plan(g)[1] == "disk"


def test_hybrid_plan_persists_its_policy(tmp_path):
    _, g = _graphs()
    pa, st = _cache(tmp_path, tile_size=32).plan(g, hybrid="forced", hybrid_threshold=8)
    assert st == "built" and pa.tiled.partition is not None
    pb, st = _cache(tmp_path, tile_size=32).plan(g, hybrid="forced", hybrid_threshold=8)
    assert st == "disk" and (pb.hybrid, pb.hybrid_threshold) == ("forced", 8)
    _assert_same_tiling(pb.tiled, pa.tiled)


# --------------------------------------------------------------------------
# patched plans through the cache
# --------------------------------------------------------------------------

def test_apply_delta_statuses_and_epoch_eviction(tmp_path):
    """tests/test_dyngraph.py's epoch-eviction case, on the port and on the
    reference side by side: the same keys, statuses, stats and files."""
    ref_g, g = _graphs("er")
    cache = _cache(tmp_path / "port", tile_size=8)
    ref = RefCache(tile_size=8, cache_dir=str(tmp_path / "ref"))
    plan, status = cache.plan(g)
    ref_plan, _ = ref.plan(ref_g)
    assert status == "built" and plan.key == ref_plan.key
    parent_path = cache._path(plan.key)
    assert os.path.exists(parent_path)

    d = random_delta(g, n_add=3, n_remove=2, seed=10)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        p1, status = cache.apply_delta(plan, d)
        ref_p1, ref_status = ref.apply_delta(ref_plan, RefDelta(d.add, d.remove))
    assert (status, ref_status) == ("built", "built") and p1.epoch == 1
    assert p1.key == ref_p1.key
    assert not os.path.exists(parent_path)
    assert cache.stats == ref.stats and cache.stats["evicted_stale"] == 1
    msgs = [str(w.message) for w in caught]
    assert sum("pre-delta entry" in m for m in msgs) == 2, msgs
    with np.load(cache._path(p1.key)) as z, np.load(ref._path(ref_p1.key)) as w:
        assert int(z["meta"][6]) == 3 and int(z["epoch"][0]) == 1
        for name in w.files:
            np.testing.assert_array_equal(z[name], w[name], err_msg=name)

    assert cache.apply_delta(plan, d)[1] == "mem"
    fresh = _cache(tmp_path / "port", tile_size=8)
    p1d, status = fresh.apply_delta(plan, d)
    assert status == "disk" and p1d.epoch == 1
    _assert_same_tiling(p1d.tiled, p1.tiled)
    # the reference's patched file loads in the port, and the reverse
    ref_side = _cache(tmp_path / "ref", tile_size=8)
    p1r, status = ref_side.apply_delta(plan, d)
    assert status == "disk"
    _assert_plan_equal(p1r, ref_p1)

    d2 = random_delta(p1.g, n_add=2, n_remove=2, seed=11)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        p2, _ = cache.apply_delta(p1, d2)
    assert p2.epoch == 2 and not os.path.exists(cache._path(p1.key))
    assert cache.stats["evicted_stale"] == 2
    assert cache.apply_delta(p2, random_delta(p2.g)) == (p2, "mem")   # empty delta


def test_solver_plans_through_the_disk_cache(tmp_path):
    """`SolveOptions(cache_dir=...)` gives the Solver's cache its disk
    layer; a second solver in the same directory loads the plan and
    solves it to the same MIS."""
    _, g = _graphs()
    opts = SolveOptions(engine="tiled_ref", tile_size=16, cache_dir=str(tmp_path))
    a = Solver(opts, device="cpu")
    first = a.solve(g)
    b = Solver(opts, device="cpu")
    again = b.solve(g)
    assert b.plans.stats["disk_hits"] == 1 and again.plan is not first.plan
    np.testing.assert_array_equal(again.in_mis, first.in_mis)
    assert b.plan(g) is again.plan


def test_plan_cache_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        assert PlanCache().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        PlanCache()
    with pytest.raises(RuntimeError, match="cuda"):
        PlanCache(cache_dir="unused")
    with pytest.raises(RuntimeError, match="cuda"):
        Solver(SolveOptions(cache_dir="unused"))
    assert not os.path.exists("unused")


def test_graph_key_ignores_build_parameters():
    ref_g, g = _graphs("er")
    keys = {Plan.build(g, tile_size=T, storage=st).graph_key
            for T in (8, 16) for st in ("int8", "bitpack")}
    assert keys == {RefPlan.build(ref_g, tile_size=8).graph_key}
