"""The port's sharded route against the JAX reference.

`shard_tiled` must give the reference's arrays element for element; the
sharded MIS on eight gloo ranks (one process each, a `file://` rendezvous
under the test's tmp_path) must give, on every rank, the MIS and rounds of
the reference's sharded route on eight fake devices and the MIS of its
single-device solve, on the same priorities (the reference's, saved as
.npy: the port does not reproduce `jax.random`).  In this process the
Solver runs the route on a one-rank gloo group, which a fixture destroys
after each test, against the reference's Solver on its one device."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(__file__))
from conftest import run_multidevice
from test_torch_hybrid import _port_graph, _tiles_np

from repro.api import SolveOptions as RefOptions
from repro.api import Solver as RefSolver
from repro.core import distributed as ref_dist
from repro.core.heuristics import make_priorities as ref_make_priorities
from repro.core.tiling import build_block_tiles as ref_build_block_tiles
from repro.dyngraph import random_delta as ref_random_delta
from repro.graphs.generators import powerlaw as ref_powerlaw
from repro.graphs.graph import from_edges as ref_from_edges
from repro_torch.api import Solver, SolveOptions
from repro_torch.core import distributed as D
from repro_torch.core.engine import block_col_flags
from repro_torch.core.heuristics import Priorities
from repro_torch.core.tc_mis import run_tc_mis
from repro_torch.core.tiling import build_block_tiles
from repro_torch.core.validate import is_valid_mis
from repro_torch.dyngraph import EdgeDelta
from repro_torch.graphs import powerlaw
from repro_torch.graphs.graph import from_edges
from repro_torch.hopper import tc_spmv as K

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True)
def no_group_left():
    """Each test starts and ends with no default process group."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _pri(ref_pri) -> Priorities:
    return Priorities(
        select=torch.from_numpy(np.asarray(ref_pri.select).copy()),
        resolve=None if ref_pri.resolve is None
        else torch.from_numpy(np.asarray(ref_pri.resolve).copy()))


# --------------------------------------------------------------------------
# shard construction
# --------------------------------------------------------------------------

def _assert_sharded_equal(got: D.ShardedTiledGraph, want):
    np.testing.assert_array_equal(_tiles_np(got.tiles), np.asarray(want.tiles))
    np.testing.assert_array_equal(got.tile_rows.numpy(), np.asarray(want.tile_rows))
    np.testing.assert_array_equal(got.tile_cols.numpy(), np.asarray(want.tile_cols))
    assert got.tile_rows.dtype == got.tile_cols.dtype == torch.int32
    for name in ("n_nodes", "tile_size", "rows_per_shard", "n_shards", "n_block_cols",
                 "n_padded"):
        assert getattr(got, name) == getattr(want, name), name


def _assert_slabs(sh: D.ShardedTiledGraph):
    """Each slab: the shard's arrays, rps x nbr_pad blocks, and row_starts
    over its real tiles only (the padding sits past the last pointer)."""
    for s in range(sh.n_shards):
        slab = sh.slab(s)
        k = sh.shard_tiles[s]
        assert (slab.n_block_rows, slab.n_block_cols) == (sh.rows_per_shard, sh.n_block_cols)
        assert slab.n_tiles == k and slab.n_tiles_pad % 8 == 0
        counts = np.bincount(sh.tile_rows[s, :k].numpy(), minlength=sh.rows_per_shard)
        np.testing.assert_array_equal(slab.row_starts.numpy(),
                                      np.concatenate([[0], np.cumsum(counts)]))
        assert torch.equal(slab.tiles, sh.tiles[s])
        assert not sh.tiles[s, k:].any()
        assert slab.tiles.data_ptr() % 16 == 0


@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_shard_tiled_equals_reference(n_shards, storage):
    ref_g = ref_powerlaw(1500, avg_deg=5.0, seed=2)
    want = ref_dist.shard_tiled(ref_build_block_tiles(ref_g, tile_size=32, storage=storage),
                                n_shards)
    got = D.shard_tiled(build_block_tiles(_port_graph(ref_g), tile_size=32, storage=storage),
                        n_shards)
    _assert_sharded_equal(got, want)
    assert got.storage == storage and sum(got.shard_tiles) > 0
    _assert_slabs(got)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_shard_tiled_empty_graph_equals_reference(n_shards):
    e = np.zeros(0, np.int64)
    want = ref_dist.shard_tiled(ref_build_block_tiles(ref_from_edges(e, e, 50), tile_size=8),
                                n_shards)
    got = D.shard_tiled(build_block_tiles(from_edges(e, e, 50, device="cpu"), tile_size=8),
                        n_shards)
    _assert_sharded_equal(got, want)
    assert got.shard_tiles == (0,) * n_shards
    _assert_slabs(got)


def test_split_spmv_on_non_square_slabs_equals_the_whole():
    """Phase ② of every slab of a 4-way split, stacked, is the whole
    tiling's on the same RHS (local rows, global columns)."""
    g = powerlaw(1500, avg_deg=5.0, seed=3, device="cpu")
    tiled = build_block_tiles(g, tile_size=16, storage="bitpack")
    sh = D.shard_tiled(tiled, 4)
    gen = torch.Generator().manual_seed(0)
    rhs = (torch.rand((sh.n_padded, 8), generator=gen) < 0.3).float()
    flags = block_col_flags(rhs[:, 0], 16)
    whole = K.tc_spmv_plain(tiled, rhs[: tiled.n_padded], col_flags=flags[: tiled.n_block_rows])
    got = torch.cat([K.tc_spmv(sh.slab(s), rhs, col_flags=flags) for s in range(4)])
    assert torch.equal(got[: tiled.n_padded], whole)
    assert not got[tiled.n_padded:].any()


# --------------------------------------------------------------------------
# eight gloo ranks against eight fake devices
# --------------------------------------------------------------------------

_RANK = textwrap.dedent("""
    import json, os, sys
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch.core.distributed import DistConfig, build_distributed_mis, shard_tiled
    from repro_torch.core.heuristics import Priorities
    from repro_torch.core.tiling import build_block_tiles
    from repro_torch.graphs.graph import Graph

    rank, size, data = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method="file://" + os.path.join(data, "rendezvous"),
                            rank=rank, world_size=size)
    load = lambda name: torch.from_numpy(np.load(os.path.join(data, name + ".npy")))
    meta = json.load(open(os.path.join(data, "meta.json")))
    g = Graph(load("senders"), load("receivers"), meta["n_nodes"], meta["n_edges"])
    sharded = shard_tiled(build_block_tiles(g, tile_size=meta["tile_size"]), size)
    for case in meta["cases"]:
        resolve = load(case["resolve"]) if case["resolve"] else None
        run = build_distributed_mis(sharded, None, DistConfig(bitpack=case["bitpack"]))
        res = run(Priorities(select=load(case["select"]), resolve=resolve))
        np.save(os.path.join(data, f"{case['name']}.rank{rank}.npy"), res.in_mis.numpy())
        with open(os.path.join(data, f"{case['name']}.rank{rank}.rounds"), "w") as f:
            f.write(str(res.rounds))
    dist.destroy_process_group()
""")


def test_eight_gloo_ranks_equal_the_reference(tmp_path):
    """tests/test_distributed.py's case: powerlaw(3000, 5), T = 64, eight
    shards, ECL with bitpack on and off, and H3 two-pass."""
    data = str(tmp_path)
    out = run_multidevice(f"""
        import json, os
        import jax, numpy as np
        from repro.graphs.generators import powerlaw
        from repro.core import (build_block_tiles, shard_tiled, build_distributed_mis,
                                DistConfig, make_priorities, ecl_mis, tc_mis, TCMISConfig)
        data = {data!r}
        mesh = jax.make_mesh((8,), ("shard",), axis_types=(jax.sharding.AxisType.Auto,))
        g = powerlaw(3000, avg_deg=5.0, seed=2)
        sharded = shard_tiled(build_block_tiles(g, tile_size=64), n_shards=8)
        save = lambda name, x: np.save(os.path.join(data, name + ".npy"), np.asarray(x))
        save("senders", g.senders); save("receivers", g.receivers)
        key = jax.random.key(0)
        ecl, h3 = (make_priorities(h, key, g.n_nodes, g.degrees()) for h in ("ecl", "h3"))
        save("ecl_select", ecl.select); save("h3_select", h3.select)
        save("h3_resolve", h3.resolve)
        assert ecl.resolve is None
        cases = []
        for name, pri, bitpack in (("ecl_packed", ecl, True), ("ecl_bytes", ecl, False),
                                   ("h3", h3, True)):
            res = build_distributed_mis(sharded, mesh, DistConfig(bitpack=bitpack))(pri)
            save(name + ".ref", res.in_mis); save(name + ".ref_rounds", res.rounds)
            h = name.split("_")[0]
            cases.append(dict(name=name, bitpack=bitpack, select=h + "_select",
                              resolve="h3_resolve" if h == "h3" else None))
        save("ecl.single", ecl_mis(g, key).in_mis)
        save("h3.single", tc_mis(g, build_block_tiles(g, tile_size=64), key,
                                 TCMISConfig(heuristic="h3")).in_mis)
        json.dump(dict(n_nodes=g.n_nodes, n_edges=g.n_edges, tile_size=64, cases=cases),
                  open(os.path.join(data, "meta.json"), "w"))
        print("REF_OK")
    """)
    assert "REF_OK" in out

    # one thread a rank: eight ranks share the host's cores
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    ranks = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), "8", data], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(8)]
    for p in ranks:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log

    meta = json.load(open(os.path.join(data, "meta.json")))
    n = meta["n_nodes"]
    load = lambda name: np.load(os.path.join(data, name + ".npy"))
    for case in meta["cases"]:
        name = case["name"]
        want, want_rounds = load(name + ".ref"), int(load(name + ".ref_rounds"))
        single = load(name.split("_")[0] + ".single")
        assert want.shape == (8 * 64 * 6,)       # 47 block-rows -> 6 per shard
        for r in range(8):
            got = load(f"{name}.rank{r}")
            np.testing.assert_array_equal(got, want, err_msg=f"{name} rank {r}")
            np.testing.assert_array_equal(got[:n], single, err_msg=f"{name} rank {r}")
            with open(os.path.join(data, f"{name}.rank{r}.rounds")) as f:
                assert int(f.read()) == want_rounds, (name, r)


# --------------------------------------------------------------------------
# one rank in this process: the loop, the group, the Solver
# --------------------------------------------------------------------------

@pytest.mark.parametrize("heuristic", ["ecl", "h3"])
@pytest.mark.parametrize("bitpack", [True, False])
def test_one_rank_loop_equals_reference_one_device(heuristic, bitpack):
    ref_g = ref_powerlaw(1200, avg_deg=5.0, seed=4)
    ref_pri = ref_make_priorities(heuristic, jax.random.key(3), ref_g.n_nodes, ref_g.degrees())
    mesh = jax.make_mesh((1,), ("shard",))
    want = ref_dist.build_distributed_mis(
        ref_dist.shard_tiled(ref_build_block_tiles(ref_g, tile_size=16), 1), mesh,
        ref_dist.DistConfig(bitpack=bitpack))(ref_pri)
    g = _port_graph(ref_g)
    tiled = build_block_tiles(g, tile_size=16)
    D.process_group(torch.device("cpu"))
    launches = K.tc_spmv.launches
    got = D.build_distributed_mis(D.shard_tiled(tiled, 1), None,
                                  D.DistConfig(bitpack=bitpack))(_pri(ref_pri))
    assert K.tc_spmv.launches == launches        # CPU tensors: the plain version
    np.testing.assert_array_equal(got.in_mis.numpy(), np.asarray(want.in_mis))
    assert got.rounds == int(want.rounds)
    assert got.in_mis.shape == (tiled.n_padded,) and not got.in_mis[g.n_nodes:].any()
    assert is_valid_mis(g, got.in_mis[: g.n_nodes])
    local = run_tc_mis(g, tiled, None, SolveOptions(engine="tiled_ref", heuristic=heuristic),
                       priorities=_pri(ref_pri))
    assert torch.equal(local.in_mis, got.in_mis[: g.n_nodes])


def test_group_backend_must_take_the_device():
    D.process_group(torch.device("cpu"))
    assert dist.get_backend() == "gloo" and D.world_size() == 1
    with pytest.raises(ValueError, match="gloo.*cuda.*nccl"):
        D.check_group_device(None, torch.device("cuda"))
    sharded = D.shard_tiled(build_block_tiles(powerlaw(200, avg_deg=3.0, seed=0, device="cpu"),
                                              tile_size=8), 2)
    with pytest.raises(ValueError, match="2 shards on a group of 1"):
        D.build_distributed_mis(sharded)


@pytest.mark.parametrize("storage", ["int8", "bitpack"])
def test_solver_sharded_equals_reference_solver(storage):
    """tests/test_storage.py's sharded case on one rank: tiled_ref, T = 32,
    both storages, against the reference's Solver on its one device and
    the local route, from the seed alone: the port draws the reference's
    priorities."""
    ref_g = ref_powerlaw(1024, avg_deg=5.0, seed=11)
    kw = dict(engine="tiled_ref", tile_size=32, storage=storage, placement="sharded")
    want = RefSolver(RefOptions(**kw)).solve(ref_g)
    assert want.placement == "sharded" and want.stats["n_shards"] == 1
    solver = Solver(SolveOptions(**kw), device="cpu")
    g = _port_graph(ref_g)
    got = solver.solve(g)
    assert got.placement == "sharded"
    np.testing.assert_array_equal(got.in_mis, want.in_mis)
    assert (got.rounds, got.converged) == (want.rounds, want.converged)
    assert got.stats["compile"] == want.stats["compile"] == "compiled"
    assert {k: got.stats[k] for k in ("n_shards", "batch_size")} == \
        {k: want.stats[k] for k in ("n_shards", "batch_size")}
    again = solver.solve(g)
    assert again.stats["compile"] == "reused" and solver.stats["compiles"] == 1
    np.testing.assert_array_equal(again.in_mis, got.in_mis)
    local = Solver(dataclasses.replace(SolveOptions(**kw), placement="local"),
                   device="cpu").solve(g)
    np.testing.assert_array_equal(local.in_mis, got.in_mis)
    assert local.rounds == got.rounds


def test_solver_sharded_strips_the_hybrid_partition():
    g = powerlaw(1500, avg_deg=6.0, seed=5, device="cpu")
    opts = SolveOptions(tile_size=16, hybrid="forced", hybrid_threshold=4,
                        placement="sharded")
    solver = Solver(opts, device="cpu")
    plan = solver.plan(g)
    assert plan.tiled.partition is not None
    res = solver.solve(plan)
    off = Solver(dataclasses.replace(opts, placement="local", hybrid="off"),
                 device="cpu").solve(g)
    np.testing.assert_array_equal(res.in_mis, off.in_mis)
    assert res.rounds == off.rounds and res.converged
    assert is_valid_mis(plan.g, torch.from_numpy(res.in_mis_plan))


def test_route_rules(monkeypatch):
    """tests/test_api.py's routing cases: forced placements route as asked;
    "auto" goes sharded only for a padded graph at the threshold or above
    on more than one rank."""
    big, small = (powerlaw(n, avg_deg=3.0, seed=0, device="cpu") for n in (2000, 100))
    auto = Solver(SolveOptions(tile_size=64, shard_threshold=1024), device="cpu")
    pb, ps = auto.plan(big), auto.plan(small)
    assert pb.tiled.n_padded >= 1024 > ps.tiled.n_padded
    assert auto.route(pb) == auto.route(ps) == "local"      # one rank
    monkeypatch.setattr(D, "world_size", lambda: 2)
    assert (auto.route(pb), auto.route(ps)) == ("sharded", "local")
    at = Solver(SolveOptions(tile_size=64, shard_threshold=pb.tiled.n_padded), device="cpu")
    assert at.route(pb) == "sharded"
    above = Solver(SolveOptions(tile_size=64, shard_threshold=pb.tiled.n_padded + 1),
                   device="cpu")
    assert above.route(pb) == "local"
    for placement in ("local", "sharded"):
        forced = Solver(SolveOptions(tile_size=64, placement=placement), device="cpu")
        assert forced.route(pb) == forced.route(ps) == placement
    assert not dist.is_initialized()          # routing alone starts no group


def test_solve_many_peels_sharded_members_off(monkeypatch):
    monkeypatch.setattr(D, "world_size", lambda: 2)
    graphs = [powerlaw(2000, avg_deg=3.0, seed=1, device="cpu"),
              powerlaw(100, avg_deg=3.0, seed=2, device="cpu"),
              powerlaw(120, avg_deg=3.0, seed=3, device="cpu")]
    solver = Solver(SolveOptions(tile_size=64, shard_threshold=1024), device="cpu")
    out = solver.solve_many(graphs)
    assert [r.placement for r in out] == ["sharded", "batched", "batched"]
    big = out[0]
    assert big.stats["n_shards"] == 1 and big.stats["batch_size"] == 1
    solo = solver.solve(graphs[0], key=solver.request_key(big.plan))
    assert solo.placement == "sharded" and solo.stats["compile"] == "reused"
    np.testing.assert_array_equal(solo.in_mis, big.in_mis)
    assert solo.rounds == big.rounds
    for r in out[1:]:
        alone = solver.solve(r.plan, key=solver.request_key(r.plan))
        assert alone.placement == "local"
        np.testing.assert_array_equal(alone.in_mis, r.in_mis)
    forced = Solver(SolveOptions(tile_size=8, placement="sharded"), device="cpu")
    assert [r.placement for r in forced.solve_many(graphs[1:])] == ["sharded"] * 2


def test_update_goes_cold_on_a_sharded_plan():
    g = powerlaw(800, avg_deg=4.0, seed=6, device="cpu")
    solver = Solver(SolveOptions(tile_size=16, placement="sharded", repair="incremental"),
                    device="cpu")
    prior = solver.solve(g)
    assert prior.placement == "sharded" and prior.converged
    ref_g = ref_powerlaw(800, avg_deg=4.0, seed=6)
    rd = ref_random_delta(ref_g, n_add=3, n_remove=3, seed=1)
    delta = EdgeDelta.make(rd.add[:, 0], rd.add[:, 1], rd.remove[:, 0], rd.remove[:, 1])
    res = solver.update(prior, delta)
    assert res.stats["repair"] == "cold" and res.placement == "sharded"
    assert res.stats["plan_epoch"] == 1 and res.converged
    cold = Solver(SolveOptions(tile_size=16, placement="sharded"), device="cpu").solve(res.plan)
    np.testing.assert_array_equal(res.in_mis, cold.in_mis)
    assert is_valid_mis(res.plan.g, torch.from_numpy(res.in_mis_plan))


def test_profile_has_no_sharded_twin():
    solver = Solver(SolveOptions(tile_size=8, placement="sharded"), device="cpu")
    with pytest.raises(NotImplementedError, match="sharded"):
        solver.profile(powerlaw(100, avg_deg=3.0, seed=0, device="cpu"))
