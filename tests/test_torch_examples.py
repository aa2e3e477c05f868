"""The port's ten examples (`examples/torch_*.py`) on the CPU: each runs in
this process through its `main(argv)` with `--device cpu`, at the small
sizes its own flags take, and its own checks pass (each asserts its sets
valid, its routes bit-equal, its repairs valid).

Where a printed figure depends only on the graph or the config, it equals
what the reference's example prints at the same size, computed here by the
same calls of the reference's API (module fixture `ref`): |V|, |E| and
half-edges, BSR tile counts and routing, the auto tile size, a plan's
content key, a batch's bucket, the hybrid partition's tile and COO counts,
and the reduced LM's parameter count.  Figures that depend on priorities
(MIS sizes, rounds) come from torch generators, which draw other numbers
than `jax.random`, and are not compared."""
import importlib.util
import math
import pathlib
import re

import pytest
import torch.distributed as dist

REPO = pathlib.Path(__file__).resolve().parent.parent
NAMES = ("quickstart", "solver_quickstart", "batch_mis", "dynamic_mis", "hybrid_mis",
         "mis_heuristics", "distributed_mis", "health_dashboard", "serve_lm", "train_lm")
G3_NODES, G3_SMALL, HYBRID_NODES, G5_NODES = 2048, 512, 1024, 3000


def _run(name, argv, capsys) -> str:
    """The port example's `main(argv + ["--device", "cpu"])`; its stdout."""
    path = REPO / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    capsys.readouterr()
    mod.main(list(argv) + ["--device", "cpu"])
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def ref():
    """The graph- and config-only figures of the reference's examples at
    the sizes the tests run, from the calls those examples make."""
    import jax

    from repro.api import Plan, Solver, SolveOptions, choose_tile_size
    from repro.configs import REGISTRY
    from repro.graphs.generators import GRAPH_SUITE, erdos_renyi, grid2d, powerlaw
    from repro.launch.train import small_variant
    from repro.models import transformer as tf

    out = {}
    g = GRAPH_SUITE["G3"].make(G3_NODES, 0)
    solver = Solver(SolveOptions(heuristic="h3", engine="tiled_ref", tile_size=64))
    plan = solver.plan(g)
    out["quickstart"] = (g.n_nodes, g.n_edges, plan.tiled.n_tiles, solver.route(plan))

    g = erdos_renyi(600, avg_deg=6.0, seed=0)
    solved = Solver(SolveOptions(engine="tiled_ref")).plan(g)
    batch = [grid2d(6, 6), powerlaw(48, seed=1), erdos_renyi(64, seed=2),
             erdos_renyi(24, avg_deg=3.0, seed=3)]
    bucket = Solver(SolveOptions(engine="tiled_ref", tile_size=16)).solve_many(batch)
    built = Plan.build(g, tile_size=32)
    out["solver_quickstart"] = (g.n_nodes, solved.tile_size, choose_tile_size(g.n_nodes, g.n_edges),
                                bucket[0].stats["bucket"], built.key[:12], built.tiled.n_tiles)
    out["dynamic_mis"] = (g.n_nodes, g.n_edges // 2)

    graphs = [grid2d(8, 8), powerlaw(80, seed=1), erdos_renyi(50, seed=2), grid2d(4, 12),
              erdos_renyi(30, avg_deg=3.0, seed=3), powerlaw(64, seed=4),
              erdos_renyi(96, seed=5), grid2d(6, 6)]
    results = Solver(SolveOptions(heuristic="h3", engine="tiled_ref",
                                  tile_size=16)).solve_many(graphs)
    out["batch_mis"] = (results[0].stats["bucket"], [r.plan.n_nodes for r in results])

    g = powerlaw(HYBRID_NODES, avg_deg=16.0, seed=0)
    part = Solver(SolveOptions(engine="tiled_ref", tile_size=64, hybrid="forced",
                               hybrid_threshold=32)).plan(g).tiled.partition
    out["hybrid_mis"] = (g.n_nodes, g.n_edges // 2, part.threshold, part.n_dense_tiles,
                         part.n_sparse_tiles, part.sp_nnz)

    g = GRAPH_SUITE["G5"].make(G5_NODES, 0)
    sharded = Solver(SolveOptions(heuristic="h3", tile_size=64, placement="sharded",
                                  bitpack=True))
    plan = sharded.plan(g)
    out["distributed_mis"] = (g.n_nodes, plan.tiled.n_tiles, sharded.route(plan))

    cfg = small_variant(REGISTRY["qwen3-0.6b"].config)
    tree = jax.eval_shape(lambda k: tf.init_lm(k, cfg), jax.random.key(0))
    out["train_lm"] = sum(x.size for x in jax.tree.leaves(tree))
    return out


@pytest.fixture(autouse=True)
def no_group_left():
    """Each example starts with no default process group and leaves none."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    assert not dist.is_initialized()


def test_quickstart(ref, capsys):
    out = _run("quickstart", ["--nodes", str(G3_NODES), "--small-nodes", str(G3_SMALL)], capsys)
    n, e, tiles, route = ref["quickstart"]
    assert f"graph: |V|={n:,} half-edges={e:,}" in out
    assert f"BSR: {tiles:,} tiles of 64×64 (routing: {route})" in out
    assert re.search(r"^luby  : \|MIS\|=[\d,]+ rounds=\d+ valid=True$", out, re.M)
    assert re.search(r"^ecl   : \|MIS\|=[\d,]+ rounds=\d+ valid=True$", out, re.M)
    sizes = re.findall(r"^tc-mis\[(\w+) *\]: \|MIS\|=([\d,]+) rounds=(\d+) valid=True$", out,
                       re.M)
    assert [s[0] for s in sizes] == ["segment", "tiled_ref", "tiled_pallas", "fused_pallas"]
    assert len({s[1:] for s in sizes}) == 1          # one set from every engine


def test_solver_quickstart(ref, capsys):
    out = _run("solver_quickstart", [], capsys)
    n, t, auto_t, bucket, key, tiles = ref["solver_quickstart"]
    assert re.search(rf"^solve: +\|V\|={n} -> \|MIS\|=\d+ rounds=\d+ placement=local "
                     rf"T={t} \(auto-T policy: {auto_t}\)$", out, re.M)
    assert re.search(rf"^solve_many: +4 graphs, bucket {re.escape(bucket)}, per-member rounds "
                     r"\[\d+, \d+, \d+, \d+\]$", out, re.M)
    assert re.search(rf"^Plan.build: +key={key}… T=32 tiles={tiles} \|MIS\|=\d+$", out, re.M)
    assert "profile:     bit-identical to solve; ms/phase=" in out


def test_batch_mis(ref, capsys):
    out = _run("batch_mis", [], capsys)
    bucket, sizes = ref["batch_mis"]
    assert f"packed 8 graphs -> bucket {bucket} (8 members, one dispatch)" in out
    got = re.findall(r"^graph (\d): \|V\|= *(\d+) \|MIS\|= *\d+ rounds=\d+ valid=True "
                     r"matches_solo=True$", out, re.M)
    assert [int(v) for _, v in got] == sizes


def test_dynamic_mis(ref, capsys):
    out = _run("dynamic_mis", [], capsys)
    n, e = ref["dynamic_mis"]
    assert re.search(rf"^initial: \|V\|={n} \|E\|={e} \|MIS\|=\d+ rounds=\d+$", out, re.M)
    deltas = re.findall(r"^delta (\d): \+6/-6 edges \(epoch (\d)\)  repair rounds=\d+  "
                        r"cold rounds=\d+  \|MIS\|=\d+ \(cold \d+\)  valid=True$", out, re.M)
    assert deltas == [(str(i), str(i)) for i in range(1, 6)]
    assert "plan cache: {" in out


def test_hybrid_mis(ref, capsys):
    out = _run("hybrid_mis", ["--nodes", str(HYBRID_NODES)], capsys)
    n, e, thr, dense, sparse, coo = ref["hybrid_mis"]
    assert f"graph: |V|={n} |E|={e} (power-law)" in out
    assert re.search(rf"^partition @ nnz>={thr}: {dense} dense tiles \(\d+%\) \+ {sparse} sparse "
                     rf"tiles \({coo} COO edges\) of {dense + sparse} stored$", out, re.M)
    assert re.search(r"^\|MIS\|=\d+ rounds=\d+ \(both routings\)$", out, re.M)
    rounds = re.findall(r"^  round (\d+): alive= *\d+  tiles routed dense= *\d+ sparse= *(\d+)$",
                        out, re.M)
    assert rounds and all(int(s) == sparse for _, s in rounds)


def test_mis_heuristics(capsys):
    out = _run("mis_heuristics", ["--nodes", "4000", "--small-nodes", "500"], capsys)
    assert re.search(r"^ECL-MIS baseline: \|MIS\| = [\d,]+$", out, re.M)
    for h in ("h1", "h2", "h3"):
        assert re.search(rf"^TC-MIS {h}: \|MIS\| = [\d,]+  \([+-]\d+\.\d\d% vs ECL\)  "
                         r"rounds=\d+ valid=True$", out, re.M), h
    assert "pallas == oracle: True" in out


def test_distributed_mis(ref, capsys):
    out = _run("distributed_mis", ["--nodes", str(G5_NODES)], capsys)
    n, tiles, route = ref["distributed_mis"]
    assert f"|V|={n:,}; {tiles:,} tiles over 1 shards (routing: {route})" in out
    assert re.search(r"^distributed: \|MIS\|=[\d,]+ rounds=\d+ valid=True shards=1$", out, re.M)
    assert "matches single-device bit-for-bit: True" in out


def test_health_dashboard(capsys):
    out = _run("health_dashboard", [], capsys)
    trend = re.findall(r"^ +(\d)\.0 +(\d\.\d{4}) +(\d\.\d{4}) +\d\.\d{5} +-?\d\.\d{4}$", out, re.M)
    assert [int(t[0]) for t in trend] == [1, 2, 3, 4, 5]
    for op, n in (("solve", 1), ("batched", 4), ("update", 5)):
        assert re.search(rf"^  {op} +n={n} +p50=", out, re.M), op
    assert "== roofline attribution (last solve) ==" in out
    assert "# TYPE repro_dyngraph_epoch gauge" in out and "repro_dyngraph_epoch 5.0" in out


def test_serve_lm(capsys):
    out = _run("serve_lm", ["--arch", "mixtral-8x22b", "--gen", "4"], capsys)
    assert "arch=mixtral-8x22b batch=4" in out
    assert re.search(r"^decode  4 steps: [\d.]+ ms \([\d.]+ ms/tok, ring=36\)$", out, re.M)
    assert re.search(r"^sample token ids: \[(\d+, ){3}\d+\]$", out, re.M)


def test_train_lm(ref, capsys, tmp_path):
    out = _run("train_lm", ["--steps", "2", "--ckpt", str(tmp_path / "ckpt")], capsys)
    assert f"qwen3-0.6b (reduced): {ref['train_lm'] / 1e6:.1f}M params" in out
    assert "fresh run" in out and "stragglers=0 recoveries=0" in out
    loss = float(re.search(r"final: \{'loss': ([\d.]+),", out).group(1))
    assert math.isfinite(loss)


def test_every_example_has_a_port():
    """One `examples/torch_<name>.py` for each reference example."""
    ref_names = sorted(p.stem for p in (REPO / "examples").glob("*.py")
                       if not p.stem.startswith("torch_"))
    assert ref_names == sorted(NAMES)
    assert all((REPO / "examples" / f"torch_{n}.py").exists() for n in NAMES)
