"""Quickstart on the PyTorch port: TC-MIS end-to-end on one graph, in ~20
lines of `repro_torch`'s public API, on the CUDA card by default.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.api import PlanCache, Solver, SolveOptions
from repro_torch.core import cardinality, ecl_mis, engine_names, is_valid_mis, luby_mis, prng
from repro_torch.graphs.generators import GRAPH_SUITE


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--nodes", type=int, default=8192, help="the G3 stand-in's vertices")
    ap.add_argument("--small-nodes", type=int, default=1024,
                    help="the vertices of the graph every engine solves")
    args = ap.parse_args(argv)

    # a reduced-scale stand-in for the paper's G3 (delaunay_n19)
    g = GRAPH_SUITE["G3"].make(args.nodes, 0, args.device)
    print(f"graph: |V|={g.n_nodes:,} half-edges={g.n_edges:,}")

    # 1. baselines on the edge list, priorities under a seeded key (the
    #    reference's jax.random.key(0), bit for bit)
    for name, fn in [("luby", luby_mis), ("ecl ", ecl_mis)]:
        res = fn(g, prng.key(0))
        assert is_valid_mis(g, res.in_mis)
        print(f"{name}  : |MIS|={cardinality(res.in_mis):,} "
              f"rounds={int(res.rounds)} valid=True")

    # 2. TC-MIS through the front door: the Solver plans (BSR tiling, the
    #    paper's §3.2 representation), routes, and runs to convergence
    solver = Solver(SolveOptions(heuristic="h3", engine="tiled_ref", tile_size=64),
                    device=args.device)
    plan = solver.plan(g)
    print(f"BSR: {plan.tiled.n_tiles:,} tiles of {plan.tile_size}×{plan.tile_size}"
          f" (routing: {solver.route(plan)})")
    res = solver.solve(plan)
    assert is_valid_mis(g, res.in_mis)
    print(f"tc-mis: |MIS|={res.mis_size:,} rounds={res.rounds} valid=True")

    # 3. the registry contract, one engine per line: same priorities ⇒ the
    #    identical set from every engine (the Hopper kernels on the card,
    #    their plain versions on the CPU)
    g_s = GRAPH_SUITE["G3"].make(args.small_nodes, 0, args.device)
    plans = PlanCache(tile_size=32, device=args.device)   # ONE tiling, 4 engines
    ref = None
    for backend in engine_names():
        r = Solver(SolveOptions(heuristic="h3", engine=backend, tile_size=32),
                   plans=plans, device=args.device).solve(g_s)
        assert is_valid_mis(g_s, r.in_mis)
        ref = r.in_mis if ref is None else ref
        assert bool(np.all(r.in_mis == ref)), backend
        print(f"tc-mis[{backend:12s}]: |MIS|={r.mis_size:,} "
              f"rounds={r.rounds} valid=True")


if __name__ == "__main__":
    main()
