"""The port's front door in one screen: `Plan` / `SolveOptions` / `Solver`
of `repro_torch`, on the CUDA card by default.

Every MIS execution path of the port — single graphs, batched serving
workloads, profiled engine runs, and (over a `torch.distributed` group)
the sharded path — is reached through the same three nouns.

    PYTHONPATH=src python examples/torch_solver_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.api import Plan, Solver, SolveOptions, choose_tile_size
from repro_torch.graphs.generators import erdos_renyi, grid2d, powerlaw


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = args.device
    g = erdos_renyi(600, avg_deg=6.0, seed=0, device=dev)

    # -- one graph, default options (auto tile size, auto placement) -------
    solver = Solver(SolveOptions(engine="tiled_ref"), device=dev)   # the plain-torch oracle
    res = solver.solve(g)
    print(f"solve:       |V|={g.n_nodes} -> |MIS|={res.mis_size} "
          f"rounds={res.rounds} placement={res.placement} "
          f"T={res.plan.tile_size} (auto-T policy: "
          f"{choose_tile_size(g.n_nodes, g.n_edges)})")

    # -- a serving-style workload: ONE convergence loop for the whole batch -
    batch = [grid2d(6, 6, device=dev), powerlaw(48, seed=1, device=dev),
             erdos_renyi(64, seed=2, device=dev), erdos_renyi(24, avg_deg=3.0, seed=3, device=dev)]
    many = Solver(SolveOptions(engine="tiled_ref", tile_size=16), device=dev)
    results = many.solve_many(batch)
    print(f"solve_many:  {len(results)} graphs, bucket "
          f"{results[0].stats['bucket']}, per-member rounds "
          f"{[r.rounds for r in results]}")
    assert many.solve_many([]) == []            # no bucket for nothing
    assert many.solve_many([batch[0]])[0].placement == "local"  # or a singleton

    # -- plans are immutable, content-addressed artifacts ------------------
    plan = Plan.build(g, tile_size=32)
    again = many.solve(plan)                     # a Plan routes like a Graph
    print(f"Plan.build:  key={plan.key[:12]}… T={plan.tile_size} "
          f"tiles={plan.tiled.n_tiles} |MIS|={again.mis_size}")

    # -- the profiler twin returns the SAME set with per-phase timers ------
    prof, times = solver.profile(g)
    assert bool(np.all(prof.in_mis == res.in_mis))
    share = {k: round(1e3 * times[k], 2) for k in ("phase1", "phase2", "phase3")}
    print(f"profile:     bit-identical to solve; ms/phase={share} "
          f"rounds={times['rounds']}")


if __name__ == "__main__":
    main()
