"""Dynamic MIS on the port in ~30 lines: a mutating graph, repaired — not
re-solved — on the CUDA card by default.

    PYTHONPATH=src python examples/torch_dynamic_mis.py [--device cpu]

Ingests a graph, then applies a stream of edge deltas.  Each delta patches
the cached plan tile-locally (`Plan.apply_delta`) and repairs the prior
solution by warm-starting the round engine on just the dirty frontier
(`Solver.update`) — compare the repair round counts against what a cold
re-solve of the same mutated graph needs.
"""
import argparse

from repro_torch.api import Solver, SolveOptions
from repro_torch.core.validate import is_valid_mis_checks
from repro_torch.dyngraph import random_delta
from repro_torch.graphs.generators import erdos_renyi


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    # 1. ingest and cold-solve the initial graph
    g = erdos_renyi(600, avg_deg=6.0, seed=0, device=args.device)
    solver = Solver(SolveOptions(
        engine="tiled_ref", tile_size=16, repair="incremental",
    ), device=args.device)
    result = solver.solve(g)
    print(f"initial: |V|={g.n_nodes} |E|={g.n_edges // 2} "
          f"|MIS|={result.mis_size} rounds={result.rounds}")

    # 2. a stream of deltas: each patches the plan and repairs the solution
    for step in range(1, 6):
        delta = random_delta(result.plan.g, n_add=6, n_remove=6, seed=step)
        result = solver.update(result, delta)          # incremental repair
        cold = solver.solve(result.plan)               # the counterfactual
        ok = all(is_valid_mis_checks(result.plan.g, result.in_mis_plan))
        assert ok, "repaired solution failed the MIS invariants"
        print(f"delta {step}: +{delta.n_add}/-{delta.n_remove} edges "
              f"(epoch {result.plan.epoch})  repair rounds={result.rounds}  "
              f"cold rounds={cold.rounds}  |MIS|={result.mis_size} "
              f"(cold {cold.mis_size})  valid={ok}")

    # 3. the plan cache followed the lineage: one live entry, stale epochs
    #    evicted
    print(f"plan cache: {solver.plans.stats}")


if __name__ == "__main__":
    main()
