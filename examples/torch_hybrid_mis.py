"""Hybrid tile routing on the port in ~40 lines: classify, partition,
solve, on the CUDA card by default.

    PYTHONPATH=src python examples/torch_hybrid_mis.py [--device cpu]

Skewed (power-law) graphs tile badly: a few hub block-rows pack thousands
of edges per tile while the long tail stores a handful.  The hybrid plan
classifies every stored tile by nnz against a roofline break-even
threshold, routes the dense survivors through the tile path (the Hopper
kernels on the card), and streams the sparse tail as COO through segment
ops — same solution, bit for bit, less superfluous tile work.
"""
import argparse

import numpy as np

from repro_torch.api import Solver, SolveOptions
from repro_torch.graphs.generators import powerlaw


def _solve_ms(solver: Solver, g, iters: int = 3) -> float:
    solver.solve(g)                      # warm: plan off the clock
    return min(float(solver.solve(g).stats["solve_ms"]) for _ in range(iters))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--nodes", type=int, default=4096, help="the power-law graph's vertices")
    args = ap.parse_args(argv)
    dev = args.device
    g = powerlaw(args.nodes, avg_deg=16.0, seed=0, device=dev)
    print(f"graph: |V|={g.n_nodes} |E|={g.n_edges // 2} (power-law)")

    # 1. the hybrid plan: same graph, per-tile dense/sparse classification.
    #    The explicit override keeps the hub tiles on the tile path so the
    #    split is visible (leave hybrid_threshold=None for the H100 model's)
    hybrid = Solver(SolveOptions(engine="tiled_ref", tile_size=64,
                                 hybrid="forced", hybrid_threshold=32), device=dev)
    plan = hybrid.plan(g)
    part = plan.tiled.partition
    total = part.n_dense_tiles + part.n_sparse_tiles
    print(f"partition @ nnz>={part.threshold}: "
          f"{part.n_dense_tiles} dense tiles ({part.n_dense_tiles / total:.0%}) "
          f"+ {part.n_sparse_tiles} sparse tiles "
          f"({part.sp_nnz} COO edges) of {total} stored")

    # 2. solve both routings — the solutions must be bit-identical
    dense = Solver(SolveOptions(engine="tiled_ref", tile_size=64,
                                hybrid="off"), device=dev)
    hy_ms = _solve_ms(hybrid, g)
    de_ms = _solve_ms(dense, g)
    r_h, r_d = hybrid.solve(g), dense.solve(g)
    assert (np.asarray(r_h.in_mis) == np.asarray(r_d.in_mis)).all(), (
        "routing changed the solution"
    )
    print(f"|MIS|={r_h.mis_size} rounds={r_h.rounds} (both routings)")
    print(f"hybrid {hy_ms:.1f} ms  vs  dense {de_ms:.1f} ms  "
          f"-> {de_ms / max(hy_ms, 1e-9):.2f}x")

    # 3. per-round routing telemetry: how many tiles each path carried
    tsolver = Solver(SolveOptions(engine="tiled_ref", tile_size=64,
                                  hybrid="forced", hybrid_threshold=32,
                                  telemetry=True), device=dev)
    rt = tsolver.solve(g).telemetry
    for r in range(rt.rounds):
        print(f"  round {r}: alive={rt.alive[r]:5d}  "
              f"tiles routed dense={rt.tiles_dense[r]:4d} "
              f"sparse={rt.tiles_sparse[r]:4d}")


if __name__ == "__main__":
    main()
