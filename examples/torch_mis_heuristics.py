"""The paper's Fig. 3 quality study on one graph, on the port: H1 vs H2 vs
H3 vs ECL-MIS cardinality, plus the kernel engine's equivalence check, on
the CUDA card by default.

    PYTHONPATH=src python examples/torch_mis_heuristics.py [--device cpu]
"""
import argparse
import dataclasses

import numpy as np

from repro_torch.api import PlanCache, Solver, SolveOptions
from repro_torch.core import cardinality, ecl_mis, is_valid_mis, prng
from repro_torch.graphs.generators import powerlaw


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--nodes", type=int, default=20_000, help="the study graph's vertices")
    ap.add_argument("--small-nodes", type=int, default=2_000,
                    help="the vertices of the kernel engine's check")
    args = ap.parse_args(argv)
    dev = args.device

    # hub-heavy graph (wiki-Talk-like) — where heuristics matter most
    g = powerlaw(args.nodes, avg_deg=4.0, seed=0, device=dev)
    plans = PlanCache(tile_size=64, device=dev)   # one BSR build serves every solver below

    base = cardinality(ecl_mis(g, prng.key(0)).in_mis)
    print(f"ECL-MIS baseline: |MIS| = {base:,}")
    for h in ("h1", "h2", "h3"):
        res = Solver(SolveOptions(heuristic=h, engine="tiled_ref", tile_size=64),
                     plans=plans, device=dev).solve(g)
        c = res.mis_size
        print(f"TC-MIS {h}: |MIS| = {c:,}  ({100*(c-base)/base:+.2f}% vs ECL)"
              f"  rounds={res.rounds} "
              f"valid={is_valid_mis(g, res.in_mis)}")

    # the kernel engine (named tiled_pallas, as the reference's) must agree
    # bit-for-bit with the plain-torch oracle
    # (its Hopper kernels on the card, their plain versions on the CPU)
    g_s = powerlaw(args.small_nodes, avg_deg=4.0, seed=0, device=dev)
    opts = SolveOptions(heuristic="h3", phase1="tiled", tile_size=32)
    r_ref = Solver(dataclasses.replace(opts, engine="tiled_ref"), plans=plans,
                   device=dev).solve(g_s)
    r_pal = Solver(dataclasses.replace(opts, engine="tiled_pallas"), plans=plans,
                   device=dev).solve(g_s)
    print("pallas == oracle:", bool(np.all(r_ref.in_mis == r_pal.in_mis)))


if __name__ == "__main__":
    main()
