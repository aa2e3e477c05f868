#!/usr/bin/env python3
"""Where a `Solver.update` on G2 spends its time, step by step, on the card.

    python3 tools/update_breakdown.py [--fracs 0.002,0.05] [--path off]

G2 (`grid2d(1044, 1044)`) is planned and solved once, then for each delta
fraction (k adds and k removes, k = int(n_und · frac) // 2, seed
int(frac · 1e4), as benchmarks/dyngraph_bench.py draws them) the script
times, synced, three times each: the edge-list patch
(`apply_graph_delta`), the tile patch (`apply_delta`), the delta's hash
and endpoints, the whole `patch_plan`, a plan-cache hit, the warm start,
the warm loop against a cold loop on the patched plan, and `update` as a
caller sees it; then a cProfile of one `update` and one `patch_plan`
(host time by function) and a torch.profiler table of one `update`.
`--path` picks the options: default (`SolveOptions()`), off
(`hybrid="off"`) or packed (`hybrid="off", phase1="tiled"`).  Needs one
CUDA card.
"""
from __future__ import annotations

import argparse
import cProfile
import pathlib
import pstats
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

PATHS = {"default": {}, "off": {"hybrid": "off"}, "packed": {"hybrid": "off", "phase1": "tiled"}}


def timed(label: str, fn, n: int = 3):
    """fn() n times, synced; prints each time in ms; returns the last output."""
    import torch

    out, took = None, []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        took.append((time.perf_counter() - t0) * 1e3)
    print(f"{label}: {[round(x, 3) for x in took]} ms", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fracs", default="0.002,0.05")
    ap.add_argument("--path", choices=sorted(PATHS), default="off")
    args = ap.parse_args()

    import numpy as np
    import torch
    from repro_torch.api import PlanCache, Solver, SolveOptions, patch_plan
    from repro_torch.core import prng
    from repro_torch.core.tc_mis import run_tc_mis
    from repro_torch.dyngraph import apply_delta, apply_graph_delta, random_delta
    from repro_torch.dyngraph.repair import dirty_mask, warm_start
    from repro_torch.graphs import grid2d

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    print(f"numpy {np.__version__}, torch {torch.__version__}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    g = grid2d(1044, 1044, device="cuda")
    plans = PlanCache(tile_size=16, storage="bitpack", device="cuda")
    solver = Solver(SolveOptions(repair="incremental", **PATHS[args.path]), plans=plans)
    plan = solver.plan(g)
    prior = solver.solve(plan)
    prior_t = torch.from_numpy(prior.in_mis).cuda()
    for frac in (float(f) for f in args.fracs.split(",")):
        k = int(g.n_edges // 2 * frac) // 2
        delta = random_delta(g, k, k, seed=int(frac * 1e4))
        print(f"--- {args.path} path, delta {frac:.1%}: {k} adds + {k} removes", flush=True)
        timed("apply_graph_delta", lambda: apply_graph_delta(g, delta))
        timed("apply_delta (tiles)", lambda: apply_delta(plan.tiled, delta))
        timed("content_key", lambda: delta.content_key)
        timed("touched", lambda: delta.touched())
        patched = timed("patch_plan", lambda: patch_plan(plan, delta))
        plans.apply_delta(plan, delta)
        timed("plan-cache hit", lambda: plans.apply_delta(plan, delta))
        dirty = torch.from_numpy(dirty_mask(g.n_nodes, delta.touched())).cuda()
        alive0, in_mis0 = timed("warm_start", lambda: warm_start(
            patched.g, patched.tiled, solver.options, prior_t, dirty))

        def loop(**kw):
            return run_tc_mis(patched.g, patched.tiled, prng.key(0), solver.options, **kw)

        timed("warm loop", lambda: loop(alive0=alive0, in_mis0=in_mis0))
        timed("cold loop", loop)
        timed("update", lambda: solver.update(prior, delta))
        for label, fn in (("update", lambda: solver.update(prior, delta)),
                          ("patch_plan", lambda: patch_plan(plan, delta))):
            prof = cProfile.Profile()
            prof.enable()
            fn()
            torch.cuda.synchronize()
            prof.disable()
            print(f"host time of one {label}, by function:", flush=True)
            pstats.Stats(prof).sort_stats("tottime").print_stats(8)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as tp:
            solver.update(prior, delta)
            torch.cuda.synchronize()
        print(tp.key_averages().table(sort_by="cuda_time_total", row_limit=10), flush=True)


if __name__ == "__main__":
    main()
