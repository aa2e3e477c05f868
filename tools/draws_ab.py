"""A G2 solve's set-up and warm solve, this tree against another, in turns.

    python3 tools/draws_ab.py --against build/parent [--reps 21] [--pairs 3]

Needs one CUDA card.  Unpack the other commit first (`git archive <commit>
| tar -x -C build/parent`).  Each turn is a process of its own that builds
its tree's kernels, plans G2 (`grid2d(1044, 1044)`) on the default path,
the main path (`hybrid="off"`) and the packed path (`hybrid="off",
phase1="tiled"`), then takes the median of `--reps` host-clock times (each
call synced) of the set-up alone (`core.tc_mis._setup`: priorities, bit
planes, state 0) and of a warm `Solver.solve`.  The turns run parent,
change, change, parent, ... (`--pairs` of each), so that the two trees
meet the card in the same state.  A tree whose `repro_torch.core.prng`
exists draws under `prng.key(seed)`; an older one under a
`torch.Generator` seeded alike.  Prints a line per turn and the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
PATHS = (("default", {}), ("main", {"hybrid": "off"}),
         ("packed", {"hybrid": "off", "phase1": "tiled"}))


def median_ms(fn, reps: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    took = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        took.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(took)


def one(root: pathlib.Path, reps: int) -> dict:
    """This process's turn on the tree at `root`."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.api import PlanCache, Solver, SolveOptions
    from repro_torch.core.tc_mis import _setup
    from repro_torch.graphs import grid2d
    from repro_torch.hopper import build

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    build.build_all()
    try:
        from repro_torch.core import prng

        def draw(seed):
            return prng.key(seed)
    except ImportError:
        def draw(seed):
            return torch.Generator(device="cuda").manual_seed(seed)

    g2 = grid2d(1044, 1044, device="cuda")
    plans = PlanCache(device="cuda")
    out = {}
    for label, kw in PATHS:
        opts = SolveOptions(**kw)
        solver = Solver(opts, device="cuda", plans=plans)
        plan = solver.plan(g2)
        res = solver.solve(plan)
        out[label] = {
            "setup_ms": median_ms(
                lambda: _setup(plan.g, plan.tiled, draw(opts.seed), opts), reps),
            "solve_ms": median_ms(lambda: solver.solve(plan), reps),
            "mis": res.mis_size, "rounds": res.rounds,
        }
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=pathlib.Path, help="the other tree's root")
    ap.add_argument("--one", type=pathlib.Path, help=argparse.SUPPRESS)
    ap.add_argument("--reps", type=int, default=21)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(one(args.one.resolve(), args.reps)), flush=True)
        return
    if args.against is None:
        ap.error("--against is required")
    trees = {"parent": args.against.resolve(), "change": ROOT}
    order = []
    for i in range(args.pairs):
        order += ["parent", "change"] if i % 2 == 0 else ["change", "parent"]
    for turn, name in enumerate(order):
        proc = subprocess.run(
            [sys.executable, __file__, "--one", str(trees[name]), "--reps", str(args.reps)],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{name} turn failed:\n{proc.stdout}\n{proc.stderr}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"[draws_ab] turn {turn} {name}: " + "; ".join(
            f"{p} set-up {r['setup_ms']:.3f} ms, solve {r['solve_ms']:.3f} ms, "
            f"mis {r['mis']} in {r['rounds']} rounds" for p, r in res.items()), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    print(f"[draws_ab] {card.stdout.strip()}", flush=True)


if __name__ == "__main__":
    main()
