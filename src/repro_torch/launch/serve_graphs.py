"""Synthetic-traffic launcher for the MIS serving layer (counterpart of
`repro.launch.serve_graphs`, the same flags and output lines, plus
``--device``).

Drives `repro_torch.serve_mis.MISService`, and through it the `Solver`
(plan cache, routing, batched loops), with waves of requests drawn from
the paper-suite generators (`graphs.generators.GRAPH_SUITE`, Table 1's
structure classes at serving scale); `--repeat-frac` of each wave re-asks
an already-seen graph, so the plan cache sees re-request traffic.  Prints
per-wave throughput and the cache counters.

    PYTHONPATH=src python -m repro_torch.launch.serve_graphs \\
        --requests 32 --scale 512 --repeat-frac 0.5 --engine tiled_ref
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve_graphs")
    p.add_argument("--requests", type=int, default=32, help="requests per wave")
    p.add_argument("--waves", type=int, default=3)
    p.add_argument("--scale", type=int, default=512, help="vertices per graph (approx)")
    p.add_argument("--repeat-frac", type=float, default=0.5,
                   help="fraction of requests re-asking an already-seen graph")
    p.add_argument("--engine", default="tiled_ref")
    p.add_argument("--tile-size", type=int, default=32)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--cache-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where graphs live and solves run (default: the CUDA device)")
    args = p.parse_args(argv)

    from repro_torch.graphs.generators import GRAPH_SUITE
    from repro_torch.serve_mis import MISService, ServeConfig

    service = MISService(ServeConfig(
        tile_size=args.tile_size,
        engine=args.engine,
        max_batch=args.max_batch,
        cache_dir=args.cache_dir,
        seed=args.seed,
    ), device=args.device)

    rng = np.random.default_rng(args.seed)
    specs = list(GRAPH_SUITE.values())
    pool = []  # graphs already requested, for repeat traffic

    for wave in range(args.waves):
        graphs = []
        for _ in range(args.requests):
            if pool and rng.random() < args.repeat_frac:
                graphs.append(pool[int(rng.integers(len(pool)))])
            else:
                spec = specs[int(rng.integers(len(specs)))]
                g = spec.make(args.scale, int(rng.integers(1 << 30)), args.device)
                pool.append(g)
                graphs.append(g)
        t0 = time.perf_counter()
        for g in graphs:
            service.submit(g)
        responses = service.drain()
        dt = time.perf_counter() - t0
        n_valid = sum(r.valid for r in responses)
        sizes = [r.mis_size for r in responses]
        print(
            f"wave {wave}: {len(responses)} req in {dt * 1e3:.1f} ms "
            f"({len(responses) / dt:.1f} graphs/s)  valid={n_valid}/{len(responses)} "
            f"|MIS| p50={int(np.median(sizes))}"
        )
        if n_valid != len(responses):
            raise SystemExit("post-condition failure under synthetic traffic")

    s, pc = service.stats, service.planner.stats
    print(
        f"total: requests={s['requests']} batches={s['batches']} "
        f"compiles={s['compiles']} graphs_solved={service.solver.stats['solves']} "
        f"plan_cache mem={pc['mem_hits']} "
        f"disk={pc['disk_hits']} built={pc['misses']}"
    )


if __name__ == "__main__":
    main()
