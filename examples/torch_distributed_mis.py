"""Multi-card TC-MIS on the port: row-partitioned BSR + bit-packed frontier
gathers over a `torch.distributed` group, verified bit-identical to the
one-card run — both reached through the same `Solver` front door
(`placement` is the only thing that changes).

    PYTHONPATH=src python examples/torch_distributed_mis.py [--device cpu]

Alone, the script starts a one-process group (NCCL on the card, gloo with
`--device cpu`) and runs the sharded route on it.  Over several ranks,
start one process a card; each joins the group torchrun describes:

    PYTHONPATH=src torchrun --nproc-per-node 4 examples/torch_distributed_mis.py
"""
import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api import PlanCache, Solver, SolveOptions
from repro_torch.core import is_valid_mis
from repro_torch.graphs.generators import GRAPH_SUITE


def _start_group(device: str) -> torch.device:
    """This rank's device, the default group started for it: torchrun's
    when its variables are set, else one rank in this process."""
    rank = int(os.environ.get("LOCAL_RANK", 0))
    dev = torch.device("cuda", rank) if device == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    if "RANK" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)
    return dev


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--nodes", type=int, default=10_000, help="the G5 stand-in's vertices")
    args = ap.parse_args(argv)
    started = not dist.is_initialized()
    if started:
        dev = _start_group(args.device)
    else:
        dev = torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda" \
            else torch.device("cpu")
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    try:
        n_dev = dist.get_world_size()
        g = GRAPH_SUITE["G5"].make(args.nodes, 0, dev)   # web-Google stand-in

        plans = PlanCache(tile_size=64, device=dev)        # one BSR build, both placements
        sharded = Solver(SolveOptions(heuristic="h3", tile_size=64,
                                      placement="sharded", bitpack=True),
                         plans=plans, device=dev)
        plan = sharded.plan(g)
        say(f"|V|={g.n_nodes:,}; {plan.tiled.n_tiles:,} tiles over {n_dev} shards "
            f"(routing: {sharded.route(plan)})")

        res = sharded.solve(plan)
        say(f"distributed: |MIS|={res.mis_size:,} rounds={res.rounds}"
            f" valid={is_valid_mis(g, res.in_mis)}"
            f" shards={res.stats['n_shards']}")

        local = Solver(SolveOptions(heuristic="h3", engine="tiled_ref",
                                    tile_size=64, placement="local"),
                       plans=plans, device=dev).solve(plan)
        same = bool(np.all(res.in_mis == local.in_mis))
        say("matches single-device bit-for-bit:", same)
        assert same, "the sharded route's set differs from the one-card run's"
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
