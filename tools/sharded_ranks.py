#!/usr/bin/env python3
"""The Solver's sharded route across ranks: G2 (`grid2d(1044, 1044)`) split
over the ranks of one `torch.distributed` group, one process per rank.

    python3 tools/sharded_ranks.py [--ranks 4] [--device cuda|cpu] [--shape 1044 1044]

With `--device cuda` (the default) rank r owns card r and the group is
NCCL; with `--device cpu` the ranks are gloo processes on the CPU (a
rehearsal at a small `--shape`).  The group meets at tcp://localhost on a
free port.  Every rank:

  - solves G2 with `SolveOptions(bitpack=...)` as it is, placement "auto",
    which must route "sharded" (the padded graph passes `shard_threshold`
    and the group has more than one rank), with packed and with byte
    gathers;
  - checks that its MIS and rounds equal the local route's on its own
    device (`SolveOptions(hybrid="off", placement="local")`, the main
    path), that `n_shards` is the world size and that the split SpMV
    launched once a round and no other kernel ran (on the card);
  - times the median of 5 warm sharded solves and of 5 local ones (host
    clock; each solve ends on host reads of the gathered state), the
    first sharded solve (its slab build included), and one all-gather of
    the alive set, packed and as bytes (host clock over 20 gathers,
    synced).

Rank 0 prints one JSON line of its numbers, beside the card's name and
power limit; the script exits non-zero if any rank fails or overruns
`--timeout`, and stops every rank it started.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import socket
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, sync, n: int = 5) -> float:
    took = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync()
        took.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(took)


def rank_main(args) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.api import Solver, SolveOptions
    from repro_torch.core import distributed as D
    from repro_torch.graphs import grid2d
    from repro_torch.hopper import tc_neighbor_max as N
    from repro_torch.hopper import tc_spmv as K

    cuda = args.device == "cuda"
    dev = torch.device("cuda", args.rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    else:   # the ranks share the host's cores
        torch.set_num_threads(max((os.cpu_count() or 1) // args.ranks, 1))
    kw = {"device_id": dev} if cuda else {}
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{args.port}",
                            rank=args.rank, world_size=args.ranks, **kw)
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    wrappers = [K.tc_spmv_fused, K.tc_spmv, K.tc_spmv_fused_bits, K.tc_spmv_bits,
                N.tc_neighbor_max, N.tc_neighbor_max_bits]

    def fail(msg: str) -> None:
        print(f"FAIL rank {args.rank}: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)

    g = grid2d(*args.shape, device=dev)
    local_solver = Solver(SolveOptions(hybrid="off", placement="local"), device=dev)
    local_plan = local_solver.plan(g)
    local = local_solver.solve(local_plan)
    out = {"ranks": args.ranks, "shape": list(args.shape), "n_nodes": g.n_nodes,
           "local": {"mis": local.mis_size, "rounds": local.rounds,
                     "warm_ms": median_ms(lambda: local_solver.solve(local_plan), sync)}}
    for bitpack in (True, False):
        solver = Solver(SolveOptions(bitpack=bitpack), device=dev)
        plan = solver.plan(g)
        if solver.route(plan) != "sharded":
            fail(f"placement auto routed {solver.route(plan)}")
        for w in wrappers:
            w.launches = 0
        t0 = time.perf_counter()
        res = solver.solve(plan)
        sync()
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = {w.__name__: w.launches for w in wrappers}
        # CPU ranks run the plain versions, which count no launch
        want = {w.__name__: res.rounds if w is K.tc_spmv and cuda else 0 for w in wrappers}
        if launches != want:
            fail(f"bitpack={bitpack}: launches {launches}, expected {want}")
        if res.placement != "sharded" or res.stats["n_shards"] != args.ranks:
            fail(f"bitpack={bitpack}: {res.placement}, {res.stats}")
        if res.rounds != local.rounds or not np.array_equal(res.in_mis, local.in_mis):
            fail(f"bitpack={bitpack}: MIS {res.mis_size} in {res.rounds} rounds, the local "
                 f"route's {local.mis_size} in {local.rounds}")
        warm_ms = median_ms(lambda: solver.solve(plan), sync)
        n_local = plan.tiled.n_block_rows // args.ranks * plan.tile_size
        alive = torch.ones(max(n_local, plan.tile_size), dtype=torch.bool, device=dev)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(20):
            D.gather_bool(alive, plan.tile_size, bitpack=bitpack)
        sync()
        gather_ms = (time.perf_counter() - t0) * 1e3 / 20
        out["packed" if bitpack else "bytes"] = {
            "mis": res.mis_size, "rounds": res.rounds, "launches": launches["tc_spmv"],
            "first_ms": first_ms, "warm_ms": warm_ms, "gather_ms": gather_ms,
            "equal_local": True}
    dist.barrier()
    dist.destroy_process_group()
    if args.rank == 0:
        if cuda:
            out["card"] = card_line()
        print(json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--shape", type=int, nargs=2, default=(1044, 1044))
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args)
        return
    if args.device == "cuda":
        import torch

        if torch.cuda.device_count() < args.ranks:
            sys.exit(f"{args.ranks} ranks need {args.ranks} CUDA cards, "
                     f"found {torch.cuda.device_count()}")
    port = free_port()
    cmd = [sys.executable, str(pathlib.Path(__file__).resolve()), "--ranks", str(args.ranks),
           "--device", args.device, "--shape", *map(str, args.shape), "--port", str(port)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)]) for r in range(args.ranks)]
    deadline = time.monotonic() + args.timeout
    rc = 0
    try:
        for p in procs:
            try:
                rc = rc or p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                print(f"FAIL: a rank ran past {args.timeout} s", file=sys.stderr)
                rc = 1
                break
            if rc:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    sys.exit(rc)


if __name__ == "__main__":
    main()
