"""MIS serving CLI (counterpart of `python -m repro.serve_mis`, the same
flags, output lines and exit codes, plus ``--device``).

One-shot: solve the named files and exit non-zero unless every response
is a validated MIS:

    PYTHONPATH=src python -m repro_torch.serve_mis --once \\
        tests/fixtures/tiny.mtx tests/fixtures/tiny.edges

Streaming: without ``--once``, graph file paths are read one per line from
stdin and dispatched whenever a full batch has gathered (EOF drains the
queue): `cat work.list | python -m repro_torch.serve_mis`.

``--repeat N`` submits every input N times, which shows the plan cache at
work in the stats.

Dynamic graphs: the ``update`` verb patches a served request's graph with
a delta file (``+ u v`` / ``- u v`` lines, `dyngraph.stream.load_delta`)
and repairs its solution instead of re-ingesting:

    stream mode    a line ``update <request_id> <delta_file>``
    --once mode    ``--update ID:DELTA_FILE`` (repeatable), applied after
                   the initial solves drain

``--stream-ingest`` loads graph files through the chunked readers
(`dyngraph.stream.load_graph_stream`).  ``--device cpu`` runs on the CPU;
the default is the CUDA device, and without one the CLI raises.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.serve_mis.service import MISService, ServeConfig


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m repro_torch.serve_mis")
    p.add_argument("paths", nargs="*", help="graph files (.mtx/.edges/.dimacs/...)")
    p.add_argument("--once", action="store_true",
                   help="solve the given paths, print stats, exit")
    p.add_argument("--fmt", default=None, choices=["edgelist", "mtx", "dimacs"],
                   help="override format auto-detection")
    p.add_argument("--repeat", type=int, default=1,
                   help="submit every input N times (exercises the plan cache)")
    p.add_argument("--tile-size", type=int, default=32)
    p.add_argument("--storage", default="auto", choices=["auto", "int8", "bitpack"],
                   help="tile storage format")
    p.add_argument("--engine", default="fused_pallas")
    p.add_argument("--heuristic", default="h3")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--reorder", default=None, choices=["rcm"])
    p.add_argument("--cache-dir", default=None,
                   help="persist tile plans here (content-addressed .npz)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--repair", default="auto", choices=["auto", "cold", "incremental"],
                   help="how `update` requests re-solve")
    p.add_argument("--update", action="append", default=[], metavar="ID:DELTA_FILE",
                   help="--once mode: after the initial solves, patch request ID "
                        "with the delta file and repair")
    p.add_argument("--stream-ingest", action="store_true",
                   help="ingest via the chunked readers (dyngraph.stream) "
                        "instead of readlines()")
    p.add_argument("--telemetry", action="store_true",
                   help="record the per-round device buffer; responses carry "
                        "a per-round summary")
    p.add_argument("--trace-path", default=None, metavar="FILE",
                   help="append span traces + round series as JSONL here "
                        "(render with `python -m repro_torch.obs report FILE`)")
    p.add_argument("--metrics", action="store_true",
                   help="print the merged metrics snapshot as JSON on stderr at exit")
    p.add_argument("--metrics-path", default=None, metavar="FILE",
                   help="write the merged snapshot as Prometheus text to FILE at "
                        "exit (atomic replace: point a textfile collector at it)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where plans live and solves run (default: the CUDA device)")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    service = MISService(ServeConfig(
        tile_size=args.tile_size,
        storage=args.storage,
        engine=args.engine,
        heuristic=args.heuristic,
        max_batch=args.max_batch,
        reorder=args.reorder,
        cache_dir=args.cache_dir,
        seed=args.seed,
        repair=args.repair,
        telemetry=args.telemetry,
        trace_path=args.trace_path,
    ), device=args.device)

    def emit(responses) -> int:
        bad = 0
        for r in responses:
            print(json.dumps(r.summary()), flush=True)
            bad += 0 if r.valid else 1
        return bad

    def submit(path) -> int:
        """One bad request must not kill the stream: report it, keep serving."""
        try:
            for _ in range(args.repeat):
                service.submit(path, fmt=args.fmt, stream=args.stream_ingest)
            return 0
        except (OSError, ValueError) as e:  # a missing file, GraphParseError, ...
            print(json.dumps(dict(source=str(path), valid=False,
                                  error=f"{type(e).__name__}: {e}")), flush=True)
            return args.repeat

    def submit_update(base_id, delta_path) -> int:
        """The `update` verb: patch a served request's graph, repair."""
        from repro_torch.dyngraph.stream import load_delta

        try:
            service.submit_update(int(base_id), load_delta(delta_path))
            return 0
        except (OSError, ValueError, KeyError) as e:
            print(json.dumps(dict(source=f"update:{base_id}:{delta_path}", valid=False,
                                  error=f"{type(e).__name__}: {e}")), flush=True)
            return 1

    failures = 0
    if args.once:
        if not args.paths:
            print("--once needs at least one graph file", file=sys.stderr)
            return 2
        for path in args.paths:
            failures += submit(path)
        failures += emit(service.drain())
        for spec in args.update:
            base_id, _, delta_path = spec.partition(":")
            failures += submit_update(base_id, delta_path)
            # drain per update, so a later spec can chain off this one's id
            failures += emit(service.drain())
    else:
        sources = args.paths or (line.strip() for line in sys.stdin)
        for src in sources:
            if not src:
                continue
            if src.startswith("update "):
                # `update <request_id> <delta_file>`: the target must have
                # been served, so flush the queue first
                failures += emit(service.drain())
                parts = src.split(maxsplit=2)
                if len(parts) != 3:
                    print(json.dumps(dict(source=src, valid=False,
                                          error="usage: update <id> <delta_file>")),
                          flush=True)
                    failures += 1
                    continue
                failures += submit_update(parts[1], parts[2])
                continue
            failures += submit(src)
            while service.pending >= service.config.max_batch:
                failures += emit(service.step())
        failures += emit(service.drain())

    s, p = service.stats, service.planner.stats
    print(
        f"# served={s['requests']} batches={s['batches']} "
        f"compiles={s['compiles']} plan_cache mem={p['mem_hits']} "
        f"disk={p['disk_hits']} built={p['misses']} failures={failures}",
        file=sys.stderr,
    )
    if args.metrics:
        print(json.dumps(service.metrics_snapshot(), sort_keys=True), file=sys.stderr)
    if args.metrics_path:
        from repro_torch.obs.promtext import write_promtext

        write_promtext(service.metrics_snapshot(), args.metrics_path)
        print(f"# wrote promtext to {args.metrics_path}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
