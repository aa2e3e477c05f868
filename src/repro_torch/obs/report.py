"""`python -m repro_torch.obs report trace.jsonl`: telemetry for humans
(counterpart of `repro.obs.report`, the same text byte for byte).

Three record kinds land in one JSONL stream (`JsonlWriter`):

    {"kind": "trace",   "request_id": ..., "spans": [...]}
    {"kind": "rounds",  "rounds": R, "alive": [...], ...}
    {"kind": "metrics", "metrics": {...}}

plus bench-history records (no ``kind``; ``key`` / ``metric`` /
``value_us``), rendered as one timing line each.

Trace records render as an indented span tree with durations, rounds
records as a per-round table with a sparkline of the alive series,
metrics records as a name → value table whose histograms read as
count/mean/p50/p95/p99.  ``--json`` gives one machine-readable document
instead.  The exit code is 2 when the file holds no renderable record, so
a smoke step catches an empty pipe.

``bench-diff <base> <head>`` hands its arguments to `obs.bench.main`,
the regression gate over two bench-history files (exit 0 ok, 1 a
regression, 2 no common key), as the reference's front door does.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

from repro_torch.obs.rounds import RoundTrace

_SPARK = "▁▂▃▄▅▆▇█"


def _sparkline(values: List[int]) -> str:
    """Unicode mini-chart; safe for empty, single-point, all-zero and
    negative series (negatives clamp to the bottom glyph)."""
    if not values:
        return ""
    hi = max(values)
    if hi <= 0:
        return _SPARK[0] * len(values)
    return "".join(_SPARK[min(max(int(v * 8 / hi), 0), 7)] for v in values)


def render_trace(d: Dict, out) -> None:
    rid = d.get("request_id") or "-"
    spans = d.get("spans", [])
    total = max((s["start_ms"] + s["dur_ms"] for s in spans), default=0.0)
    out.write(f"trace {rid}  ({total:.2f} ms, {len(spans)} spans)\n")
    for s in spans:
        indent = "  " * (int(s.get("depth", 0)) + 1)
        meta = s.get("meta") or {}
        tail = ("  " + " ".join(f"{k}={v}" for k, v in sorted(meta.items()))) if meta else ""
        out.write(f"{indent}{s['name']:<20} {s['dur_ms']:>9.3f} ms{tail}\n")


def render_rounds(d: Dict, out) -> None:
    rt = RoundTrace.from_dict(d)
    s = rt.summary()
    if not rt.rounds:
        # a 0-round trace is legal (an empty graph, a no-op update), and
        # its summary has no per-round keys
        out.write("rounds 0  (empty trace)\n")
        return
    out.write(
        f"rounds {rt.rounds}"
        f"  alive {s.get('alive0', 0)}→{s.get('alive_final', 0)}"
        f"  selected {s.get('selected_total', 0)}"
    )
    if rt.tiles_total and s.get("tiles_skipped_mean") is not None:
        out.write(f"  tiles_skipped {s['tiles_skipped_mean']}/{rt.tiles_total}")
    out.write("\n")
    out.write(f"  alive    {_sparkline(rt.alive)}\n")
    out.write(f"  frontier {_sparkline(rt.frontier)}\n")
    out.write(f"  {'r':>4} {'alive':>8} {'frontier':>8} {'selected':>8} {'skipped':>8}\n")
    for r in range(rt.rounds):
        out.write(
            f"  {r:>4} {rt.alive[r]:>8} {rt.frontier[r]:>8}"
            f" {rt.selected[r]:>8} {rt.tiles_skipped[r]:>8}\n"
        )


def _fmt_histogram(val: Dict) -> str:
    """One line for a histogram snapshot: its count and quantiles."""
    if not val.get("count"):
        return "n=0"
    parts = [f"n={val['count']}"]
    for k in ("mean", "p50", "p95", "p99", "max"):
        if val.get(k) is not None:
            parts.append(f"{k}={val[k]}")
    return " ".join(parts)


def render_metrics(d: Dict, out) -> None:
    metrics = d.get("metrics", {})
    out.write(f"metrics ({len(metrics)} instruments)\n")
    for name, val in sorted(metrics.items()):
        if isinstance(val, dict):
            # the quantiles, not the bucket vector (promtext carries that)
            val = _fmt_histogram(val)
        out.write(f"  {name:<44} {val}\n")


def render_bench(d: Dict, out) -> None:
    """One bench-history record, one timing line."""
    out.write(
        f"bench {d.get('key', '?')} [{d.get('metric', '?')}]"
        f" {d.get('value_us', 0.0)}us"
        f"  @{d.get('git_sha', '?')} {d.get('timestamp', '?')}\n"
    )


def _classify(d: Dict) -> str:
    kind = d.get("kind")
    if kind in ("trace", "rounds", "metrics"):
        return kind
    if kind is None and "metric" in d and "value_us" in d:
        return "bench"
    return "unknown"


_RENDERERS = {
    "trace": render_trace,
    "rounds": render_rounds,
    "metrics": render_metrics,
    "bench": render_bench,
}


def _load(path: str, out) -> List[Dict]:
    records = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError as e:
                out.write(f"! line {lineno}: bad JSON ({e})\n")
                continue
            if not isinstance(d, dict):
                out.write(f"! line {lineno}: not an object\n")
                continue
            records.append(d)
    return records


def report(path: str, out=None) -> int:
    """Render every record in `path`; return the count rendered."""
    out = out or sys.stdout
    rendered = 0
    for d in _load(path, out):
        fn = _RENDERERS.get(_classify(d))
        if fn is None:
            out.write(f"! unknown kind {d.get('kind')!r}\n")
            continue
        fn(d, out)
        rendered += 1
    return rendered


class _NullOut:
    def write(self, _s: str) -> None:
        pass


def report_json(path: str) -> Dict:
    """Machine-readable digest: per-kind counts and the parsed records,
    each rounds record with its `RoundTrace.summary()`."""
    counts: Dict[str, int] = {}
    records = []
    for d in _load(path, _NullOut()):
        kind = _classify(d)
        if kind == "unknown":
            continue
        counts[kind] = counts.get(kind, 0) + 1
        if kind == "rounds":
            try:
                d = dict(d, summary=RoundTrace.from_dict(d).summary())
            except (KeyError, ValueError, TypeError):
                pass
        records.append(d)
    return dict(path=path, n_records=len(records), counts=counts, records=records)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "bench-diff":
        # the regression gate has its own argparse (thresholds, --json):
        # hand the remaining argv straight over so its --help stays whole
        from repro_torch.obs import bench

        return bench.main(argv[1:])

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="render repro_torch.obs JSONL telemetry (trace tree, "
                    "per-round series, metrics/health tables, bench "
                    "history); `bench-diff` compares two history files",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("report", help="render a JSONL telemetry file")
    rp.add_argument("path", help="JSONL file written by the service / solver")
    rp.add_argument("--json", action="store_true",
                    help="emit a machine-readable JSON digest instead")
    sub.add_parser("bench-diff",
                   help="compare two bench-history files (see bench-diff "
                        "--help); exit 1 on regression")
    args = p.parse_args(argv)
    if args.cmd != "report":
        return 2

    if args.json:
        doc = report_json(args.path)
        print(json.dumps(doc, indent=2))
        return 0 if doc["n_records"] else 2
    n = report(args.path)
    if n == 0:
        print(f"# no renderable records in {args.path}", file=sys.stderr)
        return 2
    print(f"# rendered {n} records")
    return 0


if __name__ == "__main__":
    sys.exit(main())
