"""Longitudinal bench observability: stamped snapshots, history, bench-diff
(counterpart of `repro.obs.bench`: the same schema, field names,
constants, thresholds, output and exit codes).

* `stamp(doc)` — attach ``{schema_version, git_sha, timestamp, backend,
  torch_version, cuda_version, device_name, power_limit}`` header fields
  to a bench document, at the eager edge.
* `write_bench(doc, out_path)` — the one emission seam a bench calls:
  stamps the doc, writes the snapshot JSON, and appends one record per
  (row, metric) to the append-only history store
  ``BENCH_history/<bench>.jsonl``.
* `diff(base, head)` / the ``bench-diff`` CLI — noise-aware comparison of
  two history files: median-of-k per identity key, a per-op relative bar
  plus an absolute floor, exit 0 / 1 / 2.

The port's stamp (`bench_env`) imports no JAX: in place of the
reference's ``jax_version`` it carries ``torch_version``,
``cuda_version`` (``torch.version.cuda``), and the card's ``device_name``
and ``power_limit`` as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them for the first card (``"none"`` without
one: a card's power limit sets its speed under load, so a time is kept
beside it); ``backend`` is ``"cuda"`` where a card is present, else
``"cpu"``.  History record schema (one JSON object per line):

    {"schema": 1, "bench": "core", "key": "bench=core backend=cuda ...",
     "metric": "us_per_round", "value_us": 123.4,
     "git_sha": "...", "timestamp": "...", "backend": "cuda",
     "torch_version": "...", "cuda_version": "...",
     "device_name": "...", "power_limit": "...", "quick": true}

The identity ``key`` is the bench name plus every *configuration* scalar of
the row (op, storage, n, tile_size, engine, ...), sorted ``k=v`` — and it
includes ``backend`` and ``quick`` so a CPU-quick run never silently
compares against a card's full run.  *Outcome* fields (rounds, mis_size,
gb_per_s, ...) are excluded.  Values are normalised to µs at write time
so one threshold vocabulary covers ``us_per_call`` and ``solve_ms`` rows
alike.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

SCHEMA_VERSION = 1

# default history root, relative to the CWD the bench runs from (the repo
# root, for `python -m benchmarks.run`); override with BENCH_HISTORY_DIR,
# empty string disables the history append (snapshot still written)
HISTORY_DIR_ENV = "BENCH_HISTORY_DIR"
DEFAULT_HISTORY_DIR = "BENCH_history"

# metric fields a bench row may carry, with the factor that converts each
# to µs.  One record is appended per metric present in a row.
METRIC_FIELDS: Tuple[Tuple[str, float], ...] = (
    ("us_per_call", 1.0),
    ("us_per_round", 1.0),
    ("solve_ms", 1e3),
    ("repair_ms", 1e3),
    ("cold_ms", 1e3),
    ("warm_s", 1e6),
    ("cold_s", 1e6),
)
_METRIC_NAMES = frozenset(m for m, _ in METRIC_FIELDS)

# row fields that are *outcomes* of a run, not configuration — excluded
# from the identity key (two runs of the same config legitimately differ
# on these, and keying on them would make every run its own key)
OUTCOME_FIELDS = frozenset({
    "rounds", "mis_size", "gb_per_s", "tile_payload_bytes", "touched",
    "n_add", "n_remove", "repair_rounds", "cold_rounds", "repair_mis",
    "cold_mis", "repair_valid", "rounds_summary", "speedup", "compiles",
    "plan_cache", "cold_graphs_per_s", "warm_graphs_per_s",
    "tiles_dense", "tiles_sparse", "ok",
})

# default thresholds: a key regresses when head-median exceeds
# base-median by BOTH the relative bar and the absolute floor.  0.6
# relative sits between CPU-timer noise (~1.3x observed across identical
# quick runs) and the 2x injected-slowdown the CI self-test must catch;
# the 200 µs floor keeps sub-100 µs micro-kernels from gating on jitter.
DEFAULT_REL_BAR = 0.6
DEFAULT_ABS_FLOOR_US = 200.0

_ENV_CACHE: Optional[Dict[str, object]] = None


def _git_sha() -> str:
    sha = os.environ.get("GIT_SHA", "")
    if sha:
        return sha
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            capture_output=True, text=True, timeout=5,
        )
        if out.returncode == 0:
            return out.stdout.strip()
    except Exception:  # noqa: BLE001 - no git / not a repo: stamp unknown
        pass
    return "unknown"


_ENV_FIELDS = ("torch_version", "cuda_version", "device_name", "power_limit")


def _card() -> Tuple[str, str]:
    """(name, power limit) of the first card as nvidia-smi reads them, or
    ("none", "none")."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10,
        )
    except Exception:  # noqa: BLE001 - no nvidia-smi: no card to stamp
        return "none", "none"
    lines = out.stdout.strip().splitlines() if out.returncode == 0 else []
    if not lines:
        return "none", "none"
    name, _, limit = lines[0].partition(",")
    return name.strip(), limit.strip() or "none"


def bench_env() -> Dict[str, object]:
    """The attribution header every snapshot and history record carries.

    Cached per process: one git subprocess, one nvidia-smi call — and all
    rows of one run share one timestamp, so a run is a point, not a smear.
    """
    global _ENV_CACHE
    if _ENV_CACHE is None:
        import torch

        name, limit = _card()
        _ENV_CACHE = dict(
            git_sha=_git_sha(),
            timestamp=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            backend="cuda" if torch.cuda.is_available() else "cpu",
            torch_version=torch.__version__,
            cuda_version=torch.version.cuda or "none",
            device_name=name,
            power_limit=limit,
        )
    return dict(_ENV_CACHE)


def stamp(doc: Dict[str, object]) -> Dict[str, object]:
    """Return a copy of `doc` with schema + env header fields attached.

    Existing keys win: a bench that already sets ``backend`` (core_bench
    does) keeps its own value — the stamp fills, never overwrites.
    """
    out = dict(schema_version=SCHEMA_VERSION, **bench_env())
    out.update(doc)
    return out


def _identity_key(bench: str, row: Dict[str, object],
                  header: Dict[str, object]) -> str:
    parts = {
        "bench": bench,
        "backend": header.get("backend", "none"),
        "quick": header.get("quick", ""),
    }
    for k, v in row.items():
        if k in _METRIC_NAMES or k in OUTCOME_FIELDS:
            continue
        if isinstance(v, (dict, list, tuple)):
            continue
        parts[k] = v
    return " ".join(f"{k}={parts[k]}" for k in sorted(parts))


def history_records(doc: Dict[str, object]) -> List[Dict[str, object]]:
    """Explode a stamped bench doc into per-(row, metric) history records."""
    bench = str(doc.get("bench", "unknown"))
    rows = doc.get("results", [])
    if not isinstance(rows, list):
        return []
    head = {k: doc.get(k) for k in
            ("git_sha", "timestamp", "backend") + _ENV_FIELDS + ("quick",)}
    records = []
    for row in rows:
        if not isinstance(row, dict):
            continue
        key = _identity_key(bench, row, head)
        for metric, to_us in METRIC_FIELDS:
            v = row.get(metric)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                records.append(dict(
                    schema=SCHEMA_VERSION, bench=bench, key=key,
                    metric=metric, value_us=round(float(v) * to_us, 3),
                    **head,
                ))
    return records


def history_path(bench: str, history_dir: str) -> str:
    return os.path.join(history_dir, f"{bench}.jsonl")


def append_history(doc: Dict[str, object],
                   history_dir: Optional[str] = None) -> int:
    """Append the doc's records to ``<history_dir>/<bench>.jsonl``.

    Returns the number of records appended; 0 when history is disabled
    (``BENCH_HISTORY_DIR=""``) or the doc has no metric rows.
    """
    if history_dir is None:
        history_dir = os.environ.get(HISTORY_DIR_ENV, DEFAULT_HISTORY_DIR)
    if not history_dir:
        return 0
    records = history_records(doc)
    if not records:
        return 0
    os.makedirs(history_dir, exist_ok=True)
    path = history_path(str(doc.get("bench", "unknown")), history_dir)
    with open(path, "a") as f:
        for r in records:
            f.write(json.dumps(r, sort_keys=True) + "\n")
    return len(records)


def write_bench(doc: Dict[str, object], out_path: str,
                history_dir: Optional[str] = None) -> Dict[str, object]:
    """The one bench emission seam: stamp, snapshot, history-append.

    Returns the stamped doc (callers that post-process — core_bench's
    overhead guard — read fields off it).
    """
    stamped = stamp(doc)
    with open(out_path, "w") as f:
        json.dump(stamped, f, indent=2)
    print(f"# wrote {out_path}")
    n = append_history(stamped, history_dir)
    if n:
        hd = history_dir or os.environ.get(HISTORY_DIR_ENV,
                                           DEFAULT_HISTORY_DIR)
        print(f"# appended {n} records to "
              f"{history_path(str(stamped.get('bench', 'unknown')), hd)}")
    return stamped


# ---------------------------------------------------------------------------
# bench-diff
# ---------------------------------------------------------------------------


def load_records(path: str) -> List[Dict[str, object]]:
    """Load history records from a ``.jsonl`` file or a directory of them.

    Unknown schema versions and malformed lines are skipped (a newer
    writer must not brick an older differ); missing paths raise.
    """
    paths: List[str] = []
    if os.path.isdir(path):
        paths = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith(".jsonl")
        )
    else:
        paths = [path]
    records = []
    for p in paths:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    r = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(r, dict):
                    continue
                if r.get("schema") != SCHEMA_VERSION:
                    continue
                if "key" in r and "metric" in r and "value_us" in r:
                    records.append(r)
    return records


def _median(vals: Sequence[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _group(records: Sequence[Dict[str, object]]) -> Dict[Tuple[str, str],
                                                         List[float]]:
    out: Dict[Tuple[str, str], List[float]] = {}
    for r in records:
        out.setdefault((str(r["key"]), str(r["metric"])), []).append(
            float(r["value_us"]))
    return out


def diff(base: Sequence[Dict[str, object]],
         head: Sequence[Dict[str, object]],
         rel_bar: float = DEFAULT_REL_BAR,
         abs_floor_us: float = DEFAULT_ABS_FLOOR_US) -> Dict[str, object]:
    """Compare two record sets key-by-key, median-of-k per side.

    A key REGRESSES when head-median exceeds base-median by more than
    ``rel_bar`` relatively AND ``abs_floor_us`` absolutely (both bars must
    trip — relative-only flags micro-kernel jitter, absolute-only misses
    slow large ops drifting a few percent).  Improvements use the same
    bars mirrored, reported but never failing.  ``status`` is one of
    ``"ok" | "regression" | "no-overlap"``.
    """
    gb, gh = _group(base), _group(head)
    common = sorted(set(gb) & set(gh))
    rows = []
    regressions, improvements = [], []
    for key, metric in common:
        b, h = _median(gb[(key, metric)]), _median(gh[(key, metric)])
        delta = h - b
        ratio = h / b if b > 0 else float("inf")
        verdict = "same"
        if delta > abs_floor_us and h > b * (1.0 + rel_bar):
            verdict = "regression"
        elif -delta > abs_floor_us and b > h * (1.0 + rel_bar):
            verdict = "improvement"
        row = dict(key=key, metric=metric,
                   base_us=round(b, 3), head_us=round(h, 3),
                   ratio=round(ratio, 3),
                   base_k=len(gb[(key, metric)]),
                   head_k=len(gh[(key, metric)]),
                   verdict=verdict)
        rows.append(row)
        if verdict == "regression":
            regressions.append(row)
        elif verdict == "improvement":
            improvements.append(row)
    status = ("no-overlap" if not common
              else "regression" if regressions else "ok")
    return dict(
        status=status,
        n_common=len(common),
        n_base_only=len(set(gb) - set(gh)),
        n_head_only=len(set(gh) - set(gb)),
        rel_bar=rel_bar,
        abs_floor_us=abs_floor_us,
        regressions=regressions,
        improvements=improvements,
        rows=rows,
    )


def render_diff(report: Dict[str, object]) -> str:
    """Human-readable bench-diff report (the non-``--json`` output)."""
    lines = [
        f"bench-diff: {report['n_common']} comparable keys "
        f"(+{report['n_head_only']} head-only, "
        f"-{report['n_base_only']} base-only), "
        f"bars: x{1.0 + float(report['rel_bar']):.2f} rel "
        f"and {float(report['abs_floor_us']):.0f}us abs",
    ]
    for kind, rows in (("REGRESSION", report["regressions"]),
                       ("improvement", report["improvements"])):
        for r in rows:
            lines.append(
                f"  {kind}: {r['key']} [{r['metric']}] "
                f"{r['base_us']:.1f}us -> {r['head_us']:.1f}us "
                f"(x{r['ratio']:.2f}, k={r['base_k']}/{r['head_k']})"
            )
    lines.append(f"verdict: {report['status']}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m repro_torch.obs bench-diff <base> <head>`` entry point.

    Exit 0 = ok (improvements included), 1 = regression, 2 = no
    overlapping keys (a mis-pointed baseline must fail LOUDLY in CI, not
    pass vacuously).
    """
    p = argparse.ArgumentParser(
        prog="repro_torch.obs bench-diff",
        description="Compare two bench-history JSONL files/dirs; "
                    "exit 1 on regression.",
    )
    p.add_argument("base", help="baseline history .jsonl file or directory")
    p.add_argument("head", help="candidate history .jsonl file or directory")
    p.add_argument("--rel-bar", type=float, default=DEFAULT_REL_BAR,
                   help="relative slowdown bar (0.6 = fail past 1.6x)")
    p.add_argument("--abs-floor-us", type=float,
                   default=DEFAULT_ABS_FLOOR_US,
                   help="absolute slowdown floor in microseconds")
    p.add_argument("--json", action="store_true",
                   help="emit the full report as JSON instead of text")
    args = p.parse_args(argv)

    try:
        base = load_records(args.base)
        head = load_records(args.head)
    except OSError as e:
        print(f"bench-diff: cannot read history: {e}", file=sys.stderr)
        return 2

    report = diff(base, head, rel_bar=args.rel_bar,
                  abs_floor_us=args.abs_floor_us)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(render_diff(report))
    if report["status"] == "no-overlap":
        return 2
    return 1 if report["status"] == "regression" else 0


if __name__ == "__main__":
    sys.exit(main())
