"""repro_torch.obs — observability of a solve (counterpart of `repro.obs`).

Legs, importable independently:

* `rounds`   — the round-telemetry buffer layout and the host `RoundTrace`
               (numpy only; `core.engine` imports its column constants)
* `trace`    — `Trace` / `trace_span` span tracing and JSONL export
* `metrics`  — counters, gauges and histograms in named registries
               (`Solver.metrics`, `PlanCache.metrics`, the process-wide
               `REGISTRY`)
* `bench`    — stamped bench snapshots (the card's name and power limit
               in the stamp), the append-only `BENCH_history/` store, and
               the `bench-diff` regression gate
* `promtext` — Prometheus text exposition over a metrics snapshot
* `report`   — the JSONL renderer behind
               `python -m repro_torch.obs report trace.jsonl [--json]`

`python -m repro_torch.obs bench-diff <base> <head>` gates perf regressions.
"""
from repro_torch.obs.rounds import (
    COL_ALIVE,
    COL_FRONTIER,
    COL_SELECTED,
    COL_TILES_DENSE,
    COL_TILES_SKIPPED,
    COL_TILES_SPARSE,
    COLUMN_NAMES,
    TELEMETRY_COLS,
    TELEMETRY_FILL,
    RoundTrace,
)
from repro_torch.obs.bench import (
    append_history,
    bench_env,
    diff,
    load_records,
    stamp,
    write_bench,
)
from repro_torch.obs.metrics import REGISTRY, Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.promtext import metric_name, to_promtext, write_promtext
from repro_torch.obs.trace import JsonlWriter, Span, Trace, trace_span

__all__ = [
    "COL_ALIVE",
    "COL_FRONTIER",
    "COL_SELECTED",
    "COL_TILES_DENSE",
    "COL_TILES_SKIPPED",
    "COL_TILES_SPARSE",
    "COLUMN_NAMES",
    "TELEMETRY_COLS",
    "TELEMETRY_FILL",
    "RoundTrace",
    "append_history",
    "bench_env",
    "diff",
    "load_records",
    "stamp",
    "write_bench",
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "metric_name",
    "to_promtext",
    "write_promtext",
    "JsonlWriter",
    "Span",
    "Trace",
    "trace_span",
]
