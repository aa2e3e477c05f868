"""repro_torch.obs — observability of a solve (counterpart of `repro.obs`).

Two legs, importable independently:

* `rounds` — the round-telemetry buffer layout and the host `RoundTrace`
             (numpy only; `core.engine` imports its column constants)
* `trace`  — `Trace` / `trace_span` span tracing and JSONL export

The reference's `metrics`, `promtext`, `report` and `bench` legs are not
ported yet (ROADMAP.md, Queue 1 item 15).
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
    "JsonlWriter",
    "Span",
    "Trace",
    "trace_span",
]
