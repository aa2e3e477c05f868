"""Prometheus text exposition over a metrics snapshot (counterpart of
`repro.obs.promtext`, the same text byte for byte).

`to_promtext(snapshot)` renders the flat dict `MISService.metrics_snapshot()`
(or any `MetricsRegistry.snapshot()`) returns in the Prometheus text format,
version 0.0.4, which node_exporter's textfile collector and every
Prometheus-compatible scraper read.  `write_promtext` is the export the
serving CLI's ``--metrics-path`` flag drives: one ``.prom`` file per
process, replaced atomically; no HTTP listener in the solver process.

Naming rules (stable: dashboards key on them):

* every metric is prefixed ``repro_``; registry dots become underscores
  (``service.queue_ms`` → ``repro_service_queue_ms``), and so does any
  other character outside ``[a-zA-Z0-9_]``;
* counters (int snapshots) get the ``_total`` suffix;
* gauges (float snapshots) export as they are;
* histograms (dict snapshots with ``buckets``) export cumulative
  ``_bucket{le="..."}`` series ending at ``le="+Inf"``, ``_sum`` and
  ``_count``, plus ``{quantile="0.5|0.95|0.99"}`` lines from the
  snapshot's p50/p95/p99 upper-bound estimates.

The kind comes from the snapshot value's type (int / float / dict), which
maps one to one onto the three instruments `obs.metrics` has.
"""
from __future__ import annotations

import os
import re
from typing import Dict

PREFIX = "repro_"

_INVALID = re.compile(r"[^a-zA-Z0-9_]")


def metric_name(name: str, prefix: str = PREFIX) -> str:
    """Sanitised exposition name: prefix + dots/invalid chars → ``_``."""
    out = prefix + _INVALID.sub("_", name)
    if out[0].isdigit():
        out = "_" + out
    return out


def _fmt(v) -> str:
    """Prometheus number formatting (ints bare, floats via repr)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def _histogram_lines(name: str, snap: Dict) -> list:
    lines = [f"# TYPE {name} histogram"]
    for le, cum in snap.get("buckets", []):
        le_s = le if isinstance(le, str) else _fmt(float(le))
        lines.append(f'{name}_bucket{{le="{le_s}"}} {cum}')
    if not snap.get("buckets"):
        # an empty histogram still exposes its +Inf bucket, so the series exists
        lines.append(f'{name}_bucket{{le="+Inf"}} 0')
    lines.append(f"{name}_sum {_fmt(snap.get('total', 0.0))}")
    lines.append(f"{name}_count {snap.get('count', 0)}")
    for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
        if snap.get(key) is not None:
            lines.append(f'{name}{{quantile="{q}"}} {_fmt(snap[key])}')
    return lines


def to_promtext(snapshot: Dict[str, object], prefix: str = PREFIX) -> str:
    """Render a metrics snapshot as Prometheus exposition text.

    Names are sorted, so two exports of one state are byte-identical
    (textfile collectors compare mtime and content)."""
    lines = []
    for raw, val in sorted(snapshot.items()):
        name = metric_name(raw, prefix)
        if isinstance(val, dict):
            lines += _histogram_lines(name, val)
        elif isinstance(val, (bool, int)):
            lines.append(f"# TYPE {name}_total counter")
            lines.append(f"{name}_total {_fmt(val)}")
        elif isinstance(val, float):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_fmt(val)}")
        # the exposition format has no string samples: other values are skipped
    return "\n".join(lines) + "\n" if lines else ""


def write_promtext(snapshot: Dict[str, object], path: str, prefix: str = PREFIX) -> None:
    """Atomic textfile export: write a temporary sibling, then
    `os.replace` it into place, so a scraper never reads half a file."""
    text = to_promtext(snapshot, prefix)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
