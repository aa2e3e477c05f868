"""The metrics registry: counters, gauges and histograms (counterpart of
`repro.obs.metrics`, the same instruments, buckets, quantile rule and
snapshot layout, so a snapshot of either package reads the same).

One `MetricsRegistry` is a flat namespace of named instruments.  Layers
own one each (`Solver.metrics`, `PlanCache.metrics`), so two solvers in
one process never share numbers; module-level code with no instance to
hang state on (the batcher's priority cache, the repair-mode decision,
the drift gauges of a patch) records into the process-wide `REGISTRY`.
`Solver.stats` and `PlanCache.stats` are read-only views over these
instruments, in the reference's spelling.

Instruments are host Python state: they record at the eager seams (after
a solve's host copy, at a plan-cache decision), never per kernel launch.
Snapshots are plain JSON-able dicts: counters and gauges flatten to
numbers, histograms to {count, total, min, max, mean, p50, p95, p99,
buckets} records.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, Optional, Sequence, Tuple


class Counter:
    """Monotonic event count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Last-set value (queue depth, cache size, ...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self):
        return self.value


# Fixed bucket upper edges (in the unit observed — latencies record ms).
# Log-spaced from 100 µs to 10 s plus the implicit +Inf overflow bucket:
# wide enough that one scheme serves latencies, batch sizes and fractions
# without per-instrument tuning, fine enough that p50/p95/p99 estimates land
# within one log-2.5 step of the truth.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)

# the quantiles every histogram snapshot carries (SLO spellings)
QUANTILES: Tuple[float, ...] = (0.5, 0.95, 0.99)


class Histogram:
    """Fixed-bucket summary of an observed quantity (latencies, batch sizes).

    Keeps count/total/min/max plus a cumulative-style fixed bucket vector
    (`bucket_counts[i]` = observations with value <= `buckets[i]`; the last
    slot is the +Inf overflow).  O(len(buckets)) state, O(log buckets) per
    observe — cheap enough for the eager seams, rich enough for p50/p95/p99
    SLO quantiles and a Prometheus histogram exposition.

    `quantile(q)` returns the UPPER EDGE of the bucket holding the q-th
    ranked observation, clamped to the observed max — an upper bound on the
    true quantile (never an under-estimate, the conservative direction for
    SLO gating) and monotone in q.  Overflow-bucket quantiles report the
    observed max (the tightest bound available)."""

    __slots__ = ("name", "buckets", "bucket_counts", "count", "total",
                 "min", "max")

    def __init__(self, name: str, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.buckets = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"histogram {name!r}: buckets must be "
                             f"strictly increasing, got {buckets}")
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        # first edge >= v, i.e. the smallest bucket with v <= le (Prometheus
        # `le` semantics); past the last edge lands in the overflow slot
        self.bucket_counts[bisect.bisect_left(self.buckets, v)] += 1

    def quantile(self, q: float) -> Optional[float]:
        """Upper-bound estimate of the q-quantile (None when empty)."""
        if not self.count:
            return None
        q = min(max(float(q), 0.0), 1.0)
        # rank of the target observation, 1-based: ceil(q * count), >= 1
        target = max(int(-(-q * self.count // 1)), 1)
        cum = 0
        for i, c in enumerate(self.bucket_counts):
            cum += c
            if cum >= target:
                if i < len(self.buckets):
                    return min(self.buckets[i], self.max)
                return self.max            # overflow: observed max is the bound
        return self.max

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram (e.g. the same instrument from a replica's
        registry) into this one.  Bucket schemes must match — merging
        differently-bucketed histograms would silently mis-bin."""
        if other.buckets != self.buckets:
            raise ValueError(
                f"histogram {self.name!r}: cannot merge bucket scheme "
                f"{other.buckets} into {self.buckets}"
            )
        for i, c in enumerate(other.bucket_counts):
            self.bucket_counts[i] += c
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def snapshot(self):
        if not self.count:
            return dict(count=0, total=0.0, min=None, max=None, mean=None,
                        p50=None, p95=None, p99=None)
        qs = {f"p{int(q * 100)}": round(self.quantile(q), 3)
              for q in QUANTILES}
        cum, cum_counts = 0, []
        for c in self.bucket_counts:
            cum += c
            cum_counts.append(cum)
        return dict(
            count=self.count,
            total=round(self.total, 3),
            min=round(self.min, 3),
            max=round(self.max, 3),
            mean=round(self.total / self.count, 3),
            **qs,
            # cumulative per-le counts, +Inf last (a Prometheus exposition's)
            buckets=[
                [le, n] for le, n in
                zip(list(self.buckets) + ["+Inf"], cum_counts)
            ],
        )


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """A named, typed instrument namespace.

    `counter`/`gauge`/`histogram` are get-or-create: the first call for a
    name fixes its kind, and re-asking with a different kind is a caller
    bug, raised loudly.  Thread-safe at the registry level (instrument
    mutation itself is a GIL-atomic int/float update).
    """

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}
        self._kinds: Dict[str, str] = {}

    def _get(self, kind: str, name: str):
        with self._lock:
            have = self._kinds.get(name)
            if have is None:
                self._kinds[name] = kind
                self._instruments[name] = _KINDS[kind](name)
            elif have != kind:
                raise TypeError(
                    f"metric {name!r} is a {have}, requested as {kind}"
                )
            return self._instruments[name]

    def counter(self, name: str) -> Counter:
        return self._get("counter", name)

    def gauge(self, name: str) -> Gauge:
        return self._get("gauge", name)

    def histogram(self, name: str) -> Histogram:
        return self._get("histogram", name)

    def snapshot(self) -> Dict[str, object]:
        """JSON-able {name: value-or-summary} of every instrument."""
        with self._lock:
            return {k: v.snapshot() for k, v in sorted(self._instruments.items())}

    def merge(self, other: "MetricsRegistry") -> None:
        """Fold another registry's instruments into this one, by name:
        counters add, gauges take the other's last value, histograms merge
        bucket-wise.  The cross-replica aggregation seam — a fleet
        coordinator merges per-replica registries into one before
        snapshotting/exposing.  Same-name instruments must agree on kind
        (the usual get-or-create TypeError otherwise)."""
        with other._lock:
            pairs = [(k, other._kinds[k], v)
                     for k, v in other._instruments.items()]
        for name, kind, inst in pairs:
            mine = self._get(kind, name)
            if kind == "counter":
                mine.inc(inst.value)
            elif kind == "gauge":
                mine.set(inst.value)
            else:
                mine.merge(inst)


# The process-wide registry: the home of metrics recorded by module-level
# code (batcher priority cache, repair-mode decisions) that has no layer
# instance to own them.  Layer instances (Solver, PlanCache) own their own
# registries.
REGISTRY = MetricsRegistry("process")


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)
