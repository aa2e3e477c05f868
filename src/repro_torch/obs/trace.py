"""Span tracing: nested wall-clock phases for one request, JSONL export
(counterpart of `repro.obs.trace`, the same records).

A `Trace` is a per-request recorder; `trace_span(trace, "solver.plan")` is
the one instrumentation primitive, a context manager that times its body
and appends a `Span` with the current nesting depth.  ``trace=None`` (the
default everywhere) makes it a no-op with no timer reads, so an untraced
solve pays one `is None` check per seam.

Spans of the port (names dotted, layer first):

    service.step            one `MISService.step` window
      service.batch         the window's `solve_many` call
      service.validate      one response's validity check
    solver.solve            one front-door call
      solver.plan           plan-cache lookup / tiling build
      solver.pack           block-diagonal batch packing
      solver.execute        the convergence loop, up to its last host read
    solver.update           the dynamic route's re-solve (meta: mode)
    solver.profile          one `Solver.profile` call (the phase-timed twin)
      solver.plan
      rounds.phase1         per round: candidates, with the neighbour maxes
      rounds.phase2         the SpMV (fused engines: the ②+③ pass)
      rounds.phase3         the own-state update (fused: the state merge)

The port compiles no program, so it has no `solver.compile` span.

`Trace(profiler=True)` also opens each span as a
`torch.profiler.record_function` range, so spans land, by name, among the
events of any surrounding `torch.profiler` capture (where the reference
opens a `jax.profiler.TraceAnnotation`).
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Span:
    name: str
    start_ms: float          # offset from trace start
    dur_ms: float
    depth: int
    meta: Dict[str, object] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, object]:
        d = dict(
            name=self.name,
            start_ms=round(self.start_ms, 3),
            dur_ms=round(self.dur_ms, 3),
            depth=self.depth,
        )
        if self.meta:
            d["meta"] = self.meta
        return d


class Trace:
    """Per-request span recorder.  Not thread-safe by design: one Trace
    belongs to one request."""

    def __init__(self, request_id: str = "", *, profiler: bool = False):
        self.request_id = request_id
        self.spans: List[Span] = []
        self._t0 = time.perf_counter()
        self._depth = 0
        self._range = None
        if profiler:
            from torch.profiler import record_function

            self._range = record_function

    # -- recording --------------------------------------------------------

    @contextmanager
    def span(self, name: str, **meta):
        start = time.perf_counter()
        self._depth += 1
        rng = self._range(name) if self._range is not None else None
        if rng is not None:
            rng.__enter__()
        try:
            yield self
        finally:
            if rng is not None:
                rng.__exit__(None, None, None)
            self._depth -= 1
            end = time.perf_counter()
            self.spans.append(Span(
                name=name,
                start_ms=(start - self._t0) * 1e3,
                dur_ms=(end - start) * 1e3,
                depth=self._depth,
                meta={k: v for k, v in meta.items() if v is not None},
            ))

    def note(self, name: str, dur_ms: float, **meta) -> None:
        """Record a duration measured elsewhere (a queue wait, say) as a
        span ending now."""
        self.spans.append(Span(
            name=name,
            start_ms=(time.perf_counter() - self._t0) * 1e3 - dur_ms,
            dur_ms=float(dur_ms),
            depth=self._depth,
            meta={k: v for k, v in meta.items() if v is not None},
        ))

    # -- query ------------------------------------------------------------

    def total_ms(self, name: str) -> float:
        return sum(s.dur_ms for s in self.spans if s.name == name)

    # -- export -----------------------------------------------------------

    def to_dict(self) -> Dict[str, object]:
        # spans are appended at exit, children before parents; emit them in
        # start order so a reader's tree reads top-down
        ordered = sorted(self.spans, key=lambda s: s.start_ms)
        return dict(
            request_id=self.request_id,
            spans=[s.to_dict() for s in ordered],
        )

    def to_jsonl_line(self) -> str:
        return json.dumps({"kind": "trace", **self.to_dict()}, sort_keys=True)


@contextmanager
def trace_span(trace: Optional[Trace], name: str, **meta):
    """`with trace_span(trace, "solver.plan"): ...`, a no-op when trace is
    None.  The one seam primitive every layer uses."""
    if trace is None:
        yield None
        return
    with trace.span(name, **meta):
        yield trace


class JsonlWriter:
    """Append-only JSONL sink for trace, rounds and metrics records.

    Opens lazily on first write, so a writer that is never used leaves no
    empty file behind."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None

    def write_line(self, line: str) -> None:
        if self._fh is None:
            self._fh = open(self.path, "a")
        self._fh.write(line + "\n")
        self._fh.flush()

    def write_trace(self, trace: Trace) -> None:
        self.write_line(trace.to_jsonl_line())

    def write_rounds(self, rt) -> None:
        self.write_line(rt.to_jsonl_line())

    def write_metrics(self, snapshot: Dict[str, object]) -> None:
        self.write_line(json.dumps({"kind": "metrics", "metrics": snapshot}, sort_keys=True))

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
