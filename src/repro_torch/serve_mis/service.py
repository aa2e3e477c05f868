"""The MIS serving loop: requests in, validated per-graph solutions out
(counterpart of `repro.serve_mis.service`, the same responses and stats).

    submit ─ ingest (io) ─ plan (plan cache) ──────┐
    submit ─ ingest ─ plan ────────────────────────┤ queue
    submit_update ─ (targets a served result) ─────┤
                                                   │
        step(): pop ≤ max_batch ─ Solver.solve_many (block-diagonal
        batches, one convergence loop per (T, storage) group); each update
        patches its cached plan tile by tile and repairs (Solver.update)
        ─ fused validity check per member ─ Response

Every response carries per-request stats: queue time, the plan-cache
layer (mem / disk / built), the bucket signature, the batch's solve time,
the member's OWN convergence round, |MIS|, and the verdict of
`core.validate.is_valid_mis_checks` (both invariants in one pass on the
device, one host transfer).

`MISService(config, device="cuda")` runs on the CUDA device and raises
where there is none; `device="cpu"` must be asked for.  The service owns
the queue and the per-request bookkeeping, the `Solver` owns planning,
routing and execution.  The port compiles no per-shape program, so
`stats["compile"]` reads "n/a" and `stats["compiles"]` stays 0.  The
reference's introspection aliases `_base_key` and `_solve` name a
`jax.random` key and a jitted dispatch; they have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Union

import numpy as np

from repro_torch.api import Solver, SolveOptions
from repro_torch.core.validate import is_valid_mis_checks
from repro_torch.device import DeviceLike
from repro_torch.dyngraph.delta import EdgeDelta
from repro_torch.graphs.graph import Graph
from repro_torch.obs.metrics import REGISTRY, MetricsRegistry
from repro_torch.obs.trace import JsonlWriter, Trace, trace_span
from repro_torch.serve_mis.io import load_graph
from repro_torch.serve_mis.planner import TilePlan


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of the serving layer (the solve knobs mirror `SolveOptions`)."""
    tile_size: int = 32
    heuristic: str = "h3"
    engine: str = "fused_pallas"   # any registered round engine
    phase1: str = "segment"
    lanes: int = 8
    skip_dma: bool = False
    max_rounds: int = 1024
    max_batch: int = 8             # requests per worker step
    reorder: Optional[str] = None  # None | 'rcm'
    storage: str = "auto"          # tile storage: auto | int8 | bitpack
    cache_dir: Optional[str] = None
    plan_cache_entries: int = 256  # memory-layer LRU bound (disk is unbounded)
    validate: bool = True
    seed: int = 0
    repair: str = "auto"           # delta-update policy (SolveOptions.repair)
    # completed results kept as `submit_update` targets.  Each pins its
    # plan, tiles included, so the bound matches plan_cache_entries: the
    # retention must not out-pin the plan cache's own memory bound.
    result_entries: int = 256
    # observability: `telemetry` records the per-round device buffer
    # (responses carry a per-round summary); `trace_path` appends span
    # traces and round series as JSONL there, one Trace per worker step
    telemetry: bool = False
    trace_path: Optional[str] = None

    def solve_options(self) -> SolveOptions:
        """The Solver half of this config."""
        return SolveOptions(
            heuristic=self.heuristic,
            engine=self.engine,
            phase1=self.phase1,
            lanes=self.lanes,
            skip_dma=self.skip_dma,
            max_rounds=self.max_rounds,
            tile_size=self.tile_size,
            reorder=self.reorder,
            storage=self.storage,
            placement="auto",
            seed=self.seed,
            cache_dir=self.cache_dir,
            plan_cache_entries=self.plan_cache_entries,
            repair=self.repair,
            telemetry=self.telemetry,
        )


@dataclasses.dataclass
class Request:
    id: int
    source: str
    plan: TilePlan
    plan_status: str      # mem | disk | built
    t_enqueue: float


@dataclasses.dataclass
class UpdateRequest:
    """A graph mutation: patch request `base_id`'s graph with `delta` and
    repair its solution.  `base_id` must name a COMPLETED request; chain
    mutations by targeting each update's own id once it has been served."""
    id: int
    base_id: int
    source: str
    delta: EdgeDelta
    t_enqueue: float


@dataclasses.dataclass
class Response:
    id: int
    source: str
    in_mis: np.ndarray    # (n_nodes,) bool, ORIGINAL vertex ids
    mis_size: int
    independent: bool
    maximal: bool
    converged: bool       # the batch's flag (one loop for the whole group)
    rounds: int           # this member's OWN convergence round
    stats: Dict[str, object]

    @property
    def valid(self) -> bool:
        """The member's verdict, deliberately NOT ANDed with `converged`.

        `converged` belongs to the batch, so one member cut off at
        max_rounds must not fail its batchmates.  The invariants are exact
        per member: a member cut off mid-solve still has alive vertices,
        each unselected with no selected neighbour, so `maximal` is False
        for it."""
        return self.independent and self.maximal

    def summary(self) -> Dict[str, object]:
        """JSON-friendly per-request record (the solution vector left out)."""
        return dict(
            id=self.id,
            source=self.source,
            n_nodes=int(self.in_mis.shape[0]),
            mis_size=self.mis_size,
            valid=self.valid,
            rounds=self.rounds,
            **self.stats,
        )


class MISService:
    """Request-queue MIS worker over the `Solver` front door."""

    def __init__(self, config: ServeConfig = ServeConfig(), *, device: DeviceLike = "cuda"):
        self.config = config
        self.solver = Solver(config.solve_options(), device=device)  # raises on a bad engine
        self.planner = self.solver.plans
        self._queue: Deque[Union[Request, UpdateRequest]] = deque()
        self._next_id = 0
        self._steps = 0
        # completed results by request id, the targets `submit_update` may
        # name (a bounded FIFO: a long stream retires old targets)
        self._results: "OrderedDict[int, object]" = OrderedDict()
        self.metrics = MetricsRegistry("service")
        self.metrics.counter("service.requests")
        self._trace_writer = JsonlWriter(config.trace_path) if config.trace_path else None

    @property
    def stats(self) -> Dict[str, int]:
        return {
            "requests": self.metrics.counter("service.requests").value,
            "batches": self.solver.stats["batches"],
            "compiles": self.solver.stats["compiles"],
        }

    def metrics_snapshot(self) -> Dict[str, object]:
        """One dict over every registry the service can see: its own
        instruments, the Solver's, the plan cache's and the process-wide
        registry (batcher priority cache, repair decisions, drift).  Names
        carry their layer's prefix (`service.*`, `solver.*`,
        `plan_cache.*`, `batcher.*`, `repair.*`, `dyngraph.*`, `perf.*`),
        so the flat merge cannot collide."""
        out: Dict[str, object] = {}
        for reg in (REGISTRY, self.solver.metrics, self.planner.metrics, self.metrics):
            out.update(reg.snapshot())
        return out

    # -- intake ------------------------------------------------------------

    def submit(
        self,
        source: Union[str, Graph],
        *,
        fmt: Optional[str] = None,
        n_nodes: Optional[int] = None,
        stream: bool = False,
    ) -> int:
        """Ingest, plan (through the cache) and enqueue; returns the
        request id.  `stream=True` reads a file through the chunked readers
        (`dyngraph.stream.load_graph_stream`): the same graph and the same
        plan-cache hits, without the file's line list in memory."""
        device = self.solver.device
        if isinstance(source, Graph):
            graph, name = source, f"<graph:{source.n_nodes}v>"
        elif stream:
            from repro_torch.dyngraph.stream import load_graph_stream

            name = str(source)
            graph = load_graph_stream(name, fmt=fmt, n_nodes=n_nodes, device=device)
        else:
            name = str(source)
            graph = load_graph(name, fmt=fmt, n_nodes=n_nodes, device=device)
        plan, status = self.planner.plan(graph)
        return self._enqueue(Request(id=self._next_id, source=name, plan=plan,
                                     plan_status=status, t_enqueue=time.perf_counter()))

    def submit_update(self, base_id: int, delta: EdgeDelta) -> int:
        """Enqueue a mutation of a COMPLETED request's graph: its cached
        plan is patched tile by tile and its solution repaired per
        `config.repair`, never re-ingested.  Chain mutations by targeting
        the previous update's own id once it has been served; an unknown
        or not yet completed `base_id` raises KeyError."""
        if base_id not in self._results:
            raise KeyError(
                f"update targets request {base_id}, which has not completed "
                f"(updates chain off served results; drain first)"
            )
        # the cheap structural check fails fast; set strictness (absent
        # removes, present adds) surfaces at step time as an error response
        delta.check_bounds(self._results[base_id].plan.n_nodes)
        return self._enqueue(UpdateRequest(
            id=self._next_id, base_id=base_id,
            source=f"<update:{base_id}+{delta.n_add}-{delta.n_remove}>",
            delta=delta, t_enqueue=time.perf_counter()))

    def _enqueue(self, req: Union[Request, UpdateRequest]) -> int:
        self._next_id += 1
        self.metrics.counter("service.requests").inc()
        self._queue.append(req)
        return req.id

    @property
    def pending(self) -> int:
        return len(self._queue)

    # -- the worker step ----------------------------------------------------

    def step(self) -> List[Response]:
        """Pop ≤ max_batch requests, solve them through the Solver, respond.

        The window's solve requests share one `solve_many` call; each
        update repairs on its own (one warm-started loop on its patched
        plan).  A failing update (a delta that breaks set strictness
        against its graph, or a base result that aged out of retention)
        gives an INVALID error response and never kills the stream or its
        window-mates.  Responses come in pop order."""
        if not self._queue:
            return []
        reqs = [self._queue.popleft()
                for _ in range(min(self.config.max_batch, len(self._queue)))]
        # one Trace per worker step, only with a sink configured: tr=None
        # keeps the Solver on its untraced path
        tr = Trace(f"step-{self._steps}") if self._trace_writer is not None else None
        self._steps += 1
        self.metrics.counter("service.steps").inc()
        self.metrics.histogram("service.window").observe(len(reqs))
        # health gauges, sampled once per step: what waits behind this
        # window, and what is in flight now
        self.metrics.gauge("service.queue_depth").set(len(self._queue))
        self.metrics.gauge("service.inflight").set(len(reqs))
        t_pop = time.perf_counter()
        solves = [r for r in reqs if isinstance(r, Request)]
        with trace_span(tr, "service.step", size=len(reqs)):
            with trace_span(tr, "service.batch", size=len(solves)):
                results = dict(zip((r.id for r in solves),
                                   self.solver.solve_many([r.plan for r in solves], trace=tr)))
            for r in reqs:
                if isinstance(r, UpdateRequest):
                    try:
                        results[r.id] = self._run_update(r, tr)
                    except (ValueError, KeyError) as e:
                        results[r.id] = e

        responses = [self._respond(req, results[req.id], t_pop, len(reqs), tr)
                     for req in reqs]
        self.metrics.gauge("service.inflight").set(0)
        if tr is not None:
            # per-stage latency over the span taxonomy (traced steps only)
            for s in tr.spans:
                self.metrics.histogram(f"service.span_ms.{s.name}").observe(round(s.dur_ms, 3))
            self._trace_writer.write_trace(tr)
            # one rounds record per distinct RoundTrace: batched members
            # share their batch's series, so dedupe by identity
            seen = set()
            for req in reqs:
                rt = getattr(results[req.id], "telemetry", None)
                if rt is not None and id(rt) not in seen:
                    seen.add(id(rt))
                    self._trace_writer.write_rounds(rt)
        return responses

    def _respond(self, req, res, t_pop: float, window: int, tr: Optional[Trace]) -> Response:
        queue_ms = round((t_pop - req.t_enqueue) * 1e3, 3)
        self.metrics.histogram("service.queue_ms").observe(queue_ms)
        if isinstance(res, Exception):
            self.metrics.counter("service.errors").inc()
            return Response(
                id=req.id, source=req.source, in_mis=np.zeros(0, dtype=bool), mis_size=0,
                independent=False, maximal=False, converged=False, rounds=0,
                stats=dict(queue_ms=queue_ms, error=f"{type(res).__name__}: {res}",
                           batch_size=window),
            )
        independent = maximal = True
        if self.config.validate:
            with trace_span(tr, "service.validate", id=req.id):
                independent, maximal = is_valid_mis_checks(res.plan.g, res.in_mis_plan)
        in_mis = np.asarray(res.in_mis).astype(bool)
        is_update = isinstance(req, UpdateRequest)
        stats = dict(
            queue_ms=queue_ms,
            solve_ms=res.stats.get("solve_ms", 0.0),
            plan_cache=res.stats["patch"] if is_update else req.plan_status,
            bucket=res.stats.get("bucket", res.placement),
            compile=res.stats.get("compile", "n/a"),
            batch_size=window,
        )
        # a traced dispatch books its execute span (and a batch its wall)
        for k in ("batch_ms", "compile_ms", "execute_ms"):
            if k in res.stats:
                stats[k] = res.stats[k]
        if is_update:
            stats.update(repair=res.stats["repair"], plan_epoch=res.stats["plan_epoch"],
                         base_id=req.base_id)
        if res.telemetry is not None:
            stats["rounds_summary"] = res.telemetry.summary()
        # per-op latency, enqueue to response: p50/p95/p99 per route
        op = "update" if is_update else "batched" if res.placement == "batched" else "solve"
        self.metrics.histogram(f"service.latency_ms.{op}").observe(
            round((time.perf_counter() - req.t_enqueue) * 1e3, 3))
        self._results[req.id] = res
        while len(self._results) > max(self.config.result_entries, 1):
            self._results.popitem(last=False)
        return Response(
            id=req.id, source=req.source, in_mis=in_mis, mis_size=int(in_mis.sum()),
            independent=independent, maximal=maximal, converged=res.converged,
            rounds=res.rounds, stats=stats,
        )

    def _run_update(self, r: UpdateRequest, trace: Optional[Trace] = None):
        """One update's repair, drawing under the CONTENT-DERIVED key of
        the patched graph: the one a fresh submission of that graph would
        be solved under (`Solver.request_key`), and for an empty delta
        exactly the base response's.  That keeps update responses
        consistent with the service's own solves in every repair mode (a
        bare `Solver.update` draws under the seed's key instead)."""
        if r.base_id not in self._results:
            raise KeyError(
                f"update {r.id} targets request {r.base_id}, whose result aged out "
                f"of retention (result_entries={self.config.result_entries})"
            )
        prior = self._results[r.base_id]
        # this patch is the real cache probe; Solver.update's own
        # apply_delta then hits memory by construction, so its `patch`
        # stat would always read 'mem': overwrite it with the real layer
        plan2, patch_status = self.solver.plans.apply_delta(prior.plan, r.delta)
        res = self.solver.update(prior, r.delta,
                                 key=self.solver.request_key(plan2), trace=trace)
        res.stats["patch"] = patch_status
        return res

    def drain(self) -> List[Response]:
        """Run worker steps until the queue is empty."""
        out: List[Response] = []
        while self._queue:
            out.extend(self.step())
        return out
