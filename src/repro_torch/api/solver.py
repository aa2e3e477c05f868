"""`Solver` — plan, route and solve graphs (counterpart of
`repro.api.solver`: the local, sharded, batched and dynamic routes).

    solve(graph)         placement per graph (`route`):
                           local    one convergence loop on the configured
                                    round engine
                           sharded  `core.distributed` over the default
                                    `torch.distributed` group, one block-row
                                    slab per rank (auto: big padded graphs
                                    on more than one rank)
    solve_many(graphs)   [] → []; one graph → `solve`; many → block-diagonal
                         batches (`serve_mis.batcher`), one convergence loop
                         per (tile size, storage) group, each member's MIS
                         and rounds those of its solo solve under its own
                         `request_key`; sharded-routed members peel
                         off to their own sharded solve
    profile(graph)       the phase-timed twin (`core.tc_mis.run_phases`),
                         local plans only
    update(prior, delta) dynamic graphs: patch the plan tile by tile
                         through the cache, then repair the solution per
                         `options.repair` (a warm-started round loop from
                         the prior MIS, or a cold solve of the patched plan;
                         always cold on a plan that routes sharded)

`Solver(options, device="cuda")` runs on the CUDA device and raises where
there is none; `device="cpu"` must be asked for.  A graph handed in is
moved to the solver's device.  `solve` draws priorities under
`core.prng.key(options.seed)`, the reference's `jax.random.key(seed)` bit
for bit; batched members draw under `request_key(plan)`, folded from it and
the graph's content, so a member's solution never depends on its batch,
slot or arrival order.  One seed gives the reference's MIS on every route,
on the CPU and on the card alike.
`metrics` is the solver's `MetricsRegistry`; `stats` its legacy view.

The sharded route runs on every rank of the default group together (each
rank calls the same solve); with no group initialised, a forced
`placement="sharded"` runs a one-rank group in this process, as the
reference runs a one-device mesh.  It is dense-only: the plan's hybrid
partition is set aside.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.api.options import SolveOptions
from repro_torch.api.plan import Plan, PlanCache, choose_tile_size, resolve_storage
from repro_torch.core.engine import get_engine, resolve_frontier
from repro_torch.core import prng
from repro_torch.core.heuristics import make_priorities
from repro_torch.core.prng import Key
from repro_torch.core.tc_mis import run_phases, run_tc_mis
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.graph import Graph
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.rounds import RoundTrace
from repro_torch.obs.trace import Trace, trace_span

GraphLike = Union[Graph, Plan]

_DIST_PROGRAM_CACHE = 16       # sharded slabs kept per Solver (LRU)


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """One graph's solution, in ORIGINAL vertex numbering.

    `rounds` is this graph's own convergence round; for a batched member
    the maximum of its vertices' settle rounds, not the batch's.
    `converged` is the batch's flag for batched members (an unconverged
    member still fails maximality on its own)."""
    in_mis: np.ndarray          # (n_nodes,) bool, original vertex ids
    rounds: int
    converged: bool
    placement: str              # local | batched | sharded
    plan: Plan
    stats: Dict[str, object] = dataclasses.field(default_factory=dict)
    # the per-round series when SolveOptions.telemetry is on (obs.rounds;
    # batched members share the batch's series, its meta says so)
    telemetry: Optional[RoundTrace] = None

    @property
    def mis_size(self) -> int:
        return int(np.asarray(self.in_mis).sum())

    @property
    def in_mis_plan(self) -> np.ndarray:
        """The solution in plan-id numbering (what validators over
        `plan.g` expect)."""
        return self.plan.to_plan_ids(self.in_mis)


class Solver:
    """Plan → route → execute, on one device or one rank's slab."""

    def __init__(
        self,
        options: SolveOptions = SolveOptions(),
        *,
        device: DeviceLike = "cuda",
        plans: Optional[PlanCache] = None,
    ):
        get_engine(options.engine)   # fail fast, before any graph is planned
        self.device = resolve_device(device)
        self.options = options
        self.plans = plans if plans is not None else PlanCache(
            tile_size=options.tile_size or 32,
            reorder=options.reorder,
            storage=options.storage,
            hybrid=options.hybrid,
            hybrid_threshold=options.hybrid_threshold,
            cache_dir=options.cache_dir,
            max_mem_entries=options.plan_cache_entries,
            device=self.device,
        )
        self._base_key = prng.key(options.seed)
        # batched members' priorities by plan content, for the default
        # request keys only (custom keys bypass it)
        self._priority_cache: Dict = {}
        # plan key -> this rank's sharded run (slab built), LRU
        self._dist_runs: "OrderedDict[str, object]" = OrderedDict()
        self.metrics = MetricsRegistry("solver")
        for k in ("solver.solves", "solver.batches", "solver.compiles"):
            self.metrics.counter(k)

    @property
    def stats(self) -> Dict[str, int]:
        """Read-only `{"solves", "batches", "compiles"}` view of the
        metrics, in the reference's spelling.  The port compiles no
        per-shape program (each kernel builds once per process, on first
        use); `compiles` counts the sharded route's slab builds, where the
        reference compiles its shard_map program."""
        m = self.metrics
        return {
            "solves": m.counter("solver.solves").value,
            "batches": m.counter("solver.batches").value,
            "compiles": m.counter("solver.compiles").value,
        }

    # -- planning ----------------------------------------------------------

    def plan(self, graph: GraphLike) -> Plan:
        """Plan a graph on the solver's device through the cache (a `Plan`
        passes through).  Auto-T and auto-storage resolve per graph, and
        `options.hybrid` plans the tile partition (the default "auto" at
        the cost model's threshold), except for an engine without
        `supports_hybrid` (segment: it has no tiles to split), which plans
        it "off", as the reference's Solver does."""
        if isinstance(graph, Plan):
            return graph
        graph = graph.to(self.device)
        tile_size = self.options.tile_size or choose_tile_size(
            graph.n_nodes, graph.n_edges
        )
        storage = resolve_storage(
            self.options.storage, graph.n_nodes, graph.n_edges, tile_size
        )
        hybrid = self.options.hybrid
        if not get_engine(self.options.engine).supports_hybrid:
            hybrid = "off"
        plan, _ = self.plans.plan(graph, tile_size=tile_size, storage=storage, hybrid=hybrid,
                                  hybrid_threshold=self.options.hybrid_threshold)
        return plan

    def request_key(self, plan: Plan) -> Key:
        """The content-derived key a batched member draws under
        (`serve_mis.batcher.request_key`): a member's solo reproduction is
        `solve(plan, key=solver.request_key(plan))`."""
        from repro_torch.serve_mis.batcher import request_key

        return request_key(self._base_key, plan)

    def route(self, plan: Plan) -> str:
        """The placement policy: "auto" gives "sharded" when the padded
        graph reaches `options.shard_threshold` and the default group has
        more than one rank, "local" otherwise."""
        from repro_torch.core.distributed import world_size

        if self.options.placement != "auto":
            return self.options.placement
        if plan.tiled.n_padded >= self.options.shard_threshold and world_size() > 1:
            return "sharded"
        return "local"

    def _check_device(self, plan: Plan) -> Plan:
        if plan.device != self.device:
            raise ValueError(
                f"plan lives on {plan.device}, solver on {self.device}"
            )
        return plan

    def _solve_routed(self, plan: Plan, key: Key, trace: Optional[Trace]) -> SolveResult:
        if self.route(plan) == "sharded":
            return self._solve_sharded(plan, key, trace)
        return self._solve_local(plan, key, trace)

    def _key(self, key: Optional[Key]) -> Key:
        return self._base_key if key is None else key

    # -- execution ---------------------------------------------------------

    def solve(
        self,
        graph: GraphLike,
        *,
        key: Optional[Key] = None,
        trace: Optional[Trace] = None,
    ) -> SolveResult:
        """Solve one graph.  Priorities draw under `key` (a `core.prng.Key`),
        by default `prng.key(options.seed)`.

        `trace` (`repro_torch.obs.Trace`, default None: no clock read)
        records the spans `solver.solve` ⊃ `solver.plan`, `solver.execute`;
        `execute` ends after the result's host copy, so it holds the
        device work, and a traced result's stats carry its wall time as
        `execute_ms`.  The port compiles no program, so the local route
        has no `solver.compile` span and no `compile_ms` (the reference's
        cold traced dispatch has both); the sharded route's slab build
        runs in a `solver.compile` span."""
        with trace_span(trace, "solver.solve"):
            with trace_span(trace, "solver.plan"):
                plan = self._check_device(self.plan(graph))
            return self._solve_routed(plan, self._key(key), trace)

    def _solve_local(self, plan: Plan, key: Key, trace: Optional[Trace]) -> SolveResult:
        return self._execute(
            plan, lambda: run_tc_mis(plan.g, plan.tiled, key, self.options),
            trace, "solve")

    def _execute(self, plan: Plan, run, trace: Optional[Trace], scope: str) -> SolveResult:
        """One convergence loop on `plan` (`run()`: a cold `run_tc_mis` or
        a warm-started repair), its host copy, and the solver's metrics."""
        t0 = time.perf_counter()
        with trace_span(trace, "solver.execute"):
            result, rt = self._split_telemetry(run(), plan.g, plan.tiled, scope=scope)
            in_mis_plan = result.in_mis.cpu().numpy().astype(bool)
            rounds = int(result.rounds)
            converged = bool(result.converged)
        solve_ms = (time.perf_counter() - t0) * 1e3
        self.metrics.counter("solver.solves").inc()
        self.metrics.histogram("solver.solve_ms").observe(solve_ms)
        self._note_attribution(plan.tiled, rt, solve_ms)
        stats = {"solve_ms": solve_ms, "batch_size": 1, "device": str(self.device)}
        if trace is not None:
            stats["execute_ms"] = solve_ms   # the solver.execute span
        return SolveResult(
            in_mis=plan.to_original(in_mis_plan).astype(bool),
            rounds=rounds,
            converged=converged,
            placement="local",
            plan=plan,
            stats=stats,
            telemetry=rt,
        )

    def solve_many(
        self,
        graphs: Iterable[GraphLike],
        *,
        keys: Optional[Sequence[Key]] = None,
        trace: Optional[Trace] = None,
    ) -> List[SolveResult]:
        """Solve a workload, batching where it pays.

        Empty input returns `[]`, and a single graph goes through `solve`:
        neither builds a batch.  Of two or more graphs, those that route
        sharded solve one by one on that route; the rest group by (tile
        size, storage), as a batch shares both; a group of two or more
        packs into one block-diagonal batch and one convergence loop, a
        group of one solves alone.  Results keep the input order.  Members
        draw under `request_key(plan)` unless `keys` gives one per graph
        (then the priority cache is bypassed)."""
        with trace_span(trace, "solver.plan"):
            plans = [self._check_device(self.plan(g)) for g in graphs]
        if not plans:
            return []
        default = keys is None
        if default:
            keys = [self.request_key(p) for p in plans]
        elif len(keys) != len(plans):
            raise ValueError(f"{len(plans)} graphs but {len(keys)} keys")
        if len(plans) == 1:
            return [self.solve(plans[0], key=keys[0], trace=trace)]

        out: List[Optional[SolveResult]] = [None] * len(plans)
        groups: "OrderedDict[tuple, List[int]]" = OrderedDict()
        for i, p in enumerate(plans):
            if self.route(p) == "sharded":
                out[i] = self._solve_sharded(p, keys[i], trace)
            else:
                groups.setdefault((p.tile_size, p.tiled.storage), []).append(i)
        for idxs in groups.values():
            if len(idxs) == 1:
                i = idxs[0]
                out[i] = self._solve_local(plans[i], keys[i], trace)
                continue
            solved = self._solve_batched(
                [plans[i] for i in idxs], [keys[i] for i in idxs],
                use_priority_cache=default, trace=trace,
            )
            for i, r in zip(idxs, solved):
                out[i] = r
        return out   # type: ignore[return-value]

    def _solve_batched(
        self,
        plans: Sequence[Plan],
        keys: Sequence[Key],
        use_priority_cache: bool = True,
        trace: Optional[Trace] = None,
    ) -> List[SolveResult]:
        from repro_torch.serve_mis.batcher import member_priorities, pack_batch

        cache = self._priority_cache if use_priority_cache else None
        t0 = time.perf_counter()
        with trace_span(trace, "solver.pack", batch_size=len(plans)):
            pris = [member_priorities(p, k, self.options.heuristic, cache)
                    for p, k in zip(plans, keys)]
            batch = pack_batch(plans, pris)
        pack_ms = (time.perf_counter() - t0) * 1e3
        self.metrics.counter("solver.batches").inc()
        self.metrics.histogram("solver.batch_size").observe(len(plans))

        t0 = time.perf_counter()
        with trace_span(trace, "solver.execute", batch_size=len(plans)):
            out = run_tc_mis(batch.g, batch.tiled, None, self.options,
                             priorities=batch.priorities, alive0=batch.alive0,
                             col_gate=batch.col_gate, member_rounds=True)
            result, rt = self._split_telemetry(out, batch.g, batch.tiled, scope="batch",
                                               batch_size=len(plans))
            in_mis = batch.unpack(result.in_mis)
            rounds = batch.unpack(result.rounds)
            converged = bool(result.converged)
        batch_ms = (time.perf_counter() - t0) * 1e3
        self.metrics.counter("solver.solves").inc(len(plans))
        self.metrics.histogram("solver.batch_ms").observe(batch_ms)
        self._note_attribution(batch.tiled, rt, batch_ms)

        # one loop served the whole batch: each member's `solve_ms` is its
        # 1/batch share, the shared wall clock is `batch_ms`
        shared = dict(solve_ms=batch_ms / len(plans), batch_ms=batch_ms, pack_ms=pack_ms,
                      bucket=batch.signature(), batch_size=len(plans),
                      device=str(self.device))
        if trace is not None:
            shared["execute_ms"] = batch_ms   # the batch's solver.execute span
        return [
            SolveResult(
                in_mis=plan.to_original(mis.astype(bool)).astype(bool),
                rounds=int(np.max(rnd)) if rnd.size else 0,
                converged=converged,
                placement="batched",
                plan=plan,
                stats=dict(shared),
                telemetry=rt,
            )
            for plan, mis, rnd in zip(plans, in_mis, rounds)
        ]

    def update(
        self,
        prior: SolveResult,
        delta,
        *,
        key: Optional[Key] = None,
        trace: Optional[Trace] = None,
    ) -> SolveResult:
        """Apply an `EdgeDelta` (original vertex ids) to a solved graph and
        re-solve.

        The plan is patched tile by tile through the cache
        (`PlanCache.apply_delta`: delta-chained key, the parent's disk
        entry retired), then re-solved per `options.repair`:

          incremental   warm-start the round loop from `prior.in_mis` with
                        only the dirty frontier alive
                        (`dyngraph.repair.repair_solution`)
          cold          a fresh `solve` of the patched plan
          auto          incremental while the delta touches at most
                        `options.repair_threshold` of the vertices

        A patched plan that routes sharded is always re-solved cold (the
        sharded loop has no warm start).

        `prior` must be a converged result for the plan the delta applies
        to (chain updates by passing each result to the next).  Both modes
        draw the patched graph's priorities under the same key (`key`, by
        default the seed's), so an empty delta returns the prior solution
        bit for bit either way.
        Stats gain `repair` (the mode taken), `patch` (the cache layer of
        the patched plan), `patch_ms`, `plan_epoch`, `delta_add` and
        `delta_remove`."""
        from repro_torch.dyngraph.repair import dirty_mask, note_repair, repair_solution

        t0 = time.perf_counter()
        with trace_span(trace, "solver.plan"):
            plan2, patch_status = self.plans.apply_delta(prior.plan, delta)
            self._check_device(plan2)
        extra = dict(
            patch=patch_status, patch_ms=(time.perf_counter() - t0) * 1e3,
            plan_epoch=plan2.epoch, delta_add=delta.n_add, delta_remove=delta.n_remove,
        )
        touched = delta.touched()
        dirty_frac = touched.size / max(plan2.n_nodes, 1)
        mode = self.options.repair
        if mode == "auto":
            mode = "incremental" if dirty_frac <= self.options.repair_threshold else "cold"
        if mode == "incremental" and self.route(plan2) == "sharded":
            mode = "cold"
        note_repair(mode, dirty_frac=dirty_frac)
        key = self._key(key)
        if mode == "cold":
            with trace_span(trace, "solver.update", mode="cold"):
                res = self._solve_routed(plan2, key, trace)
            return dataclasses.replace(res, stats=dict(res.stats, repair="cold", **extra))

        with trace_span(trace, "solver.update", mode="incremental"):
            touched_plan = touched if plan2.inv is None else plan2.inv[touched]
            dirty = torch.from_numpy(dirty_mask(plan2.n_nodes, touched_plan)).to(self.device)
            prior_plan = torch.from_numpy(
                plan2.to_plan_ids(prior.in_mis).astype(bool)).to(self.device)
            res = self._execute(plan2, lambda: repair_solution(
                plan2.g, plan2.tiled, key, self.options, prior_plan, dirty),
                trace, "repair")
        return dataclasses.replace(res, stats=dict(res.stats, repair="incremental", **extra))

    def profile(
        self,
        graph: GraphLike,
        *,
        key: Optional[Key] = None,
        trace: Optional[Trace] = None,
    ):
        """The instrumented twin (`core.tc_mis.run_phases`): rounds stepped
        from Python with a clock around each phase, synced on the card.
        Returns `(SolveResult, times)` with times keyed phase1 / phase2 /
        phase3 (seconds summed over the rounds) and rounds; the result
        bit-matches `solve` on the same graph and key.  `trace`
        records `solver.profile` ⊃ `solver.plan` and each round's
        `rounds.phase1` / `rounds.phase2` / `rounds.phase3`.  The twin
        steps the local round engine: a plan that routes sharded raises."""
        with trace_span(trace, "solver.profile"):
            with trace_span(trace, "solver.plan"):
                plan = self._check_device(self.plan(graph))
            if self.route(plan) == "sharded":
                raise NotImplementedError(
                    "profile has no sharded twin: it steps the local round engine")
            result, times = run_phases(plan.g, plan.tiled, self._key(key),
                                       self.options, trace=trace)
        self.metrics.counter("solver.solves").inc()
        in_mis_plan = result.in_mis.cpu().numpy().astype(bool)
        res = SolveResult(
            in_mis=plan.to_original(in_mis_plan).astype(bool),
            rounds=int(result.rounds),
            converged=bool(result.converged),
            placement="local",
            plan=plan,
            stats=dict(times, device=str(self.device)),
        )
        return res, times

    def _solve_sharded(self, plan: Plan, key: Key,
                       trace: Optional[Trace] = None) -> SolveResult:
        """One sharded solve on this rank (every rank of the group calls it
        with the same plan and key, so every rank draws the same
        priorities).  Dense-only: the slabs
        take the plan's whole tile list and its hybrid partition goes
        unused, as the reference's shard_map loop has no sparse-tail seam.
        The plan's slab is built once and kept (LRU of
        `_DIST_PROGRAM_CACHE` per Solver): the `compile` stat says
        "compiled" when this call built it, "reused" when it came from the
        cache, the reference's values for its shard_map program."""
        import torch.distributed as dist

        from repro_torch.core.distributed import (
            DistConfig, build_distributed_mis, process_group, shard_tiled,
        )

        group = process_group(self.device)
        n_shards = dist.get_world_size(group)
        run = self._dist_runs.get(plan.key)
        compile_stat = "reused" if run is not None else "compiled"
        if run is None:
            self.metrics.counter("solver.compiles").inc()
            with trace_span(trace, "solver.compile", placement="sharded"):
                run = build_distributed_mis(
                    shard_tiled(plan.tiled, n_shards), group, DistConfig(
                        max_rounds=self.options.max_rounds,
                        bitpack=self.options.bitpack,
                        lanes=self.options.lanes,
                    ))
            self._dist_runs[plan.key] = run
            while len(self._dist_runs) > _DIST_PROGRAM_CACHE:
                self._dist_runs.popitem(last=False)
        else:
            self._dist_runs.move_to_end(plan.key)

        pri = make_priorities(self.options.heuristic, key, plan.g.n_nodes,
                              plan.g.degrees())
        t0 = time.perf_counter()
        with trace_span(trace, "solver.execute", placement="sharded"):
            res = run(pri)
            in_mis_plan = res.in_mis[: plan.g.n_nodes].cpu().numpy().astype(bool)
        solve_ms = (time.perf_counter() - t0) * 1e3
        self.metrics.counter("solver.solves").inc()
        self.metrics.histogram("solver.solve_ms").observe(solve_ms)
        stats = dict(solve_ms=solve_ms, compile=compile_stat, n_shards=n_shards,
                     batch_size=1, device=str(self.device))
        if trace is not None:
            stats["execute_ms"] = solve_ms   # the solver.execute span
        return SolveResult(
            in_mis=plan.to_original(in_mis_plan).astype(bool),
            rounds=res.rounds,
            # the loop returns no flag: stopping before the bound is the
            # (conservative) convergence signal, as the reference's
            converged=res.rounds < self.options.max_rounds,
            placement="sharded",
            plan=plan,
            stats=stats,
        )

    # -- telemetry and metrics ---------------------------------------------

    def _split_telemetry(self, out, g: Graph, tiled, *, scope: str = "solve",
                         batch_size: int = 1):
        """Telemetry off: `out` is the result → (result, None).  Telemetry
        on: `out` is `(result, buffer)`; the buffer comes to the host here,
        its one device→host transfer, as a `RoundTrace`.  A batch counts
        rounds per vertex: the rounds run are the largest count."""
        if not self.options.telemetry:
            return out, None
        result, buf = out
        rounds = int(result.rounds.max()) if result.rounds.ndim else int(result.rounds)
        engine = get_engine(self.options.engine)
        meta = dict(
            scope=scope,
            engine=self.options.engine,
            storage=tiled.storage,
            frontier=resolve_frontier(self.options, engine, storage=tiled.storage,
                                      member_rounds=batch_size > 1),
            n_nodes=g.n_nodes,
        )
        if batch_size > 1:
            meta["batch_size"] = batch_size
        rt = RoundTrace.from_buffer(buf.cpu().numpy(), rounds,
                                    tiles_total=tiled.n_tiles_pad, meta=meta)
        return result, rt

    def _note_attribution(self, tiled, rt: Optional[RoundTrace], solve_ms: float) -> None:
        """The cost model's error gauges: predicted against measured cost
        per round, from the telemetry's dispatch mix (telemetry on only;
        `rt is None` records nothing).  The tail is priced at its real
        entries, the stream the port's tail runs (`tail_rows.numel()`; the
        reference prices its sentinel-padded length)."""
        if rt is None or not rt.rounds:
            return
        from repro_torch.perf.roofline import round_cost_attribution

        dense = sum(rt.tiles_dense) / rt.rounds if rt.tiles_dense else 0.0
        if dense <= 0.0 and rt.tiles_total:
            # an engine that fills no dense-tile column (segment): every
            # tile the round did not skip went the one dense way
            dense = max(rt.tiles_total - sum(rt.tiles_skipped) / rt.rounds, 0.0)
        p = tiled.partition
        sparse = float(p.tail_rows.numel()) if p is not None else 0.0
        att = round_cost_attribution(
            dense_tiles=dense, sparse_edges=sparse,
            tile_size=tiled.tile_size, storage=tiled.storage,
            measured_s=(solve_ms / 1e3) / rt.rounds,
        )
        self.metrics.gauge("perf.roofline_predicted_us").set(att["predicted_us"])
        self.metrics.gauge("perf.roofline_measured_us").set(att["measured_us"])
        self.metrics.gauge("perf.roofline_error_pct").set(att["error_pct"])
