"""`Solver` — plan, route and solve one graph (counterpart of
`repro.api.solver`, local route only).

`Solver(options, device="cuda")` runs on the CUDA device and raises where
there is none; `device="cpu"` must be asked for.  A graph handed to
`solve` is moved to the solver's device.  `solve` takes a `trace`
(`repro_torch.obs.Trace`) and, with `SolveOptions(telemetry=True)`,
returns a `RoundTrace` in `SolveResult.telemetry`; `profile` runs the
phase-timed twin.  `solve_many`, `update` and the sharded route are not
ported yet (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.api.options import SolveOptions
from repro_torch.api.plan import Plan, PlanCache, choose_tile_size, resolve_storage
from repro_torch.core.engine import get_engine, resolve_frontier
from repro_torch.core.tc_mis import run_phases, run_tc_mis
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.graph import Graph
from repro_torch.obs.rounds import RoundTrace
from repro_torch.obs.trace import Trace, trace_span

GraphLike = Union[Graph, Plan]


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """One graph's solution, in ORIGINAL vertex numbering."""
    in_mis: np.ndarray          # (n_nodes,) bool, original vertex ids
    rounds: int
    converged: bool
    placement: str              # local
    plan: Plan
    stats: Dict[str, object] = dataclasses.field(default_factory=dict)
    # the per-round series when SolveOptions.telemetry is on (obs.rounds)
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
    """Plan → route → execute on one device."""

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
            max_mem_entries=options.plan_cache_entries,
        )

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

    def route(self, plan: Plan) -> str:
        """The placement policy.  Only the local route exists here, so
        "auto" always resolves to it."""
        if self.options.placement != "auto":
            return self.options.placement
        return "local"

    def _local_plan(self, graph: GraphLike) -> Plan:
        plan = self.plan(graph)
        if plan.device != self.device:
            raise ValueError(
                f"plan lives on {plan.device}, solver on {self.device}"
            )
        if self.route(plan) != "local":
            raise NotImplementedError(
                "placement='sharded' is not ported yet (ROADMAP.md, Queue 1 item 16)"
            )
        return plan

    def _generator(self, generator: Optional[torch.Generator]) -> torch.Generator:
        if generator is not None:
            return generator
        return torch.Generator(device=self.device).manual_seed(self.options.seed)

    def solve(
        self,
        graph: GraphLike,
        *,
        generator: Optional[torch.Generator] = None,
        trace: Optional[Trace] = None,
    ) -> SolveResult:
        """Solve one graph.  Priorities draw from `generator`, by default a
        `torch.Generator` on the solver's device seeded with
        `options.seed`.

        `trace` (`repro_torch.obs.Trace`, default None: no clock read)
        records the spans `solver.solve` ⊃ `solver.plan`, `solver.execute`;
        `execute` ends after the result's host copy, so it holds the
        device work.  The port compiles no program, so there is no
        `solver.compile` span (the reference's cold traced dispatch has
        one)."""
        with trace_span(trace, "solver.solve"):
            with trace_span(trace, "solver.plan"):
                plan = self._local_plan(graph)
            generator = self._generator(generator)
            t0 = time.perf_counter()
            with trace_span(trace, "solver.execute"):
                out = run_tc_mis(plan.g, plan.tiled, generator, self.options)
                result, rt = self._split_telemetry(out, plan.g, plan.tiled)
                in_mis_plan = result.in_mis.cpu().numpy().astype(bool)
                rounds = int(result.rounds)
                converged = bool(result.converged)
            solve_ms = (time.perf_counter() - t0) * 1e3
        return SolveResult(
            in_mis=plan.to_original(in_mis_plan).astype(bool),
            rounds=rounds,
            converged=converged,
            placement="local",
            plan=plan,
            stats={"solve_ms": solve_ms, "device": str(self.device)},
            telemetry=rt,
        )

    def profile(
        self,
        graph: GraphLike,
        *,
        generator: Optional[torch.Generator] = None,
        trace: Optional[Trace] = None,
    ):
        """The instrumented twin (`core.tc_mis.run_phases`): rounds stepped
        from Python with a clock around each phase, synced on the card.
        Returns `(SolveResult, times)` with times keyed phase1 / phase2 /
        phase3 (seconds summed over the rounds) and rounds; the result
        bit-matches `solve` on the same graph and generator seed.  `trace`
        records `solver.profile` ⊃ `solver.plan` and each round's
        `rounds.phase1` / `rounds.phase2` / `rounds.phase3`."""
        with trace_span(trace, "solver.profile"):
            with trace_span(trace, "solver.plan"):
                plan = self._local_plan(graph)
            result, times = run_phases(plan.g, plan.tiled, self._generator(generator),
                                       self.options, trace=trace)
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

    def _split_telemetry(self, out, g: Graph, tiled):
        """Telemetry off: `out` is the result → (result, None).  Telemetry
        on: `out` is `(result, buffer)`; the buffer comes to the host here,
        its one device→host transfer, as a `RoundTrace`."""
        if not self.options.telemetry:
            return out, None
        result, buf = out
        rounds = int(result.rounds)
        engine = get_engine(self.options.engine)
        meta = dict(
            scope="solve",
            engine=self.options.engine,
            storage=tiled.storage,
            frontier=resolve_frontier(self.options, engine, storage=tiled.storage),
            n_nodes=g.n_nodes,
        )
        rt = RoundTrace.from_buffer(buf.cpu().numpy(), rounds,
                                    tiles_total=tiled.n_tiles_pad, meta=meta)
        return result, rt
