"""Operator's-eye view of a running MIS service on the port, on the CUDA
card by default.

    PYTHONPATH=src python examples/torch_health_dashboard.py [--device cpu]

Pushes synthetic traffic through `MISService` — a heterogeneous solve wave
followed by a chained delta stream against one served graph — then prints
what an operator would scrape:

  1. SLO quantiles   p50/p95/p99 per op (solve / update / batched) and per
                     span-taxonomy stage, from the fixed-bucket histograms
                     the service fills in `step()`
  2. drift trend     per-epoch touched tiles, dirty fraction and the
                     tile-locality-decay gauge recorded by `patch_plan`
  3. roofline        predicted vs measured per-round cost (model error %),
                     the H100 model's — large on the CPU by design; the
                     TREND is the signal
  4. promtext        the full merged snapshot in Prometheus text format,
                     exactly what `--metrics-path` exports for a textfile
                     collector

Everything here reads host-side instruments only: the round loop is
untouched.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.dyngraph import random_delta
from repro_torch.graphs.generators import erdos_renyi, grid2d, powerlaw
from repro_torch.obs import to_promtext
from repro_torch.serve_mis import MISService, ServeConfig


def _quantiles(snap: dict, name: str) -> str:
    h = snap.get(name)
    if not isinstance(h, dict) or not h.get("count"):
        return "(no samples)"
    return (f"n={h['count']:<3d} p50={h['p50']:>8.3f}ms "
            f"p95={h['p95']:>8.3f}ms p99={h['p99']:>8.3f}ms "
            f"max={h['max']:>8.3f}ms")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="mis-health-") as tmp:
        dashboard(args.device, os.path.join(tmp, "trace.jsonl"))


def dashboard(dev: str, trace_path: str) -> None:
    # a trace sink turns on the span taxonomy — without one, steps run the
    # untraced dispatch path and the per-stage histograms stay empty
    service = MISService(ServeConfig(
        tile_size=16, engine="tiled_ref", max_batch=4,
        repair="incremental", telemetry=True, trace_path=trace_path,
    ), device=dev)

    # -- 1. a solve wave: heterogeneous graphs, some batched together -------
    graphs = [
        erdos_renyi(400, avg_deg=6.0, seed=1, device=dev),
        powerlaw(400, avg_deg=4.0, seed=2, device=dev),
        grid2d(20, 20, seed=3, device=dev),
        erdos_renyi(400, avg_deg=6.0, seed=4, device=dev),
        erdos_renyi(200, avg_deg=3.0, seed=5, device=dev),
    ]
    for g in graphs:
        service.submit(g)
    responses = service.drain()
    assert all(r.valid for r in responses), "solve wave produced invalid MIS"
    target = responses[0].id     # the graph the delta stream will mutate

    # -- 2. a chained delta stream: each update targets the previous one ---
    print("== drift trend (chained delta stream) ==")
    print(f"{'epoch':>5} {'touched_frac':>12} {'dirty_frac':>10} "
          f"{'occupancy':>9} {'locality_decay':>14}")
    for step in range(1, 6):
        plan = service._results[target].plan
        delta = random_delta(plan.g, n_add=8, n_remove=8, seed=step)
        target = service.submit_update(target, delta)
        (resp,) = service.drain()
        assert resp.valid, f"repair failed at delta {step}"
        snap = service.metrics_snapshot()
        print(f"{snap.get('dyngraph.epoch', 0):>5} "
              f"{snap.get('dyngraph.touched_frac', 0.0):>12.4f} "
              f"{snap.get('dyngraph.dirty_frac', 0.0):>10.4f} "
              f"{snap.get('dyngraph.occupancy', 0.0):>9.5f} "
              f"{snap.get('dyngraph.locality_decay', 0.0):>14.4f}")

    snap = service.metrics_snapshot()

    # -- 3. SLO quantiles per op and per span stage -------------------------
    print("\n== SLO latency quantiles (fixed-bucket histograms) ==")
    for op in ("solve", "batched", "update"):
        print(f"  {op:<8} {_quantiles(snap, f'service.latency_ms.{op}')}")
    print("  span stages:")
    for name in sorted(snap):
        if name.startswith("service.span_ms."):
            stage = name[len("service.span_ms."):]
            print(f"    {stage:<18} {_quantiles(snap, name)}")

    # -- 4. roofline attribution (predicted vs measured per-round cost) ----
    print("\n== roofline attribution (last solve) ==")
    print(f"  predicted={snap.get('perf.roofline_predicted_us', 0.0):.1f}us "
          f"measured={snap.get('perf.roofline_measured_us', 0.0):.1f}us "
          f"error={snap.get('perf.roofline_error_pct', 0.0):+.1f}%  "
          f"(CPU error is large by design — trend, not level)")

    # -- 5. the scrape surface ---------------------------------------------
    print("\n== promtext snapshot (what --metrics-path exports) ==")
    print(to_promtext(snap), end="")


if __name__ == "__main__":
    main()
