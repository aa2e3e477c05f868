"""How often torch.profiler hands back no device event for a short call.

Builds the kernels, plans G2 on the paths of chip_smoke.py's phase 3, then
profiles 25 warm calls each of every path's solve and its set-up alone
(priorities, bit planes, state 0), printing per call the device events the
profiler returned and their busy microseconds.  Needs one CUDA card:

    python3 tools/profiler_drops.py
"""
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core import prng  # noqa: E402
from repro_torch.core.tc_mis import _setup  # noqa: E402
from repro_torch.graphs import grid2d  # noqa: E402

t0 = time.perf_counter()
cs.phase_build()
g2 = grid2d(*cs.G2_SHAPE, device="cuda")
paths = cs.phase_paths(g2)
print(f"[probe] paths ready {time.perf_counter() - t0:.1f} s", flush=True)


def events(fn):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.self_device_time_total > 0 and not e.key.startswith(cs.SPANS)]
    n_cpu = sum(1 for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CPU)
    return len(ev), sum(e.self_device_time_total for e in ev), n_cpu


for key in ("default", "hybrid30", "hybrid30_packed", "main", "packed"):
    solver, plan, res = paths[key]

    def setup():
        return _setup(plan.g, plan.tiled, prng.key(solver.options.seed), solver.options)

    for what, fn in (("solve", lambda: solver.solve(plan)), ("set-up", setup)):
        got = [events(fn) for _ in range(25)]
        empty = [i for i, (n, _, _) in enumerate(got) if n == 0]
        print(f"[probe] {key} {what}: empty in {len(empty)}/25 at {empty}; "
              f"kernels {[n for n, _, _ in got]}; busy us {[round(b, 1) for _, b, _ in got][:8]}; "
              f"cpu keys {[c for _, _, c in got][:8]}", flush=True)
print(f"[probe] {time.perf_counter() - t0:.1f} s", flush=True)
