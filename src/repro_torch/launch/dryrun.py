"""The dry run: build every (arch × shape × mesh) cell's step on fake
tensors as rank 0 of a fake process group of 256 or 512 ranks, run it
once under a counting mode, and record its memory per device, FLOPs,
bytes, collective bytes and roofline terms (counterpart of
`repro.launch.dryrun`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --mesh both \\
        --out experiments/dryrun_torch --skip-existing [--device cpu]

Nothing is allocated and no card is needed: the cells' tensors are fake
(`torch._subclasses.fake_tensor`), so the Hopper kernel wrappers take
their fake branches and report what their launches move and compute
(`perf.counting.record_kernel`), and the process group is torch's "fake"
backend (`FakeStore`), whose collectives return at once.  The fake tensors
carry the device "cuda" where torch is built with CUDA; a torch built
without it has no CUDA device guard, which Python indexing of a CUDA
tensor needs, so there they carry "cpu" (`FAKE_DEVICE`): every wrapper
tests for a fake tensor before its device, and no step of a cell branches
on the device type, so both run the same code.  The only real work is the
tcmis stand-ins' tile counts, on `--device` ("cuda" by default, as every
entry point; "cpu" without a card).

Methodology, as the reference's (its XLA passes become counted runs):
* memory pass: the production program at full depth, run once; the peak
  of the bytes alive (`CountingMode`'s tracker) is the fits-on-a-card
  evidence.  If it runs past `MEMORY_LIMIT_S` (5 min), the cell's memory
  comes from the program at 2 and 4 layers of its stack, affine in the
  layer count (`memory_method` says which).
* cost passes: LM cells run the program cut to 2 and 4 layers of its stack
  with raised chunks and extrapolate affinely in the layer count (as the
  reference does; it bounds the host time of the fake runs).  Other cells
  take their memory pass's counts (the MIS cells count one round).
* roofline: compute = FLOPs / PEAK_FLOPS, memory = bytes / HBM_BW,
  collective = bytes over NVLINK_BW within an 8-card node, NET_BW across
  (`perf.roofline`, the H100 SXM data sheet: computed, not measured).

Meshes: "single" is (data=16, model=16); "multi" the reference's (pod=2,
data=16, model=16), run as (data=32, model=16): the port's steps take one
batch axis (`dist.collectives.data_group`), and pod × data in row-major
order is that axis, rank for rank.

A failure is recorded with its traceback and the run exits 1.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import sys
import time
import traceback

import torch

# mesh kind -> (the shape run, its axis names, the reference's mesh it stands for)
PRODUCTION_MESHES = {
    "single": ((16, 16), ("data", "model"), {"data": 16, "model": 16}),
    "multi": ((32, 16), ("data", "model"), {"pod": 2, "data": 16, "model": 16}),
}
HARDWARE = "H100 SXM data sheet; computed, not measured"
FAKE_DEVICE = "cuda" if torch.backends.cuda.is_built() else "cpu"
MEMORY_LIMIT_S = 300.0


@contextlib.contextmanager
def fake_group(shape, names, device_type: str = FAKE_DEVICE):
    """A `DeviceMesh` of `shape` over a fake process group of as many ranks,
    this process rank 0; the group is destroyed on the way out."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    # torch's fake process-group store (a private module)
    from torch.testing._internal.distributed.fake_pg import FakeStore

    size = 1
    for s in shape:
        size *= s
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()


class _Overrun(Exception):
    """A pass ran past its time limit."""


@contextlib.contextmanager
def _time_limit(seconds):
    import threading

    if not seconds or threading.current_thread() is not threading.main_thread():
        yield               # SIGALRM reaches the main thread only
        return

    def on_alarm(*_):
        raise _Overrun(f"past {seconds} s")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def count_pass(cell, mesh, variant: str, time_limit=None) -> dict:
    """Build `cell` on `mesh` as `variant` inside a fresh fake mode, run its
    step once under a `CountingMode`: {"memory", "cost", "kernels",
    "outputs" (each output tensor's shape and dtype), "build_s", "run_s"}."""
    from repro_torch.hopper.launch import fake_mode as new_fake_mode
    from repro_torch.perf.counting import CountingMode

    fake_mode = new_fake_mode()
    with fake_mode, _time_limit(time_limit):
        t0 = time.perf_counter()
        fn, inputs, _ = cell.build(mesh, variant=variant)
        t_build = time.perf_counter() - t0
        counter = CountingMode(fake_mode)
        counter.track(inputs)
        t0 = time.perf_counter()
        with counter:
            out = fn(*inputs)
        t_run = time.perf_counter() - t0
        memory = counter.finish(out)
        outputs = [(tuple(t.shape), str(t.dtype)) for t in _tensor_leaves(out)]
        del out, inputs, fn
    return dict(
        memory=memory,
        cost=dict(flops=counter.flops, bytes_accessed=counter.bytes,
                  collectives=dict(counter.collectives),
                  collective_links=dict(counter.collective_links)),
        kernels={k: vars(r) for k, r in counter.kernels.items()},
        outputs=outputs,
        build_s=t_build, run_s=t_run,
    )


def _tensor_leaves(tree) -> list:
    from repro_torch.train import tree as T

    return [t for t in T.leaves(tree) if isinstance(t, torch.Tensor)]


def _affine(a: dict, b: dict, la: int, lb: int, lfull: int) -> dict:
    """Per-key affine extrapolation X(L) = Xa + (Xb-Xa)/(lb-la)·(L-la)."""
    t = (lfull - la) / (lb - la)

    def ext(xa, xb):
        return xa + (xb - xa) * t

    def ext_dict(da, db):
        return {k: int(max(0, ext(da.get(k, 0), db.get(k, 0)))) for k in set(da) | set(db)}

    out = dict(
        flops=ext(a["flops"], b["flops"]),
        bytes_accessed=ext(a["bytes_accessed"], b["bytes_accessed"]),
        collectives=ext_dict(a["collectives"], b["collectives"]),
    )
    if "collective_links" in a or "collective_links" in b:
        out["collective_links"] = ext_dict(a.get("collective_links", {}),
                                           b.get("collective_links", {}))
    return out


def _affine_memory(a: dict, b: dict, la: int, lb: int, lfull: int) -> dict:
    t = (lfull - la) / (lb - la)
    return {k: int(a[k] + (b[k] - a[k]) * t) for k in a}


def _moe_note(cell) -> str:
    from repro_torch.configs import REGISTRY

    cfg = REGISTRY[cell.arch].config
    if getattr(cfg, "moe", None) is None:
        return ""
    return ("MoE expert buffers at the static bound (E, C) split over the batch ranks "
            "(the reference's buf_pspec), not sized from the routing")


def run_cell(arch_id: str, shape: str, mesh_kind: str, out_dir: str, skip_existing: bool,
             memory_limit: float = MEMORY_LIMIT_S) -> dict:
    from repro_torch.configs import REGISTRY
    from repro_torch.perf.roofline import roofline_from_counts

    tag = f"{arch_id}__{shape}__{mesh_kind}".replace("/", "_")
    path = os.path.join(out_dir, tag + ".json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") in ("ok", "skipped"):
            print(f"[skip] {tag}", flush=True)
            return rec

    cell = REGISTRY[arch_id].cells[shape]
    run_shape, names, stands_for = PRODUCTION_MESHES[mesh_kind]
    rec = dict(arch=arch_id, shape=shape, mesh=mesh_kind, kind=cell.kind, note=cell.note,
               mesh_shape=stands_for, mesh_run=dict(zip(names, run_shape)),
               hardware=HARDWARE, torch=torch.__version__, fake_device=FAKE_DEVICE)
    if cell.skip_reason:
        rec.update(status="skipped", skip_reason=cell.skip_reason)
        _write(path, rec)
        print(f"[N/A ] {tag}: {cell.skip_reason}", flush=True)
        return rec

    try:
        with fake_group(run_shape, names) as mesh:
            n_dev = mesh.size()
            times = {}
            try:
                full = count_pass(cell, mesh, "memory", memory_limit)
                mem = full["memory"]
                times.update(build_s=round(full["build_s"], 2), run_s=round(full["run_s"], 2))
                rec["memory_method"] = "direct (the production program at full depth)"
            except _Overrun:
                ex = cell.extrapolate
                if not ex:
                    raise
                ma = count_pass(cell, mesh, "memory_a")
                mb = count_pass(cell, mesh, "memory_b")
                mem = _affine_memory(ma["memory"], mb["memory"], ex["la"], ex["lb"], ex["lfull"])
                full = ma
                times.update(memory_a_s=round(ma["run_s"], 2), memory_b_s=round(mb["run_s"], 2))
                rec["memory_method"] = (
                    f"affine layer extrapolation L∈{{{ex['la']},{ex['lb']}}} → {ex['lfull']} "
                    f"of the production program (the full-depth pass ran past "
                    f"{memory_limit:.0f} s)")
                rec["memory_samples"] = dict(memory_a=ma["memory"], memory_b=mb["memory"])
            if cell.extrapolate:
                ex = cell.extrapolate
                ca = count_pass(cell, mesh, "cost_a")
                cb = count_pass(cell, mesh, "cost_b")
                cost = _affine(ca["cost"], cb["cost"], ex["la"], ex["lb"], ex["lfull"])
                times.update(cost_a_s=round(ca["run_s"], 2), cost_b_s=round(cb["run_s"], 2))
                rec["cost_method"] = (f"affine layer extrapolation L∈{{{ex['la']},{ex['lb']}}} "
                                      f"→ {ex['lfull']} (raised chunks)")
                rec["cost_samples"] = dict(cost_a=ca["cost"], cost_b=cb["cost"])
                if rec["memory_method"].startswith("direct"):
                    rec["cost_samples"]["memory_pass"] = full["cost"]
            else:
                cost = full["cost"]
                rec["cost_method"] = "direct (one run of the step)"
        terms = roofline_from_counts(cost, n_dev, cell.model_flops)
        moe = _moe_note(cell)
        rec.update(
            status="ok", devices=n_dev, times=times, memory=mem, cost=cost,
            roofline=terms.as_dict(), model_flops_global=cell.model_flops,
            kernels=full["kernels"],
            **({"moe_buffers": moe} if moe else {}),
        )
        print(f"[ ok ] {tag}: mem {mem['total_per_device'] / 2**30:.2f} GiB/dev, "
              f"dominant={terms.dominant}, step {terms.step_time_s * 1e3:.3f} ms, "
              f"mfu={terms.mfu:.3f}, kernels {sorted(rec['kernels'])}, "
              f"{sum(times.values()):.1f} s", flush=True)
    except Exception as e:  # noqa: BLE001 - a failure is a record, not a crash
        rec.update(status="error", error=repr(e), traceback=traceback.format_exc())
        print(f"[FAIL] {tag}: {e!r}", flush=True)
    _write(path, rec)
    return rec


def _write(path: str, rec: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", default="all")
    p.add_argument("--shape", default="all")
    p.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    p.add_argument("--out", default="experiments/dryrun_torch")
    p.add_argument("--skip-existing", action="store_true")
    p.add_argument("--list", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where the tcmis stand-ins' tile counts run (the only real work)")
    args = p.parse_args(argv)

    from repro_torch.configs import REGISTRY

    archs = list(REGISTRY) if args.arch == "all" else args.arch.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.list:
        for a in archs:
            for s in REGISTRY[a].cells:
                print(f"{a} × {s}")
        return 0

    if "tcmis" in archs:
        from repro_torch.configs.tcmis import measure_occupancy

        measure_occupancy(args.device)
    failures = 0
    t0 = time.perf_counter()
    for a in archs:
        shapes = list(REGISTRY[a].cells) if args.shape == "all" else args.shape.split(",")
        for s in shapes:
            if s not in REGISTRY[a].cells:
                continue
            for m in meshes:
                rec = run_cell(a, s, m, args.out, args.skip_existing)
                if rec.get("status") == "error":
                    failures += 1
    print(f"dry-run complete; {failures} failures; {time.perf_counter() - t0:.1f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
