#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card (Hopper, sm_90a) and nvcc; exits non-zero, printing no
result, without them.  Imports nothing of JAX or of the reference package.
Phases, each fatal on failure:

  1. build   every csrc/*.cu with nvcc (one process per source, in parallel);
             print the build seconds and the card's name and power limit.
  2. kernels hold each Hopper kernel against its plain-torch version on the
             card, on the G2 stand-in (grid2d(1044, 1044): 1,089,936
             vertices) planned four ways, {int8, bitpack} × T ∈ {16, 128},
             with seeded random cand/alive and about a third of the
             block-columns gated off: the fused kernel must agree exactly,
             the split kernel on a random f32 RHS within rtol=atol=1e-5
             (summation order differs).
  3. paths   the main path, `Solver(SolveOptions(hybrid="off")).solve(G2)`
             (fused engine, auto-T=16, bitpack), must converge to a valid MIS
             equal, with equal rounds, to an `engine="tiled_ref"` solve on the
             card, with the fused kernel launched exactly once per round; the
             same with storage="int8"; and the `tiled_pallas` path, whose
             split kernel must launch once per round.  Launch counts are set
             to 0 just before each path and read just after it.
  4. timing  CUDA-event times per launch at the main path's round-1 inputs:
             each kernel, its plain version, and one
             `torch.sparse_bsr_tensor @ rhs` as the library yardstick (never
             used by the port); the bound from this run's bytes and
             operations; the whole solve.

The line before the last is a JSON object with one record per kernel; the
last line is `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

G2_SHAPE = (1044, 1044)          # roadNet-PA stand-in, full size
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
KERNEL_SOURCE = "src/repro_torch/csrc/tc_spmv.cu"
REPLACES = {
    "tc_spmv_fused": "src/repro/kernels/tc_spmv.py:137",
    "tc_spmv": "src/repro/kernels/tc_spmv.py:54",
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean ms per call from CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build() -> None:
    from repro_torch.hopper import build

    t0 = time.perf_counter()
    took = build.build_all()
    print(f"[build] {json.dumps({k: round(v, 3) for k, v in took.items()})} "
          f"wall {time.perf_counter() - t0:.3f} s", flush=True)
    for name in took:
        log = build.build_log(name)
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes")
                  and " 0 bytes spill stores, 0 bytes spill loads" not in ln]
        print(f"[build] {name}: {len(regs)} kernels; {regs[:1]}; "
              f"spilling lines: {len(spills)}", flush=True)
    print(f"[card] {card_line()}", flush=True)


def random_frontier(tiled, gen):
    """Seeded cand/alive on the padded vertex axis, and column flags with
    about a third of the block-columns gated off."""
    import torch
    from repro_torch.core.engine import block_col_flags

    n = tiled.n_padded
    dev = tiled.device
    alive = torch.rand(n, generator=gen, device=dev) < 0.7
    cand = alive & (torch.rand(n, generator=gen, device=dev) < 0.2)
    gate = (torch.rand(tiled.n_block_cols, generator=gen, device=dev) >= 1 / 3)
    flags = block_col_flags(alive, tiled.tile_size) * gate.to(torch.int32)
    return cand, alive, flags.contiguous()


def phase_kernels(g2) -> dict:
    """Kernel vs plain on the four G2 plans; returns max |err| per kernel."""
    import torch
    from repro_torch.api import Plan
    from repro_torch.hopper import tc_spmv as K

    errs = {"tc_spmv_fused": 0.0, "tc_spmv": 0.0}
    for T in (16, 128):
        for storage in ("int8", "bitpack"):
            t0 = time.perf_counter()
            plan = Plan.build(g2, tile_size=T, storage=storage)
            tiled = plan.tiled
            gen = torch.Generator(device="cuda").manual_seed(T)
            cand, alive, flags = random_frontier(tiled, gen)
            lanes = 8
            rhs01 = (torch.rand((tiled.n_padded, lanes), generator=gen,
                                device="cuda") < 0.5).float()
            rhs01[:, 0] = cand.float()
            rhs01[:, 1] = alive.float()
            for fl in (flags, None):
                got = K.tc_spmv_fused(tiled, rhs01, cand, alive, col_flags=fl)
                want = K.tc_spmv_fused_plain(tiled, rhs01, cand, alive, col_flags=fl)
                torch.cuda.synchronize()
                for name, a, b in zip(("n_c", "new_alive", "mis_add"), got, want):
                    check(torch.equal(a, b),
                          f"fused kernel != plain ({name}, T={T}, {storage}, "
                          f"flags={'on' if fl is not None else 'off'})")
            rhs = torch.randn((tiled.n_padded, lanes), generator=gen, device="cuda")
            got = K.tc_spmv(tiled, rhs, col_flags=flags)
            want = K.tc_spmv_plain(tiled, rhs, col_flags=flags)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                  f"split kernel != plain (T={T}, {storage}): max |err| {err}")
            errs["tc_spmv"] = max(errs["tc_spmv"], err)
            print(f"[kernels] T={T} {storage}: tiles={tiled.n_tiles} "
                  f"active_cols={int(flags.sum())}/{tiled.n_block_cols} "
                  f"fused exact, split max|err|={err:.3g} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            del plan, tiled
    return errs


def solve_path(g2, options, label: str):
    """One `Solver.solve` with every launch count set to 0 just before it;
    returns (result, {kernel: launches}) read just after."""
    import torch
    from repro_torch.api import Solver
    from repro_torch.hopper import tc_spmv as K

    solver = Solver(options, device="cuda")
    plan = solver.plan(g2)
    K.tc_spmv_fused.launches = 0
    K.tc_spmv.launches = 0
    res = solver.solve(plan)
    torch.cuda.synchronize()
    counts = {"tc_spmv_fused": K.tc_spmv_fused.launches, "tc_spmv": K.tc_spmv.launches}
    print(f"[paths] {label}: T={plan.tile_size} {plan.storage} "
          f"tiles={plan.tiled.n_tiles} rounds={res.rounds} "
          f"converged={res.converged} mis={res.mis_size} launches={counts} "
          f"solve_ms={res.stats['solve_ms']:.3f}", flush=True)
    return solver, plan, res, counts


def phase_paths(g2) -> dict:
    import numpy as np
    import torch
    from repro_torch.api import SolveOptions
    from repro_torch.core.validate import is_valid_mis

    launches = {}
    out = {}
    for storage in ("auto", "int8"):
        opts = SolveOptions(hybrid="off", storage=storage)
        solver, plan, res, counts = solve_path(g2, opts, f"main storage={storage}")
        if storage == "auto":
            check(plan.tile_size == 16 and plan.storage == "bitpack",
                  f"main path planned T={plan.tile_size} {plan.storage}")
            launches["tc_spmv_fused"] = counts["tc_spmv_fused"]
            out["main"] = (solver, plan, res)
        check(res.converged, f"main path ({storage}) did not converge")
        check(is_valid_mis(plan.g, torch.from_numpy(res.in_mis_plan).cuda()),
              f"main path ({storage}) MIS is not valid")
        check(counts["tc_spmv_fused"] == res.rounds and counts["tc_spmv"] == 0,
              f"main path ({storage}) launches {counts} for {res.rounds} rounds")
        _, _, ref, _ = solve_path(
            g2, SolveOptions(hybrid="off", storage=storage, engine="tiled_ref"),
            f"tiled_ref storage={storage}")
        check(ref.rounds == res.rounds and np.array_equal(ref.in_mis, res.in_mis),
              f"main path ({storage}) differs from tiled_ref")
        ref_mis = ref.in_mis
    _, plan, res, counts = solve_path(
        g2, SolveOptions(hybrid="off", storage="int8", engine="tiled_pallas"),
        "tiled_pallas storage=int8")
    check(res.converged and np.array_equal(res.in_mis, ref_mis),
          "tiled_pallas path differs from tiled_ref")
    check(counts["tc_spmv"] == res.rounds and counts["tc_spmv_fused"] == 0,
          f"tiled_pallas launches {counts} for {res.rounds} rounds")
    launches["tc_spmv"] = counts["tc_spmv"]
    out["launches"] = launches
    return out


def _bound(tiled, flags, lanes: int, fused: bool):
    """Least time for one launch on this run's inputs: (ms, "bytes"|
    "operations", bytes, ops).  Bytes: each input the launch needs read
    once (tiles and RHS slabs of active columns only), each output written
    once; operations: one multiply-add per nonzero of an active tile per
    lane."""
    import torch
    from repro_torch.core.tiling import dense_tile_mask

    nt, T = tiled.n_tiles, tiled.tile_size
    cols = tiled.tile_cols[:nt].long()
    active = flags[cols] != 0
    tile_bytes = tiled.tiles[0].numel() * tiled.tiles.element_size()
    n_active_cols = int(torch.unique(cols[active]).numel())
    n_pad = tiled.n_padded
    nbytes = (
        int(active.sum()) * tile_bytes
        + tiled.tile_cols.numel() * 4 + tiled.row_starts.numel() * 4
        + flags.numel() * 4
        + n_active_cols * T * lanes * 4           # RHS slabs read
        + n_pad * lanes * 4                        # n_c written
        + (4 * n_pad if fused else 0)              # cand, alive in; 2 masks out
    )
    nnz = 0
    for lo in range(0, nt, 1 << 16):               # chunked: bounded memory
        hi = min(lo + (1 << 16), nt)
        m = dense_tile_mask(tiled.tiles[lo:hi], T)
        a = active[lo:hi]
        nnz += int(m[a].sum())
    ops = 2 * nnz * lanes
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def phase_timing(main, launches: dict, errs: dict) -> list:
    import torch
    from repro_torch.core.tc_mis import _setup
    from repro_torch.core.tiling import dense_tile_mask
    from repro_torch.hopper import tc_spmv as K

    solver, plan, _ = main
    tiled = plan.tiled
    gen = torch.Generator(device="cuda").manual_seed(solver.options.seed)
    engine, ctx, pri, state0 = _setup(plan.g, tiled, gen, solver.options)
    cand = engine.phase1_candidates(ctx, pri, state0.alive)
    flags = engine.col_flags(ctx, cand).contiguous()
    alive = state0.alive
    rhs = engine._pack_rhs(ctx, cand, alive)
    lanes = rhs.shape[1]
    print(f"[timing] round-1 inputs: T={tiled.tile_size} {tiled.storage} "
          f"tiles={tiled.n_tiles} cand={int(cand.sum())} "
          f"active_cols={int(flags.sum())}/{tiled.n_block_cols} lanes={lanes}",
          flush=True)

    # library yardstick: one BSR @ dense product over every stored tile
    nt = tiled.n_tiles
    values = dense_tile_mask(tiled.tiles[:nt], tiled.tile_size).to(torch.float32)
    bsr = torch.sparse_bsr_tensor(
        tiled.row_starts.long(), tiled.tile_cols[:nt].long(), values,
        size=(tiled.n_padded, tiled.n_padded), check_invariants=True,
    )
    lib_out = bsr @ rhs
    check(torch.allclose(lib_out, K.tc_spmv_plain(tiled, rhs), atol=1e-5),
          "BSR library product disagrees with the plain SpMV")
    library_ms = time_ms(lambda: bsr @ rhs)
    del lib_out

    records = []
    cases = {
        "tc_spmv_fused": (
            lambda: K.tc_spmv_fused(tiled, rhs, cand, alive, col_flags=flags),
            lambda: K.tc_spmv_fused_plain(tiled, rhs, cand, alive, col_flags=flags),
            True,
        ),
        "tc_spmv": (
            lambda: K.tc_spmv(tiled, rhs, col_flags=flags),
            lambda: K.tc_spmv_plain(tiled, rhs, col_flags=flags),
            False,
        ),
    }
    for name, (kern, plain, fused) in cases.items():
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1 = time_ms(plain)
        k1 = time_ms(kern)
        k2 = time_ms(kern)
        p2 = time_ms(plain)
        bound_ms, bound_by, nbytes, ops = _bound(tiled, flags, lanes, fused)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        print(f"[timing] {name}: kernel {k1:.4f}/{k2:.4f} ms, plain "
              f"{p1:.4f}/{p2:.4f} ms, library {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by} ({nbytes} B, {ops} ops)",
              flush=True)
        records.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        })

    t0 = time.perf_counter()
    res = solver.solve(plan)
    torch.cuda.synchronize()
    print(f"[timing] solve (warm, plan cached): "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms, rounds={res.rounds}",
          flush=True)
    return records


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a CUDA card")
    from repro_torch.graphs import grid2d

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    t0 = time.perf_counter()
    g2 = grid2d(*G2_SHAPE, device="cuda")
    print(f"[graph] G2 grid2d{G2_SHAPE}: n={g2.n_nodes} half-edges={g2.n_edges} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    errs = phase_kernels(g2)
    paths = phase_paths(g2)
    records = phase_timing(paths["main"], paths["launches"], errs)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": records}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
