#!/usr/bin/env python3
"""Where the dense tiled-SpMV kernel's time goes, on one CUDA card.

    python3 tools/spmv_ablation.py
    python3 tools/spmv_ablation.py --against OTHER/tc_spmv.cu

Builds `src/repro_torch/csrc/tc_spmv.cu` as it stands and four copies of it
with one part of the work taken out (the text of each part is replaced;
the copies compute wrong sums and are only timed):

  no mma     each mma becomes a XOR of its operands into the accumulator
  no slab    the RHS slab loads become a constant
  no tile    the tile-word loads become a hash of the row index
  heads      all three: what is left is the block-row heads (row_starts,
             tile_cols, col_flags, the ballot), the f32 split and the stores

and times each (CUDA events, the same calls as chip_smoke.py's timing
phase, warm and then cold: L2 flushed before every call) as the fused and
the split kernel at the G2 main path's round-1
inputs (grid2d(1044, 1044), T = 16, bitpack, L = 8), in the order listed
and back.  The full kernel is first held equal to its plain version.
Prints one line per copy, then the card's name and power limit.

With --against, it builds instead this kernel and another source of the
same C interface (an earlier commit's, say) and times both, other, this,
this, other, at the round-1 inputs of the G2 plans T ∈ {16, 128} ×
{bitpack, int8}, each held equal to the plain version first.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

MMA = [("mma_bf16(acc[part], a, b0[part], b1[part]);",
        "acc[part][0] += __uint_as_float((a[0] ^ a[3] ^ b0[part] ^ b1[part]) & 0x7fffffu);"),
       ("mma_bf16(acc[0], a, b0[0], b1[0]);",
        "acc[0][0] += __uint_as_float((a[0] ^ a[3] ^ b0[0] ^ b1[0]) & 0x7fffffu);")]
SLAB = [("b_raw[i][j][e] = load_rhs(pb + e * L, n < L);",
         "b_raw[i][j][e] = RT((float)((tcol[i] + e) & 1));")]
TILE = [("a_raw[i][j][hh] = __ldg(pa + 8 * W * hh);",
         "a_raw[i][j][hh] = (uint32_t)(cell * 0x9E3779B9u) >> hh;")]
COPIES = {"full": [], "no mma": MMA, "no slab": SLAB, "no tile": TILE,
          "heads": MMA + SLAB + TILE}


def build_copies(out: pathlib.Path, sources: dict) -> dict:
    """{name: CUDA source text} -> {name: loaded library}, built in parallel."""
    from repro_torch.hopper import build

    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu = out / f"copy{i}.cu"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), cu.with_suffix(".so"))
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on the {name} copy:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def form_of(src: str, forms: dict) -> str:
    """The form (a key of `forms`: {form: {copy: [(old, new), ...]}}) whose
    every replaced text occurs exactly once in `src`."""
    for name, copies in forms.items():
        if all(src.count(old) == 1 for edits in copies.values() for old, _ in edits):
            return name
    raise SystemExit("the source holds the replaced texts of no known form exactly once")


def copies_of(src: str, forms: dict) -> dict:
    """{"full": src, copy: src with that copy's texts replaced} for the
    form of `src`."""
    out = {"full": src}
    for name, edits in forms[form_of(src, forms)].items():
        text = src
        for old, new in edits:
            text = text.replace(old, new)
        out[name] = text
    return out


def time_calls(libs: dict, order: list, library: str, fns: dict) -> dict:
    """{name: [{what: ms, what cold: ms}, ...]} in `order`, with
    csrc/<library>.cu's library swapped for each copy's; `fns` is {what:
    (kernel call, plain call)}; each call timed warm and cold (L2 flushed
    before every call), as by `chip_smoke.time_ms`.  The full, this and
    other kernels are held equal to the plain versions at their first
    turn."""
    import torch

    import chip_smoke as cs
    from repro_torch.hopper import build

    want = {what: plain() for what, (_, plain) in fns.items()}
    load = build.library
    times = {}
    try:
        for name in order:
            build.library = lambda n, lib=libs[name]: lib if n == library else load(n)
            if name not in times and name in ("full", "this", "other"):
                for what, (kern, _) in fns.items():
                    got, exp = kern(), want[what]
                    got, exp = (got, exp) if isinstance(got, tuple) else ((got,), (exp,))
                    cs.check(all(torch.equal(a, b) for a, b in zip(got, exp)),
                             f"the {name} kernel differs from its plain version ({what})")
            turn = {}
            for what, (kern, _) in fns.items():
                turn[what] = cs.time_ms(kern)
                turn[f"{what} cold"] = cs.time_ms(kern, cold=True)
            times.setdefault(name, []).append(turn)
    finally:
        build.library = load
    return times


def turns_line(name: str, turns: list) -> str:
    """One copy's times: `what first/second ms` per timed call."""
    return f"{name:8s} " + "  ".join(
        f"{what} {turns[0][what]:.4f}/{turns[1][what]:.4f} ms" for what in turns[0])


def round1_inputs(g2, tile_size: int, storage: str):
    """The G2 plan and the fused engine's round-1 (rhs, cand, alive, flags)."""
    import torch
    from repro_torch.api import Solver, SolveOptions
    from repro_torch.core import prng
    from repro_torch.core.tc_mis import _setup

    solver = Solver(SolveOptions(hybrid="off", tile_size=tile_size, storage=storage),
                    device="cuda")
    plan = solver.plan(g2)
    engine, ctx, pri, state0 = _setup(plan.g, plan.tiled, prng.key(solver.options.seed),
                                      solver.options)
    cand = engine.phase1_candidates(ctx, pri, state0.alive)
    flags = engine.col_flags(ctx, cand).contiguous()
    alive = state0.alive
    return plan.tiled, engine._pack_rhs(ctx, cand, alive), cand, alive, flags


def calls(tiled, rhs, cand, alive, flags) -> dict:
    """{what: (kernel call, plain call)} for the fused and the split launch."""
    from repro_torch.hopper import tc_spmv as K

    return {
        "fused": (lambda: K.tc_spmv_fused(tiled, rhs, cand, alive, col_flags=flags),
                  lambda: K.tc_spmv_fused_plain(tiled, rhs, cand, alive, col_flags=flags)),
        "split": (lambda: K.tc_spmv(tiled, rhs, col_flags=flags),
                  lambda: K.tc_spmv_plain(tiled, rhs, col_flags=flags)),
    }


def main() -> None:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    from repro_torch.graphs import grid2d
    from repro_torch.hopper import build

    src = (build.CSRC / "tc_spmv.cu").read_text()
    g2 = grid2d(*cs.G2_SHAPE, device="cuda")
    out = ROOT / "build" / "spmv_ablation"
    if len(sys.argv) == 3 and sys.argv[1] == "--against":
        libs = build_copies(out, {"this": src, "other": pathlib.Path(sys.argv[2]).read_text()})
        for T, storage in ((16, "bitpack"), (16, "int8"), (128, "bitpack"), (128, "int8")):
            times = time_calls(libs, ["other", "this", "this", "other"], "tc_spmv",
                               calls(*round1_inputs(g2, T, storage)))
            for name, turns in times.items():
                print(f"T={T} {storage:7s} {turns_line(name, turns)}", flush=True)
    elif len(sys.argv) == 1:
        sources = {}
        for name, edits in COPIES.items():
            text = src
            for old, new in edits:
                if text.count(old) != 1:
                    raise SystemExit(f"{name}: the kernel no longer has `{old}`")
                text = text.replace(old, new)
            sources[name] = text
        libs = build_copies(out, sources)
        tiled, rhs, cand, alive, flags = round1_inputs(g2, 16, "bitpack")
        times = time_calls(libs, list(libs) + list(libs)[::-1], "tc_spmv",
                           calls(tiled, rhs, cand, alive, flags))
        print(f"G2 round-1 inputs: T=16 bitpack tiles={tiled.n_tiles} "
              f"active_cols={int(flags.sum())}/{tiled.n_block_cols} lanes={rhs.shape[1]}")
        for name, turns in times.items():
            print(turns_line(name, turns))
    else:
        raise SystemExit(__doc__)
    print(cs.card_line())


if __name__ == "__main__":
    main()
