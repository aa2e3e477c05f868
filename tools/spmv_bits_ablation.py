#!/usr/bin/env python3
"""Where the packed-word SpMV kernels' time goes, on one CUDA card.

    python3 tools/spmv_bits_ablation.py [SOURCE]
    python3 tools/spmv_bits_ablation.py --against OTHER/tc_spmv_bits.cu

Builds SOURCE (default `src/repro_torch/csrc/tc_spmv_bits.cu` as it
stands) and copies of it with one part of the work taken out (the text of
each part is replaced; the copies compute wrong hits and are only timed):

  no tile    the tile-word loads: each row word becomes one bit from a hash
             of the tile and row index, about the one or two neighbours per
             row of G2
  no cand    the candidate-word loads by column: the block-row's (or
             group's) own candidate word stands in, the same density of
             set bits, loaded once
  heads      both: what is left is the block-row heads (row_starts,
             tile_cols, col_flags), the epilogue and the stores

The replaced texts are held per form of the source: a lane per tile
(both kernels at T <= 16 of this form, one template; in the form before
it only the fused kernel took a lane per tile and the split kernel,
timed unchanged, kept a thread per vertex row) or a thread per vertex row
(the earliest form, both kernels; its walk stops at a row's first hit, so
a copy that changes the bits also changes how far the walk goes).  A source must hold
every text of one form exactly once, or the tool stops.  Each copy is
timed (CUDA events, warm and cold, as chip_smoke.py's timing phase) as
the fused and the split kernel at the packed path's round-1 inputs
(grid2d(1044, 1044), T = 16, bitpack, the round's candidates and column
flags), in the order listed and back; the full kernel is first held
equal to its plain versions.
Prints one line per copy, then the card's name and power limit.

With --against, it builds this kernel and another source of the same C
interface (an earlier commit's, say) and times both, other, this, this,
other, at the round-1 inputs of the G2 packed path at T = 16 and 128, each
held equal to the plain versions first.
"""
from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from spmv_ablation import build_copies, copies_of, form_of, time_calls, turns_line  # noqa: E402

# (old text, new text) per part, per form of the source
_TILE_LANES = {
    "tile": ("tile_rows<T>(a.tiles, t, row);",
             "for (int v = 0; v < T; ++v) row[v] = 1u << ((t * 7 + v) & (T - 1));"),
    "cand": ("const uint32_t c = __ldg(a.cand + col) & LIVE;",
             "const uint32_t c = __ldg(a.cand + r0) & LIVE;"),
}
_ROWS = {
    "tile": ("for (int w = 0; w < W; ++w) any |= row[w] & c[w];",
             "for (int w = 0; w < W; ++w) any |= (1u << ((t * 7 + v + w) & "
             "(T >= 32 ? 31 : T - 1))) & c[w];"),
    "cand": ("const uint32_t* c = cand + (size_t)col * W;",
             "const uint32_t* c = cand + (size_t)r * W;"),
}
# {form: {copy: [(old text, new text), ...]}}; the lane-per-tile form comes
# first, since its source keeps the thread-per-row kernel too (T >= 32).  Its
# texts sit in the one template both kernels instantiate, so every copy
# changes the split kernel as well as the fused one.
FORMS = {
    form: {"no tile": [parts["tile"]], "no cand": [parts["cand"]],
           "heads": [parts["tile"], parts["cand"]]}
    for form, parts in (("lane per tile", _TILE_LANES), ("thread per row", _ROWS))
}


def round1_inputs(g2, tile_size: int):
    """The packed path's round-1 phase-② inputs at G2: the plan, its word
    tiles, the candidate and alive words and the column flags."""
    import torch
    from repro_torch.api import Solver, SolveOptions
    from repro_torch.core import prng
    from repro_torch.core.tc_mis import _setup

    solver = Solver(SolveOptions(hybrid="off", phase1="tiled", tile_size=tile_size,
                                 storage="bitpack"), device="cuda")
    plan = solver.plan(g2)
    engine, ctx, pri, state0 = _setup(plan.g, plan.tiled, prng.key(solver.options.seed),
                                      solver.options)
    cand_w = engine.phase1_candidates_bits(ctx, pri, state0.alive)
    flags = engine.col_flags_bits(ctx, cand_w).contiguous()
    return dict(tiled=plan.tiled, words=ctx.bits.tiles_bits, cand_w=cand_w,
                alive_w=state0.alive, flags=flags)


def calls(x: dict) -> dict:
    """{what: (kernel call, plain call)} for the fused and the split launch."""
    from repro_torch.hopper import tc_spmv as K

    t, w, c, a, f = x["tiled"], x["words"], x["cand_w"], x["alive_w"], x["flags"]
    return {
        "fused": (lambda: K.tc_spmv_fused_bits(t, c, a, tiles_words=w, col_flags=f),
                  lambda: K.tc_spmv_fused_bits_plain(t, c, a, tiles_words=w, col_flags=f)),
        "split": (lambda: K.tc_spmv_bits(t, c, tiles_words=w, col_flags=f),
                  lambda: K.tc_spmv_bits_plain(t, c, tiles_words=w, col_flags=f)),
    }


def main() -> None:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    from repro_torch.graphs import grid2d
    from repro_torch.hopper import build

    out = ROOT / "build" / "spmv_bits_ablation"
    this = (build.CSRC / "tc_spmv_bits.cu").read_text()
    g2 = grid2d(*cs.G2_SHAPE, device="cuda")
    if len(sys.argv) == 3 and sys.argv[1] == "--against":
        libs = build_copies(out, {"this": this, "other": pathlib.Path(sys.argv[2]).read_text()})
        for T in (16, 128):
            times = time_calls(libs, ["other", "this", "this", "other"], "tc_spmv_bits",
                               calls(round1_inputs(g2, T)))
            for name, turns in times.items():
                print(f"T={T:<3d} {turns_line(name, turns)}", flush=True)
    elif len(sys.argv) <= 2:
        src = pathlib.Path(sys.argv[1]).read_text() if len(sys.argv) == 2 else this
        print(f"form: {form_of(src, FORMS)}", flush=True)
        libs = build_copies(out, copies_of(src, FORMS))
        x = round1_inputs(g2, 16)
        times = time_calls(libs, list(libs) + list(libs)[::-1], "tc_spmv_bits", calls(x))
        print(f"G2 round-1 inputs: T=16 bitpack tiles={x['tiled'].n_tiles} "
              f"block_rows={x['tiled'].n_block_rows} "
              f"active_cols={int(x['flags'].sum())}/{x['tiled'].n_block_cols}", flush=True)
        for name, turns in times.items():
            print(turns_line(name, turns), flush=True)
    else:
        raise SystemExit(__doc__)
    print(cs.card_line())


if __name__ == "__main__":
    main()
