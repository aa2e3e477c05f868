#!/usr/bin/env python3
"""Where the phase-① neighbour-max kernels' time goes, on one CUDA card.

    python3 tools/nbr_max_ablation.py [SOURCE]
    python3 tools/nbr_max_ablation.py --against OTHER/tc_neighbor_max.cu

Builds SOURCE (default `src/repro_torch/csrc/tc_neighbor_max.cu` as it
stands) and copies of it with one part of the work taken out (the text of
each part is replaced; the copies compute wrong maxes and are only timed):

  no keys    the key loads: the plane words of the scan, the priorities
             and mask bytes of the dense max
  no max     the work that turns them into row maxes
  no tile    the tile-word loads become a hash of the tile and row index,
             about one neighbour per row as at G2
  heads      all three: what is left is the block-row heads (row_starts,
             tile_cols, the mask words) and the stores
  one line   the scan's plane loads read neighbouring words of one line
             in place of one line per plane (the same instructions)
  no wait    the row maxes read no keys, so nothing waits for the key
             loads (the same loads, transposes and stores; lane-per-tile
             form only)

The replaced texts are held per form of the source (a thread per vertex
row, the earlier form; a lane per tile or per key slot, the form that
replaced it); a source must hold every text of one form exactly once, or
the tool stops.  Each copy is timed (CUDA events, warm and cold, as
chip_smoke.py's timing phase) as the select plane scan, the resolve
plane scan and the dense max at the packed path's round-1 inputs
(grid2d(1044, 1044), T = 16, bitpack), in the order listed and back;
the full kernel is first held equal to its plain versions.
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

from spmv_ablation import (  # noqa: E402
    build_copies, copies_of, form_of, time_calls, turns_line)

# (old text, new text) per part, per form of the source
PARTS = {
    "thread per row": {
        "keys": [("inter[w] = cur[w] & pw[w];",
                  "inter[w] = cur[w] & (uint32_t)((col + b) * 0x9E3779B9u);"),
                 ("if (mc[u]) acc = max(acc, pc[u]);",
                  "acc = max(acc, (int32_t)(u * 0x9E3779B9u ^ (uint32_t)base));")],
        "max": [("      if (has) {\n        maxv |= 1u << b;\n#pragma unroll\n"
                 "        for (int w = 0; w < W; ++w) cur[w] = inter[w];\n      }",
                 "      maxv += has;")],
        "tile": [("cur[w] = row[w] & mask_words[col * W + w];",
                  "cur[w] = (1u << ((t * 7 + v + w) & 31)) & Words<T>::LIVE"
                  " & mask_words[col * W + w];"),
                 ("uint32_t bits = row[w] & Words<T>::LIVE;",
                  "uint32_t bits = (1u << ((t * 7 + v + w) & 31)) & Words<T>::LIVE;")],
        "line": [("const uint32_t* pw = pc + (size_t)b * plane_stride;",
                  "const uint32_t* pw = pc + b;")],
    },
    "lane per tile or slot": {
        "keys": [("x[b] = b < Stack<K>::NB ? __ldg(a.planes + (size_t)b * a.nbc + col) : 0u;",
                  "x[b] = b < Stack<K>::NB ? (uint32_t)((col + b) * 0x9E3779B9u) : 0u;"),
                 ("const int4 k = __ldg(pk + i);",
                  "const int4 k = make_int4(col + i, col ^ i, col - i, col * i);"),
                 ("if constexpr (K == DENSE) live = mask_bits<T>(a.mask, col);",
                  "if constexpr (K == DENSE) live = Words<T>::LIVE;")],
        "max": [("keys_of_planes<T>(x, y);",
                 "for (int u = 0; u < T; ++u) y[u] = x[u] ^ x[31 - u];"),
                ("m = max(m, keys[__ffs(bits) - 1]);",
                 "m = keys[__ffs(bits) - 1]; bits = 0u;")],
        "tile": [("tile_rows<T, PACKED>(a.tiles, t, cur);",
                  "for (int v = 0; v < T; ++v) cur[v] = 1u << ((t * 7 + v) & 31);")],
        "line": [("x[b] = b < Stack<K>::NB ? __ldg(a.planes + (size_t)b * a.nbc + col) : 0u;",
                  "x[b] = b < Stack<K>::NB ? __ldg(a.planes + b + col) : 0u;")],
        "wait": [("m = max(m, keys[__ffs(bits) - 1]);",
                  "m = max(m, (int32_t)(bits * 0x9E3779B9u));")],
    },
}
COPIES = {"no keys": ["keys"], "no max": ["max"], "no tile": ["tile"],
          "heads": ["keys", "max", "tile"], "one line": ["line"], "no wait": ["wait"]}
# {form: {copy: [(old text, new text), ...]}}, as the shared helpers take
# them: the copies whose parts the form has
FORMS = {form: {copy: [edit for part in taken for edit in parts[part]]
                for copy, taken in COPIES.items() if all(part in parts for part in taken)}
         for form, parts in PARTS.items()}


def round1_inputs(g2, tile_size: int):
    """The packed path's round-1 phase-① inputs at G2: the plan, its word
    tiles, both plane stacks, the all-alive mask words, the pending mask
    words of the resolve scan, and the select key and alive vector of the
    dense max."""
    import torch
    from repro_torch.api import Solver, SolveOptions
    from repro_torch.core import prng
    from repro_torch.core.tc_mis import _setup
    from repro_torch.core.tiling import pack_frontier_words, unpack_frontier_words
    from repro_torch.hopper import tc_neighbor_max as N

    solver = Solver(SolveOptions(hybrid="off", phase1="tiled", tile_size=tile_size,
                                 storage="bitpack"), device="cuda")
    plan = solver.plan(g2)
    tiled, T = plan.tiled, plan.tile_size
    _, ctx, pri, state0 = _setup(plan.g, tiled, prng.key(solver.options.seed), solver.options)
    b = ctx.bits
    alive_w = state0.alive
    max_np = N.tc_neighbor_max_bits(tiled, b.select_planes, alive_w, tiles_words=b.tiles_bits)
    pending_w = pack_frontier_words(pri.select >= max_np, T) & alive_w
    return dict(tiled=tiled, words=b.tiles_bits, select=b.select_planes,
                resolve=b.resolve_planes, alive_w=alive_w, pending_w=pending_w,
                key=pri.select, alive=unpack_frontier_words(alive_w, T))


def calls(x: dict) -> dict:
    """{what: (kernel call, plain call)} for the three timed launches."""
    from repro_torch.hopper import tc_neighbor_max as N

    t, w = x["tiled"], x["words"]
    return {
        "select": (lambda: N.tc_neighbor_max_bits(t, x["select"], x["alive_w"], tiles_words=w),
                   lambda: N.tc_neighbor_max_bits_plain(t, x["select"], x["alive_w"],
                                                        tiles_words=w)),
        "resolve": (lambda: N.tc_neighbor_max_bits(t, x["resolve"], x["pending_w"],
                                                   tiles_words=w, signed=True),
                    lambda: N.tc_neighbor_max_bits_plain(t, x["resolve"], x["pending_w"],
                                                         tiles_words=w, signed=True)),
        "dense": (lambda: N.tc_neighbor_max(t, x["key"], x["alive"]),
                  lambda: N.tc_neighbor_max_plain(t, x["key"], x["alive"])),
    }


def main() -> None:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    from repro_torch.graphs import grid2d
    from repro_torch.hopper import build

    out = ROOT / "build" / "nbr_max_ablation"
    this = (build.CSRC / "tc_neighbor_max.cu").read_text()
    g2 = grid2d(*cs.G2_SHAPE, device="cuda")
    if len(sys.argv) == 3 and sys.argv[1] == "--against":
        libs = build_copies(out, {"this": this, "other": pathlib.Path(sys.argv[2]).read_text()})
        for T in (16, 128):
            times = time_calls(libs, ["other", "this", "this", "other"], "tc_neighbor_max",
                               calls(round1_inputs(g2, T)))
            for name, turns in times.items():
                print(f"T={T:<3d} {turns_line(name, turns)}", flush=True)
    elif len(sys.argv) <= 2:
        src = pathlib.Path(sys.argv[1]).read_text() if len(sys.argv) == 2 else this
        print(f"form: {form_of(src, FORMS)}", flush=True)
        libs = build_copies(out, copies_of(src, FORMS))
        x = round1_inputs(g2, 16)
        times = time_calls(libs, list(libs) + list(libs)[::-1], "tc_neighbor_max", calls(x))
        print(f"G2 round-1 inputs: T=16 bitpack tiles={x['tiled'].n_tiles} "
              f"block_rows={x['tiled'].n_block_rows}", flush=True)
        for name, turns in times.items():
            print(turns_line(name, turns), flush=True)
    else:
        raise SystemExit(__doc__)
    print(cs.card_line())


if __name__ == "__main__":
    main()
