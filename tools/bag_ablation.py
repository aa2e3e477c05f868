#!/usr/bin/env python3
"""Where the embedding-bag kernel's time goes, on one CUDA card.

    python3 tools/bag_ablation.py [SOURCE]
    python3 tools/bag_ablation.py --against OTHER/embedding_bag.cu

Builds SOURCE (default `src/repro_torch/csrc/embedding_bag.cu` as it
stands) and copies of it with one part of the work taken out (the text of
each part is replaced; the copies compute wrong sums and are only timed):

  no index   the index loads: slot k of bag b reads row k·2^16 + a hash of
             b below 2^16, so the 39 slots touch about as many distinct
             rows (2.5 M) as serve_bulk's fields do
  no row     the table-row loads: each slot adds a number made from its
             index, so the index loads stay
  both out   neither: what is left is the loop, the sums and the stores

The replaced texts are held per form of the source (a thread per output
element, the earlier form; a lane group per bag over indices staged in
shared memory, the form that replaced it); a source must hold every text
of one form exactly once, or the tool stops.  Each copy is timed (CUDA
events, warm and cold, as chip_smoke.py's timing phase) at DeepFM's
serve_bulk bags (B = 262,144 bags of K = 39 fields into 33,889,984
rows, the full CONFIG's tables drawn on the card from seed 0, fields
from ClickStream seed 0): the D = 10 embedding bag and the D = 1
first-order bag, in the order listed and back; the full kernel is first
held equal to its plain version.  Prints one line per copy, then the card's name and power limit.

With --against, it builds this kernel and another source of the same C
interface (an earlier commit's, say) and times both, other, this, this,
other, at the serve_bulk bags: D = 1 and D = 10 on the f32 tables, D = 10
with random weights, and D = 10 on a bf16 copy of the table, each held
equal to the plain version first.
"""
from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from spmv_ablation import build_copies, copies_of, form_of, time_calls, turns_line  # noqa: E402

# the lane-group form's texts: the index staging, the staged index read,
# the row load
STAGE_IDX = ("stage_slots(reinterpret_cast<const uint32_t*>(idx), b0, nb, K, k0, kc, KS, "
             "idx_buf)")
ROW = "const int64_t row = idx_s[k + j];"
HASH_ROW = ("const int64_t row = (int64_t)(k0 + k + j) << 16 | "
            "((uint32_t)(b0 + bag) * 0x9E3779B9u) >> 16;")
LOAD = "v[j] = load_vec<T, VEC>(table + row * D + e);"
SPLAT = "for (int i = 0; i < VEC; ++i) v[j].x[i] = (float)(row + e);"
# {form: {copy: [(old text, new text), ...]}}
FORMS = {
    "thread per element": {
        "no index": [("const float v = as_f32(table[(int64_t)ib[k] * D + d]);",
                      "const float v = as_f32(table[((int64_t)k << 16 | "
                      "((uint32_t)b * 0x9E3779B9u) >> 16) * D + d]);")],
        "no row": [("const float v = as_f32(table[(int64_t)ib[k] * D + d]);",
                    "const float v = (float)(ib[k] + d);")],
        "both out": [("const float v = as_f32(table[(int64_t)ib[k] * D + d]);",
                      "const float v = (float)((int)b + k + d);")],
    },
    "lane group per bag": {
        "no index": [(STAGE_IDX, "0"), (ROW, HASH_ROW)],
        "no row": [(LOAD, SPLAT)],
        "both out": [(STAGE_IDX, "0"), (ROW, HASH_ROW), (LOAD, SPLAT)],
    },
}


def serve_bulk_bags():
    """The full CONFIG's tables on the card (seed 0) and serve_bulk's
    (262,144, 39) int32 rows into them."""
    import torch
    from repro_torch.configs.deepfm import CONFIG, FIELD_VOCABS, SHAPES
    from repro_torch.data.pipeline import ClickStream
    from repro_torch.models.deepfm import DeepFM

    model = DeepFM(CONFIG, seed=0, device="cuda")
    fields = ClickStream(FIELD_VOCABS, SHAPES["serve_bulk"]["batch"], seed=0).batch_at(0)[0]
    flat = torch.from_numpy(fields).cuda() + model.offsets[None, :]
    return model.embed.detach(), model.linear.detach().view(-1, 1), flat


def calls(cases: dict) -> dict:
    """{what: (kernel call, plain call)} for {what: (table, idx, weights)}."""
    from repro_torch.hopper import embedding_bag as E

    return {what: (lambda a=args: E.embedding_bag(*a), lambda a=args: E.embedding_bag_plain(*a))
            for what, args in cases.items()}


def main() -> None:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    from repro_torch.hopper import build

    out = ROOT / "build" / "bag_ablation"
    this = (build.CSRC / "embedding_bag.cu").read_text()
    embed, linear, flat = serve_bulk_bags()
    with torch.inference_mode():
        if len(sys.argv) == 3 and sys.argv[1] == "--against":
            libs = build_copies(out, {"this": this,
                                      "other": pathlib.Path(sys.argv[2]).read_text()})
            gen = torch.Generator(device="cuda").manual_seed(13)
            w = torch.rand(flat.shape, generator=gen, device="cuda")
            cases = {"D=1": (linear, flat, None), "D=10": (embed, flat, None),
                     "D=10 weighted": (embed, flat, w),
                     "D=10 bf16": (embed.to(torch.bfloat16), flat, None)}
            times = time_calls(libs, ["other", "this", "this", "other"], "embedding_bag",
                               calls(cases))
        elif len(sys.argv) <= 2:
            src = pathlib.Path(sys.argv[1]).read_text() if len(sys.argv) == 2 else this
            print(f"form: {form_of(src, FORMS)}", flush=True)
            libs = build_copies(out, copies_of(src, FORMS))
            cases = {"D=10": (embed, flat, None), "D=1": (linear, flat, None)}
            times = time_calls(libs, list(libs) + list(libs)[::-1], "embedding_bag",
                               calls(cases))
        else:
            raise SystemExit(__doc__)
    print(f"serve_bulk bags: B={flat.shape[0]} K={flat.shape[1]} rows={embed.shape[0]}",
          flush=True)
    for name, turns in times.items():
        print(turns_line(name, turns), flush=True)
    print(cs.card_line())


if __name__ == "__main__":
    main()
