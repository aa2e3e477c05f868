#!/usr/bin/env python3
"""Where the embedding-bag kernels' time goes, on one CUDA card.

    python3 tools/bag_ablation.py [SOURCE]
    python3 tools/bag_ablation.py --against OTHER/embedding_bag.cu
    python3 tools/bag_ablation.py --backward [SOURCE]
    python3 tools/bag_ablation.py --backward --against OTHER/embedding_bag.cu

The forward.  Builds SOURCE (default `src/repro_torch/csrc/embedding_bag.cu`
as it stands) and copies of it with one part of the work taken out (the
text of each part is replaced; the copies compute wrong sums and are only
timed):

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

The backward (--backward), at DeepFM's train_batch slots (B = 65,536 of K
= 39 into the full CONFIG's 33,889,984 rows, ClickStream seed 0, random
gradients from seed 23): the slot plan alone (`sort_slots`, CUB in
csrc/slot_sort.cu) and a copy of it that only sorts (no run-length
encoding, no scan of the run starts), then SOURCE and its copies

  no segments  the segment sums are not launched
  no sums      nor the run sums: each CTA's runs and the dense write
  no dense     the dense write is not launched: the segment and run sums
  writes only  neither the sums nor any run's copy: the dense write stores
               a tile of zeros, what the bound's write costs

each timed, in the order listed and back, at the step's two launches on
one shared plan (D = 10 with the gather term's (B, K, 10) gradient, and
D = 1).  With --against, OTHER's backward runs through OTHER's own wrapper
(`OTHER/../hopper/embedding_bag.py`, loaded beside this one; it may take
another C interface and sort on its own), other, this, this, other: D = 10
and D = 1, each launch sorting on its own, both held equal to this
package's plain version (the summation order has not changed), and the
step's table gradients: this form's one plan and two launches against
the earlier form's two launches, the gather's `index_put_` with
accumulate and the add of the two (V, 10) gradients, as autograd ran
them before the gather's gradient joined the launch.  To time the
parent commit, unpack it under build/ (ignored by git) and pass its
source:

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
    python3 tools/bag_ablation.py --backward --against build/parent/src/repro_torch/csrc/embedding_bag.cu
"""
from __future__ import annotations

import importlib.util
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


# the backward's parts, in the one form that has them: the segment sums,
# the run sums, the dense write, and the dense write's copies of the run
# sums
SEGMENTS = ("  bag_backward_segments<WEIGHTED, EXTRA><<<",
            "  if (false) bag_backward_segments<WEIGHTED, EXTRA><<<")
SUMS = ("  bag_backward_runs<<<", "  if (false) bag_backward_runs<<<")
DENSE = ("  bag_backward_dense<<<", "  if (false) bag_backward_dense<<<")
RUNS = ("for (int64_t k = k0 + grp; k < k1; k += NG)", "for (int64_t k = k1; k < k1; k += NG)")
# the slot plan's parts (csrc/slot_sort.cu): without the run-length
# encoding and the scan of the run starts, the sort alone
SORT_FORMS = {
    "cub": {
        "sort only": [
            ("err = cub::DeviceRunLengthEncode::Encode(temp, need[1], rows, run_rows, scratch, "
             "n_runs, n, s);", "err = cudaSuccess;"),
            ("err = cub::DeviceScan::ExclusiveSum(temp, need[2], scratch, starts, n + 1, s);",
             "err = cudaSuccess;")],
    },
}
BACKWARD_FORMS = {
    "segments and a dense write": {
        "no segments": [SEGMENTS],
        "no sums": [SEGMENTS, SUMS],
        "no dense": [DENSE],
        "writes only": [SEGMENTS, SUMS, RUNS],
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


def train_batch_slots():
    """train_batch's (65,536, 39) int32 rows into the full CONFIG's table
    (ClickStream seed 0), its row count, and random gradients from seed 23:
    grad_out at D = 10 and D = 1 and the gather's (B, K, 10)."""
    import torch
    from repro_torch.configs.deepfm import CONFIG, FIELD_VOCABS, SHAPES
    from repro_torch.data.pipeline import ClickStream

    fields = ClickStream(FIELD_VOCABS, SHAPES["train_batch"]["batch"], seed=0).batch_at(0)[0]
    flat = torch.from_numpy(fields).cuda() + CONFIG.offsets.cuda()[None, :]
    (B, K), D = flat.shape, CONFIG.embed_dim
    gen = torch.Generator(device="cuda").manual_seed(23)
    g10 = torch.randn((B, D), generator=gen, device="cuda")
    g1 = torch.randn((B, 1), generator=gen, device="cuda")
    x = torch.randn((B, K, D), generator=gen, device="cuda")
    return flat, CONFIG.total_vocab, g10, g1, x


def backward_parts(src: str, out: pathlib.Path) -> dict:
    """The slot plan alone, then SOURCE and its copies at the step's two
    launches on one plan."""
    import torch

    import chip_smoke as cs
    from repro_torch.hopper import build
    from repro_torch.hopper import embedding_bag as E

    flat, V, g10, g1, x = train_batch_slots()
    print(f"form: {form_of(src, BACKWARD_FORMS)}", flush=True)
    print(f"sort_slots of {flat.numel()} slots into {V} rows: "
          f"{cs.time_ms(lambda: E.sort_slots(flat, V)):.4f} ms warm, "
          f"{cs.time_ms(lambda: E.sort_slots(flat, V), cold=True):.4f} ms cold; a stable "
          f"torch.sort {cs.time_ms(lambda: torch.sort(flat.reshape(-1), stable=True), cold=True):.4f}"
          f" ms cold", flush=True)
    sort_src = (build.CSRC / "slot_sort.cu").read_text()
    sort_libs = build_copies(out / "slot_sort", {
        f"plan {name}": text for name, text in copies_of(sort_src, SORT_FORMS).items()})

    def plan_arrays(make):
        slots = make(flat, V)
        return slots.rows, slots.order, slots.n_runs

    times = time_calls(sort_libs, list(sort_libs) + list(sort_libs)[::-1], "slot_sort",
                       {"plan": (lambda: plan_arrays(E.sort_slots),
                                 lambda: plan_arrays(E.sort_slots_plain))})
    libs = build_copies(out, copies_of(src, BACKWARD_FORMS))
    plan = E.sort_slots(flat, V)
    fns = {
        "D=10 gather term": (
            lambda: E.embedding_bag_backward(g10, flat, None, V, extra=x, slots=plan),
            lambda: E.embedding_bag_backward_plain(g10, flat, None, V, extra=x)),
        "D=1": (lambda: E.embedding_bag_backward(g1, flat, None, V, slots=plan),
                lambda: E.embedding_bag_backward_plain(g1, flat, None, V)),
    }
    times.update(time_calls(libs, list(libs) + list(libs)[::-1], "embedding_bag", fns))
    return times


def backward_against(this: str, other_cu: pathlib.Path, out: pathlib.Path) -> dict:
    """This backward and OTHER's, each through its own wrapper, other, this,
    this, other: D = 10 and D = 1 sorting on their own, and the step's
    table gradients."""
    import torch

    import chip_smoke as cs
    from repro_torch.hopper import build
    from repro_torch.hopper import embedding_bag as E

    spec = importlib.util.spec_from_file_location(
        "other_embedding_bag", other_cu.parents[1] / "hopper" / "embedding_bag.py")
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    flat, V, g10, g1, x = train_batch_slots()
    flat64 = flat.long()
    libs = build_copies(out, {"this": this, "other": other_cu.read_text()})
    want = {"D=10": E.embedding_bag_backward_plain(g10, flat, None, V),
            "D=1": E.embedding_bag_backward_plain(g1, flat, None, V)}

    def this_step():
        plan = E.SlotPlan(flat, V)
        return (E.embedding_bag_backward(g10, flat, None, V, extra=x, slots=plan.sorted()),
                E.embedding_bag_backward(g1, flat, None, V, slots=plan.sorted()))

    def other_step():      # as autograd ran the step before the gather term joined
        bag = other.embedding_bag_backward(g10, flat, None, V)
        gather = torch.zeros_like(bag).index_put_((flat64,), x, accumulate=True)
        return bag + gather, other.embedding_bag_backward(g1, flat, None, V)

    wrappers = {"this": (E, this_step), "other": (other, other_step)}
    load = build.library
    times = {}
    try:
        for name in ("other", "this", "this", "other"):
            build.library = lambda n, lib=libs[name]: lib if n == "embedding_bag" else load(n)
            W, step = wrappers[name]
            fns = {"D=10": lambda W=W: W.embedding_bag_backward(g10, flat, None, V),
                   "D=1": lambda W=W: W.embedding_bag_backward(g1, flat, None, V),
                   "step tables": step}
            if name not in times:
                for what in want:
                    cs.check(torch.equal(fns[what](), want[what]),
                             f"the {name} backward differs from the plain version ({what})")
            times.setdefault(name, []).append(
                {k: v for what, fn in fns.items()
                 for k, v in ((what, cs.time_ms(fn)), (f"{what} cold", cs.time_ms(fn, cold=True)))})
    finally:
        build.library = load
    return times


def main() -> None:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        cs.fail("needs a CUDA card")
    from repro_torch.hopper import build

    out = ROOT / "build" / "bag_ablation"
    this = (build.CSRC / "embedding_bag.cu").read_text()
    if sys.argv[1:2] == ["--backward"]:
        args = sys.argv[2:]
        if len(args) == 2 and args[0] == "--against":
            times = backward_against(this, pathlib.Path(args[1]), out)
        elif len(args) <= 1:
            times = backward_parts(pathlib.Path(args[0]).read_text() if args else this, out)
        else:
            raise SystemExit(__doc__)
        print("train_batch slots: B=65536 K=39 rows=33889984", flush=True)
        for name, turns in times.items():
            print(turns_line(name, turns), flush=True)
        print(cs.card_line())
        return
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
