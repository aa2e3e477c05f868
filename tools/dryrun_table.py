"""Print the dry run's records as one markdown table: per cell × mesh the
status, GiB per device against a card's 80, the dominant roofline term,
the step bound and the mfu (computed from the H100 data sheet's
constants, not measured).

    PYTHONPATH=src python3 tools/dryrun_table.py experiments/dryrun_torch

Rows follow `repro_torch.configs.REGISTRY`'s order.
"""
import glob
import json
import os
import sys

CARD_GIB = 80


def _cell(r) -> str:
    """One mesh's entry: GiB a device, dominant term, step bound ms, mfu."""
    if r is None:
        return "—"
    if r["status"] != "ok":
        return r["status"]
    gib = r["memory"]["total_per_device"] / 2 ** 30
    roof = r["roofline"]
    affine = " (L-affine)" if r["memory_method"].startswith("affine") else ""
    over = " **over**" if gib > CARD_GIB else ""
    return (f"{gib:.2f}{over}{affine}, {roof['dominant']}, {roof['step_time_s'] * 1e3:.4g}, "
            f"{roof['mfu']:.4f}")


def main(out_dir: str) -> int:
    recs = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    from repro_torch.configs import REGISTRY

    cells = [(a, s) for a, d in REGISTRY.items() for s in d.cells
             if (a, s, "single") in recs or (a, s, "multi") in recs]
    print("| arch | shape | (16, 16): GiB / device, dominant, step bound ms, mfu "
          "| (2, 16, 16): the same | kernels (launches a step) |")
    print("|---|---|---|---|---|")
    for arch, shape in cells:
        one, two = recs.get((arch, shape, "single")), recs.get((arch, shape, "multi"))
        first = one or two
        if first["status"] == "skipped":
            print(f"| {arch} | {shape} | skipped: {first['skip_reason'][:48]}… | skipped | |")
            continue
        kern = ", ".join(f"{k} {v['launches']}"
                         for k, v in sorted(first.get("kernels", {}).items()))
        print(f"| {arch} | {shape} | {_cell(one)} | {_cell(two)} | {kern or '—'} |")
    rs = list(recs.values())
    n_ok = sum(r["status"] == "ok" for r in rs)
    n_skip = sum(r["status"] == "skipped" for r in rs)
    over = sum(r["status"] == "ok" and r["memory"]["total_per_device"] > CARD_GIB * 2 ** 30
               for r in rs)
    print(f"\n{len(rs)} records: {n_ok} ok ({over} over {CARD_GIB} GiB a device), "
          f"{n_skip} skipped, {len(rs) - n_ok - n_skip} failed")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun_torch"))
