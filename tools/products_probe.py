#!/usr/bin/env python3
"""What one card holds of ogb_products' full-graph train step, and how far
the step lies from itself when it sums in other orders:

    python3 tools/products_probe.py [--sizes] [--spread] [--device cuda|cpu]

--sizes   for each arch and fraction of SIZES (of ogb_products' 2,449,029
          vertices, at its widths and average degree: `gnn_cells.
          products_inputs`), the step without a mesh twice from one state:
          each run's ms (CUDA events) and the peak GiB, or "out of memory";
--spread  gin-tu at SPREAD_FRACTION, the step's loss, gradient norm and
          every leaf of m and sqrt(v) (relative in L2, the worst leaf named)
          against a first run, for: the same step again; the graph
          relabelled (vertices and edges in another order); its GEMMs on
          cuBLASLt (the card only); and its MLPs' GEMMs on row blocks of a
          quarter (`F.linear` patched: the shapes a card of four computes).

With `--device cpu` the vertex counts are cut to CPU sizes (SIZES'
fractions of CPU_NODES).  Prints one line per run and the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import gc
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
SIZES = {"pna": (1 / 8, 1 / 16), "egnn": (1 / 8, 1 / 16), "mace": (1 / 64, 1 / 128)}
SPREAD_FRACTION = 1 / 4
CPU_NODES = 4096


def nodes(fraction: float, device: str) -> int:
    from repro_torch.configs import gnn_cells as C

    return C.products_nodes(fraction) if device == "cuda" else int(fraction * CPU_NODES)


def ms_of(fn, device: str):
    """(fn(), ms): CUDA events on the card, the host clock on the CPU."""
    import time

    import torch

    if device != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def sizes(device: str) -> None:
    import torch
    from repro_torch.configs import GNN_ARCHS
    from repro_torch.configs import gnn_cells as C
    from repro_torch.train import adamw_init

    for arch, fractions in SIZES.items():
        a = GNN_ARCHS[arch]
        for f in fractions:
            n = nodes(f, device)
            s, r, m, feats, coords, labels = C.products_inputs(n, seed=0, device=device)
            edges = [x.to(device) for x in (s, r, m)]
            model = a.init(feats.shape[1], C.GNN_SHAPES["ogb_products"]["n_out"], seed=0,
                           device=device)
            params = C.train_params(model)
            opt = adamw_init(params)
            if device == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            try:
                took = [ms_of(lambda: C.full_graph_step(a, model, params, opt, feats, coords,
                                                        *edges, labels), device)[1]
                        for _ in range(2)]
                peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else 0.0
                said = f"ms {took[0]:.3f}, {took[1]:.3f}; peak {peak:.3f} GiB"
            except torch.cuda.OutOfMemoryError:
                said = "out of memory"
            print(f"[sizes] {arch} 1/{round(1 / f)}: {n:,} vertices, {s.shape[0]:,} half-edges: "
                  f"{said}", flush=True)
            del s, r, m, feats, coords, labels, edges, model, params, opt
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()


def spread(device: str) -> None:
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(ROOT / "tools"))
    import sharded_train_ranks as T
    from repro_torch.configs import GNN_ARCHS
    from repro_torch.configs import gnn_cells as C
    from repro_torch.train import adamw_init

    n = nodes(SPREAD_FRACTION, device)
    s, r, m, feats, coords, labels = C.products_inputs(n, seed=0, device=device)
    edges = [x.to(device) for x in (s, r, m)]
    a = GNN_ARCHS["gin-tu"]
    model = a.init(feats.shape[1], C.GNN_SHAPES["ogb_products"]["n_out"], seed=0, device=device)
    params = C.train_params(model)
    plain = [feats, coords, *edges, labels]

    def run(inputs):
        with T.GNNNorms() as rec:
            _, o, loss = C.full_graph_step(a, model, params, adamw_init(params), *inputs)
            return T.gnn_groups(loss, o, rec.grad_norms[-1])

    first = run(plain)
    runs = {"again": run(plain), "relabelled": run(T.relabelled(edges, (feats, coords, labels),
                                                                  0))}
    if device == "cuda":
        blas = torch.backends.cuda.preferred_blas_library()
        torch.backends.cuda.preferred_blas_library("cublaslt")
        try:
            runs["cuBLASLt"] = run(plain)
        finally:
            torch.backends.cuda.preferred_blas_library(blas)
    linear = F.linear

    def quarter_rows(x, w, b=None):
        if x.dim() != 2 or x.shape[0] < 4:
            return linear(x, w, b)
        k = -(-x.shape[0] // 4)
        return torch.cat([linear(x[i:i + k], w, b) for i in range(0, x.shape[0], k)])

    F.linear = quarter_rows
    try:
        runs["GEMMs on quarter row blocks"] = run(plain)
    finally:
        F.linear = linear
    for name, got in runs.items():
        errs, worst = T.gnn_errs(got, first)
        print(f"[spread] gin-tu 1/{round(1 / SPREAD_FRACTION)} ({n:,} vertices, "
              f"{s.shape[0]:,} half-edges), {name} against the first run: "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + f"; worst leaf {worst['m']}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", action="store_true")
    ap.add_argument("--spread", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("no CUDA card: pass --device cpu")
        torch.backends.cuda.matmul.allow_tf32 = False
        sys.path.insert(0, str(ROOT / "tools"))
        from sharded_train_ranks import card_line

        print(f"card {card_line()}", flush=True)
    if args.sizes:
        sizes(args.device)
    if args.spread:
        spread(args.device)


if __name__ == "__main__":
    main()
