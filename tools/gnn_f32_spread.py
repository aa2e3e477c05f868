#!/usr/bin/env python3
"""How far apart two f32 runs of a GNN train step's loss and gradients
lie on their own, per arch: the yardstick for chip_smoke's step-0 check
of the card against the CPU (`GNN_CPU_TOL`).

    PYTHONPATH=src python3 tools/gnn_f32_spread.py [--nodes 600]

On the CPU, for each arch of `repro_torch.configs.GNN_ARCHS`, on the
full-graph loss (`erdos_renyi(--nodes, avg_deg 7.8)`, 64 features, 7
classes) and on the molecule loss (`GraphBatchStream(128, 30, 64, 16)`
batch 0, the molecule cell's shape), the loss and every gradient leaf:
f32 against f64, and f32 against f32 with the edges in another order (a
segment sum in another order, as a card's atomics sum it).  Prints, per
arch and loss, the largest relative error of the loss, of a leaf's
gradient norm, and of a leaf's gradient scale-normalised (max |a - b| /
max |b|), skipping non-finite leaves (EGNN's molecule gradient).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import GNN_ARCHS
from repro_torch.configs import gnn_cells as C
from repro_torch.data.pipeline import GraphBatchStream
from repro_torch.graphs.generators import erdos_renyi


def full_graph_case(n: int, gen: torch.Generator):
    g = erdos_renyi(n, avg_deg=7.8, seed=0, device="cpu")
    feats = torch.randn((n, 64), generator=gen)
    coords = torch.randn((n, 3), generator=gen)
    labels = torch.randint(0, 7, (n,), generator=gen, dtype=torch.int32)
    perm = torch.randperm(g.senders.numel(), generator=gen)

    def args(dtype, permuted: bool):
        s, r, m = g.senders, g.receivers, g.edge_mask
        if permuted:
            s, r, m = s[perm], r[perm], m[perm]
        return feats.to(dtype), coords.to(dtype), s, r, m, labels
    return 64, 7, C.full_graph_loss, args


def molecule_case(gen: torch.Generator):
    batch = [torch.from_numpy(x) for x in GraphBatchStream(128, 30, 64, 16, seed=0).batch_at(0)]
    perm = torch.randperm(64, generator=gen)

    def args(dtype, permuted: bool):
        feats, coords, s, r, m, energy = batch
        if permuted:
            s, r, m = s[:, perm], r[:, perm], m[:, perm]
        return feats.to(dtype), coords.to(dtype), s, r, m, energy.to(dtype)
    return 16, 1, C.molecule_loss, args


def spread(a, b) -> tuple:
    """(loss, leaf norm, leaf scale-normalised) relative errors of a vs b."""
    (la, ga), (lb, gb) = a, b
    loss = abs(float(la) - float(lb)) / abs(float(lb))
    norm = elem = 0.0
    for k, want in gb.items():
        got, want = ga[k].double(), want.double()
        if not bool(torch.isfinite(want).all()) or float(want.abs().max()) == 0.0:
            continue
        norm = max(norm, abs(float(got.norm()) - float(want.norm())) / float(want.norm()))
        elem = max(elem, float((got - want).abs().max() / want.abs().max()))
    return loss, norm, elem


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=600)
    opts = ap.parse_args()
    gen = torch.Generator().manual_seed(0)
    cases = {"full_graph": full_graph_case(opts.nodes, gen), "molecule": molecule_case(gen)}
    print("loss       arch    f32 vs f64 (loss, norm, scale)   f32 vs f32 reordered")
    for case, (d_in, n_out, loss_fn, args) in cases.items():
        for a in GNN_ARCHS.values():
            state = a.init(d_in, n_out, seed=0, device="cpu").state_dict()
            runs = {}
            for dtype, permuted in ((torch.float64, False), (torch.float32, False),
                                    (torch.float32, True)):
                model = a.init(d_in, n_out, seed=0, device="cpu")
                model.load_state_dict(state)
                model.to(dtype)
                x = args(dtype, permuted)
                runs[dtype, permuted] = C.loss_and_grads(
                    lambda p: loss_fn(a, model, p, *x), C.train_params(model))
            f32 = runs[torch.float32, False]
            vs64 = spread(f32, runs[torch.float64, False])
            vs32 = spread(runs[torch.float32, True], f32)
            print(f"{case:10s} {a.arch_id:7s} " + " ".join(f"{x:.3g}" for x in vs64)
                  + "   " + " ".join(f"{x:.3g}" for x in vs32), flush=True)


if __name__ == "__main__":
    main()
