"""tcmis — the paper's own configuration: sharded TC-MIS over the eight
SuiteSparse graphs of Table 1, at full |V| / |E| (counterpart of
`repro.configs.tcmis`).

Tile counts: a full-scale graph is never built; its BSR size is
extrapolated from the measured block occupancy of the structurally
matched reduced-scale stand-in, n_tiles ≈ ratio · min(E, nb²), the ratio
measured on the stand-in (cached; the dry run measures it on its
`--device` first, `measure_occupancy`).  Tile size: the largest
T ∈ {128, 64, 32, 16} whose estimated BSR fits a per-device budget
(`api.plan.fit_tile_size`), as the reference picks it.

A cell counts ONE round of the sharded loop (`core.distributed.mis_round`,
which `build_distributed_mis` runs once a round), as the reference's MIS
roofline is per round: rank 0's slab of fake (nt_pad, T, T) int8 tiles at
the full n (nt_pad: the estimated tiles a rank with 15 % headroom, to a
multiple of 8), the keys and the gathered alive set whole, the frontier
gathered as packed words (`DistConfig(bitpack=True)`), the split SpMV
`hopper.tc_spmv` on the slab (its fake branch).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, Tuple

import torch

from repro_torch.api.plan import DEFAULT_TILE_BUDGET, fit_tile_size
from repro_torch.configs.common import ArchDef, Cell, register
from repro_torch.device import DeviceLike
from repro_torch.graphs.generators import GRAPH_SUITE

# Table 1 edge counts (stored/directed), used for full-scale extrapolation.
TABLE1_E = {
    "G1": 2_350_000, "G2": 2_930_000, "G3": 3_000_000, "G4": 9_540_000,
    "G5": 9_700_000, "G6": 14_440_000, "G7": 68_990_000, "G8": 182_080_000,
}

# 512 MiB of BSR payload per device — the shared auto-T budget (api.plan)
PER_CHIP_TILE_BUDGET = DEFAULT_TILE_BUDGET
DRYRUN_LANES = 8                      # lanes carrying data (C, alive, spares)

RCM = False  # True: estimate with RCM locality reordering

_OCCUPANCY: Dict[Tuple[str, int, bool], float] = {}


@lru_cache(maxsize=None)
def _standin(paper_id: str, rcm: bool, device: str):
    """The reduced-scale stand-in on `device` and its edges' (senders,
    receivers), RCM-relabelled with `rcm`."""
    g = GRAPH_SUITE[paper_id].reduced(seed=0, device=device)
    s, r = g.senders[: g.n_edges].long(), g.receivers[: g.n_edges].long()
    if rcm:
        from repro_torch.core.tiling import rcm_ordering

        perm = torch.as_tensor(rcm_ordering(g), device=s.device)   # perm[new] = old
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(g.n_nodes, device=s.device)
        s, r = inv[s], inv[r]
    return g, s, r


def _occupancy_ratio(paper_id: str, tile_size: int, rcm: bool = False,
                     device: DeviceLike = "cuda") -> float:
    """Measured block occupancy of the reduced-scale stand-in: its tiles
    (the distinct (row, column) blocks of its edges, counted on `device`)
    over min(E, nb²).  Cached by (paper_id, tile_size, rcm)."""
    key = (paper_id, int(tile_size), bool(rcm))
    if key not in _OCCUPANCY:
        g, s, r = _standin(paper_id, bool(rcm), str(device))
        nb = -(-g.n_nodes // tile_size)
        n_tiles = max(int(torch.unique((s // tile_size) * nb + r // tile_size).numel()), 1)
        _OCCUPANCY[key] = n_tiles / max(min(g.n_edges, nb * nb), 1)
    return _OCCUPANCY[key]


def measure_occupancy(device: DeviceLike = "cuda") -> None:
    """Measure (and cache) every stand-in's occupancy at every candidate T
    on `device`."""
    from repro_torch.api.plan import TILE_CANDIDATES

    for paper_id in GRAPH_SUITE:
        for T in TILE_CANDIDATES:
            _occupancy_ratio(paper_id, T, RCM, device)


def estimate_tiles(paper_id: str, tile_size: int) -> int:
    spec = GRAPH_SUITE[paper_id]
    nb = -(-spec.n_full // tile_size)
    e_dir = TABLE1_E[paper_id]
    return int(_occupancy_ratio(paper_id, tile_size, RCM) * min(e_dir, nb * nb)) + 1


def choose_tile_size(paper_id: str, n_chips: int) -> int:
    """Largest T whose estimated BSR fits the per-device budget (the API's
    `fit_tile_size` loop, on the stand-in's measured occupancy)."""
    return fit_tile_size(
        lambda T: estimate_tiles(paper_id, T) * T * T / n_chips,
        budget=PER_CHIP_TILE_BUDGET,
    )


def round_step(mesh, *, n_nodes: int, tile_size: int, rows_per_shard: int, nt_pad: int,
               n_tiles: int):
    """(step, inputs, specs) of one sharded round on `mesh` (its flat group):
    this rank's slab of (nt_pad, T, T) int8 tiles, `n_tiles` of them real,
    `rows_per_shard` block-rows over every rank's block-columns, the keys,
    the gathered alive set, this rank's members and the (n_padded, L) RHS
    buffer; the step returns (alive_g, in_mis_l) after the round, the
    frontier gathered as packed words.  Inputs are empty tensors on the
    mesh's device: fake under the dry run's mode."""
    from repro_torch.core.distributed import gather_bool, mis_round
    from repro_torch.core.tiling import BlockTiledGraph
    from repro_torch.dist.graph import _flat_group
    from repro_torch.dist.sharding import P, mesh_device

    dev = mesh_device(mesh)
    T, rps, n_chips = tile_size, rows_per_shard, mesh.size()
    n_padded = n_chips * rps * T
    group = _flat_group(mesh)

    def gather(x_local):
        return gather_bool(x_local, T, bitpack=True, group=group)

    def step(tiles, tile_rows, tile_cols, row_starts, select, resolve, alive_g, in_mis_l, rhs):
        slab = BlockTiledGraph(tiles=tiles, tile_rows=tile_rows, tile_cols=tile_cols,
                               row_starts=row_starts, n_tiles=n_tiles, n_nodes=n_nodes,
                               tile_size=T, n_block_rows=rps, n_block_cols=rps * n_chips,
                               storage="int8")
        return mis_round(slab, gather, select, resolve, alive_g, in_mis_l, rhs, off=0,
                         two_pass=True)

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    inputs = (torch.empty((nt_pad, T, T), dtype=torch.int8, device=dev), i32(nt_pad),
              i32(nt_pad), i32(rps + 1), i32(n_padded), i32(n_padded),
              torch.empty((n_padded,), dtype=torch.bool, device=dev),
              torch.empty((rps * T,), dtype=torch.bool, device=dev),
              torch.empty((n_padded, DRYRUN_LANES), dtype=torch.float32, device=dev))
    flat = tuple(mesh.mesh_dim_names)
    specs = (P(flat, None, None), P(flat), P(flat), P(flat), P(), P(), P(), P(flat), P())
    return step, inputs, specs


def _mis_cell(paper_id: str) -> Cell:
    spec = GRAPH_SUITE[paper_id]

    def build(mesh, variant: str = "memory"):
        n_chips = mesh.size()
        T = choose_tile_size(paper_id, n_chips)
        est_tiles = estimate_tiles(paper_id, T)
        nb = -(-spec.n_full // T)
        # per-shard tile budget with 15% imbalance headroom, lane-aligned
        nt_pad = (int(est_tiles / n_chips * 1.15) + 8) // 8 * 8
        return round_step(mesh, n_nodes=spec.n_full, tile_size=T,
                          rows_per_shard=-(-nb // n_chips), nt_pad=nt_pad,
                          n_tiles=min(nt_pad, -(-est_tiles // n_chips)))

    # PER-ROUND useful work: one SpMV (2E MACs) + one neighbour-max (E cmp).
    e_dir = TABLE1_E[paper_id]
    return Cell(
        arch="tcmis", shape=paper_id, kind="mis", build=build,
        model_flops=3.0 * e_dir,
        note=f"{spec.name}: |V|={spec.n_full:,} |E|={e_dir:,}",
    )


def _smoke(device: DeviceLike = "cuda") -> None:
    """Reduced-scale TC-MIS through the `Solver` front door: the oracle
    engine and the fused engine (the Hopper kernel on the card) must return
    the same valid set."""
    from repro_torch.api import Plan, Solver, SolveOptions
    from repro_torch.core import is_valid_mis
    from repro_torch.graphs.generators import erdos_renyi

    g = erdos_renyi(500, avg_deg=6.0, seed=0, device=device)
    plan = Plan.build(g, tile_size=32)   # one plan serves both engines
    ref = Solver(SolveOptions(heuristic="h3", engine="tiled_ref"), device=g.device).solve(plan)
    in_mis = torch.as_tensor(ref.in_mis, device=g.device)
    if not ref.converged or not is_valid_mis(g, in_mis):
        raise AssertionError("tcmis smoke: tiled_ref did not give a valid MIS")
    fused = Solver(SolveOptions(heuristic="h3", engine="fused_pallas"),
                   device=g.device).solve(plan)
    if not bool((torch.as_tensor(fused.in_mis, device=g.device) == in_mis).all()):
        raise AssertionError("tcmis smoke: the fused engine's set differs from tiled_ref's")


ARCH = register(ArchDef(
    arch_id="tcmis", family="mis",
    cells={gid: _mis_cell(gid) for gid in GRAPH_SUITE},
    smoke=_smoke,
    config=None,
))
