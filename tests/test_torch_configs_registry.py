"""The port's cell registry (`repro_torch.configs.REGISTRY`) against the
reference's (`repro.configs.REGISTRY`), on the CPU: every arch's family,
cell keys and, per cell, kind, analytic model FLOPs, skip reason, note and
extrapolation plan; `ASSIGNED_ARCHS`; the dry run's LM helpers
(`_needs_fsdp` on six meshes, `_with_stack_layers`) per arch; and the
paper suite's tile estimates (`configs.tcmis.estimate_tiles`,
`choose_tile_size`) on 1, 256 and 512 devices, the port's stand-ins on the
CPU.  Nothing builds a step here (tests/test_torch_dryrun.py does)."""
import math

import pytest
from jax.sharding import AbstractMesh

from repro.configs import ASSIGNED_ARCHS as REF_ASSIGNED
from repro.configs import REGISTRY as REF
from repro.configs import common as RC
from repro.configs import tcmis as RT
from repro_torch.api.plan import TILE_CANDIDATES
from repro_torch.configs import ASSIGNED_ARCHS, REGISTRY
from repro_torch.configs import common as C
from repro_torch.configs import tcmis as PT
from repro_torch.dist.sharding import MeshShape

MESHES = [
    (("data", "model"), (1, 1)),
    (("data", "model"), (4, 1)),
    (("data", "model"), (2, 4)),
    (("data", "model"), (1, 8)),
    (("data", "model"), (16, 16)),
    (("pod", "data", "model"), (2, 16, 16)),
]
LM = [a for a, d in REF.items() if d.family == "lm"]


def test_registry_holds_the_references_archs_in_its_order():
    assert list(REGISTRY) == list(REF)
    assert ASSIGNED_ARCHS == REF_ASSIGNED
    assert sum(len(a.cells) for a in REGISTRY.values()) == 48


@pytest.mark.parametrize("arch", list(REF))
def test_cells_match_the_reference(arch):
    ref, port = REF[arch], REGISTRY[arch]
    assert port.arch_id == ref.arch_id and port.family == ref.family
    assert list(port.cells) == list(ref.cells)
    for shape, rc in ref.cells.items():
        pc = port.cells[shape]
        assert (pc.arch, pc.shape, pc.kind) == (rc.arch, rc.shape, rc.kind), shape
        assert math.isclose(pc.model_flops, rc.model_flops, rel_tol=1e-12), shape
        assert pc.skip_reason == rc.skip_reason, shape
        assert pc.extrapolate == rc.extrapolate, shape
        assert pc.note == rc.note, shape


@pytest.mark.parametrize("arch", LM)
def test_lm_helpers_match_the_reference(arch):
    ref_cfg, cfg = REF[arch].config, REGISTRY[arch].config
    for names, sizes in MESHES:
        assert C._needs_fsdp(cfg, MeshShape(names, sizes)) == \
            RC._needs_fsdp(ref_cfg, AbstractMesh(sizes, names)), (names, sizes)
    for k in (2, 4):
        assert C._with_stack_layers(cfg, k).n_layers == \
            RC._with_stack_layers(ref_cfg, k).n_layers
    assert C._lm_extrapolate(cfg) == RC._lm_extrapolate(ref_cfg)


def test_dryrun_cfg_raises_the_chunks_of_cost_passes_only():
    cfg = REGISTRY["qwen3-0.6b"].config
    mesh = MeshShape(("data", "model"), (16, 16))
    assert C._dryrun_cfg(cfg, mesh, cost=False, seq=32768) == cfg
    cost = C._dryrun_cfg(cfg, mesh, cost=True, seq=32768)
    assert (cost.attn_chunk, cost.loss_chunk) == (4096, 4096)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "deepseek-v3-671b"])
def test_dryrun_cfg_places_moe_buffers_as_the_reference(arch):
    """`buf_pspec` as the reference's `_dryrun_cfg` sets it, per mesh and
    pass; unset in the arch's own config."""
    ref_cfg, cfg = REF[arch].config, REGISTRY[arch].config
    assert cfg.moe.buf_pspec is None
    for names, sizes in MESHES:
        for cost in (False, True):
            want = RC._dryrun_cfg(ref_cfg, AbstractMesh(sizes, names), unroll=cost).moe.buf_pspec
            got = C._dryrun_cfg(cfg, MeshShape(names, sizes), cost=cost).moe.buf_pspec
            assert got == want, (names, sizes, cost)


@pytest.mark.parametrize("paper_id", list(RT.GRAPH_SUITE))
def test_tcmis_tile_estimates_match_the_reference(paper_id):
    for n_chips in (1, 256, 512):
        T = RT.choose_tile_size(paper_id, n_chips)
        for t in TILE_CANDIDATES:           # the sizes the choice visits
            if t >= T:
                PT._occupancy_ratio(paper_id, t, PT.RCM, "cpu")
        assert PT.choose_tile_size(paper_id, n_chips) == T, n_chips
        assert PT.estimate_tiles(paper_id, T) == RT.estimate_tiles(paper_id, T), n_chips


@pytest.mark.parametrize("arch", ["tcmis", "deepfm"])
def test_smoke_runs_on_the_cpu(arch):
    """The registry's smoke of the paper's suite (the oracle and the fused
    engine through `Solver`, one valid set) and DeepFM's reduced step."""
    REGISTRY[arch].smoke(device="cpu")
