"""Every Hopper kernel of the port against its plain-torch version, on the
card.  Each test is marked `gpu` and skips without a CUDA device.  This
file imports neither JAX nor the reference package, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

All outputs but the split SpMV's f32 sums are integers or bits, and are
held exactly; the split SpMV on a random f32 RHS within 1e-5 (the kernel
and the plain version sum in different orders)."""
import numpy as np
import pytest
import torch

from repro_torch.core.engine import block_col_flags
from repro_torch.core.tiling import build_block_tiles, pack_frontier_words, pack_priority_planes
from repro_torch.graphs.graph import from_edges
from repro_torch.hopper import tc_neighbor_max as N
from repro_torch.hopper import tc_spmv as K

LANES = 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    return torch.device("cuda")


def _card_tiling(device, T, storage):
    """A random graph whose edges land in half the block-columns."""
    rng = np.random.default_rng(T)
    n = 700
    g = from_edges(rng.integers(0, n, 4 * n), rng.integers(0, n // 2, 4 * n), n,
                   device=device)
    return build_block_tiles(g, tile_size=T, storage=storage)


def _frontier(t, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    alive = torch.rand(t.n_padded, generator=gen, device=device) < 0.7
    cand = alive & (torch.rand(t.n_padded, generator=gen, device=device) < 0.3)
    return gen, cand, alive


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [8, 16, 32, 64, 128])
def test_kernel_matches_plain_on_card(cuda_device, T, storage):
    t = _card_tiling(cuda_device, T, storage)
    gen, cand, alive = _frontier(t, cuda_device, 0)
    flags = block_col_flags(cand, T)
    rhs = (torch.rand((t.n_padded, LANES), generator=gen, device=cuda_device) < 0.5).float()
    launches = K.tc_spmv_fused.launches
    got = K.tc_spmv_fused(t, rhs, cand, alive, col_flags=flags)
    assert K.tc_spmv_fused.launches == launches + 1
    want = K.tc_spmv_fused_plain(t, rhs, cand, alive, col_flags=flags)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    rhs = torch.randn((t.n_padded, LANES), generator=gen, device=cuda_device)
    torch.testing.assert_close(
        K.tc_spmv(t, rhs, col_flags=flags), K.tc_spmv_plain(t, rhs, col_flags=flags),
        rtol=1e-5, atol=1e-5,
    )


@pytest.mark.gpu
@pytest.mark.parametrize("T", [8, 16, 32, 64, 128])
def test_bits_kernels_match_plain_on_card(cuda_device, T):
    t = _card_tiling(cuda_device, T, "bitpack")
    _, cand, alive = _frontier(t, cuda_device, 1)
    cand_w, alive_w = pack_frontier_words(cand, T), pack_frontier_words(alive, T)
    for flags in (None, block_col_flags(cand, T)):
        launches = (K.tc_spmv_bits.launches, K.tc_spmv_fused_bits.launches)
        got = K.tc_spmv_fused_bits(t, cand_w, alive_w, col_flags=flags)
        hit = K.tc_spmv_bits(t, cand_w, col_flags=flags)
        assert (K.tc_spmv_bits.launches, K.tc_spmv_fused_bits.launches) == (
            launches[0] + 1, launches[1] + 1)
        want = K.tc_spmv_fused_bits_plain(t, cand_w, alive_w, col_flags=flags)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert torch.equal(hit, want[0])


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [8, 16, 32, 64, 128])
def test_dense_neighbor_max_matches_plain_on_card(cuda_device, T, storage):
    t = _card_tiling(cuda_device, T, storage)
    gen, _, mask = _frontier(t, cuda_device, 2)
    p = torch.randint(-(1 << 30), 1 << 30, (t.n_padded,), generator=gen,
                      device=cuda_device, dtype=torch.int32)
    launches = N.tc_neighbor_max.launches
    got = N.tc_neighbor_max(t, p, mask)
    assert N.tc_neighbor_max.launches == launches + 1
    assert torch.equal(got, N.tc_neighbor_max_plain(t, p, mask))


@pytest.mark.gpu
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("T", [8, 16, 32, 64, 128])
def test_plane_scan_matches_plain_on_card(cuda_device, T, signed):
    t = _card_tiling(cuda_device, T, "bitpack")
    gen, _, mask = _frontier(t, cuda_device, 3)
    lo, hi = (-(1 << 31), 0) if signed else (0, 1 << 31)
    p = torch.randint(lo, hi, (t.n_padded,), generator=gen, device=cuda_device,
                      dtype=torch.int64).to(torch.int32)
    planes = pack_priority_planes(p, T, 32 if signed else 31, signed=signed)
    mask_w = pack_frontier_words(mask, T)
    launches = N.tc_neighbor_max_bits.launches
    got = N.tc_neighbor_max_bits(t, planes, mask_w, signed=signed)
    assert N.tc_neighbor_max_bits.launches == launches + 1
    assert torch.equal(got, N.tc_neighbor_max_bits_plain(t, planes, mask_w, signed=signed))
    # the plane scan and the dense masked max are one function
    assert torch.equal(got, N.tc_neighbor_max_plain(t, p, mask))


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["tiled_pallas", "fused_pallas"])
def test_packed_solve_matches_tiled_ref_on_card(cuda_device, engine):
    from repro_torch.api import Solver, SolveOptions

    rng = np.random.default_rng(5)
    n = 3000
    g = from_edges(rng.integers(0, n, 3 * n), rng.integers(0, n, 3 * n), n,
                   device=cuda_device)
    opts = dict(phase1="tiled", storage="bitpack", tile_size=16, hybrid="off")
    got = Solver(SolveOptions(engine=engine, **opts), device=cuda_device).solve(g)
    want = Solver(SolveOptions(engine="tiled_ref", **opts), device=cuda_device).solve(g)
    assert got.converged and got.rounds == want.rounds
    assert np.array_equal(got.in_mis, want.in_mis)
