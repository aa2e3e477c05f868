"""Every Hopper kernel of the port against its plain-torch version, on the
card.  Each test is marked `gpu` and skips without a CUDA device.  This
file imports neither JAX nor the reference package, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

All outputs but the split SpMV's f32 sums are integers or bits, and are
held exactly; the split SpMV on a random f32 or bf16 RHS within 1e-5 (the
kernel sums on the tensor cores, in another order and rounding than the
plain version).  Where each output row has one nonzero term, the dense
SpMVs are exact on any f32 RHS: the kernel's three bf16 parts of a value
sum back to it.  The embedding bag sums in
the plain version's order with no FMA contraction, so it too is held
exactly, and the DeepFM forward through it equals the forward through the
plain version.  So is the bag's backward, which sums each table row's
slots in slot order (with or without a gather's gradient, over a slot
plan held equal to the plain sort's); a small DeepFM train step through
both bag kernels stays within 1e-6 of the step through their plain
versions.  The GNN cases: the split SpMV at GIN's widths (1,433, 64 and 3
lanes) as above, GIN's tiled forward within 1e-4 (scale-normalised) of its
segment forward, and the sampler's CSR built on the card equal to
`build_csr`, every sampled slot a neighbour of its parent.  The LM (no
kernel of its own): each arch's `SMOKE` config served on the card against
the same weights served on the CPU, prefill and four decode steps in f32,
logits within 1e-5 and every MoE call's expert ids equal; its training:
one f32 train step of qwen3-0.6b at full width, 2 layers, on the card
against the CPU's (loss, parameters and moments within 1e-5), remat
"full", "dots" and off agreeing within 1e-6 on the card, and the
attention recurrence's out-of-place forward (autograd recording) equal to
the in-place one bit for bit; and, without a card, the LM's entry points
raising on CUDA.  The Threefry kernel's bits and uniforms equal its plain
version's exactly, and a draw made on the card equals the same draw made
on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.engine import block_col_flags, live_bits
from repro_torch.core.tiling import (
    build_block_tiles,
    pack_frontier_words,
    pack_priority_planes,
    partition_tiles,
    tile_nnz,
)
from repro_torch.graphs.generators import grid2d
from repro_torch.graphs.graph import from_edges
from repro_torch.hopper import embedding_bag as E
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


def _check_dense(t, cand, alive, flags, rhs01, rhs):
    """The fused kernel exactly on a 0/1 RHS, the split kernel within 1e-5
    on `rhs`, each launched once."""
    launches = (K.tc_spmv_fused.launches, K.tc_spmv.launches)
    got = K.tc_spmv_fused(t, rhs01, cand, alive, col_flags=flags)
    split = K.tc_spmv(t, rhs, col_flags=flags)
    assert (K.tc_spmv_fused.launches, K.tc_spmv.launches) == (launches[0] + 1,
                                                               launches[1] + 1)
    for a, b in zip(got, K.tc_spmv_fused_plain(t, rhs01, cand, alive, col_flags=flags)):
        assert torch.equal(a, b)
    torch.testing.assert_close(split, K.tc_spmv_plain(t, rhs, col_flags=flags),
                               rtol=1e-5, atol=1e-5)
    return got


def _rhs_pair(t, gen, lanes, device):
    rhs01 = (torch.rand((t.n_padded, lanes), generator=gen, device=device) < 0.5).float()
    return rhs01, torch.randn((t.n_padded, lanes), generator=gen, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [2, 8, 11, 16])
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [8, 16, 32, 64, 128])
def test_dense_spmv_lane_counts_on_card(cuda_device, T, storage, lanes):
    """The kernel covers L lanes in 8-lane blocks: L = 2 and 11 leave part
    of a block masked, 11 stores odd rows, 16 takes two passes."""
    t = _card_tiling(cuda_device, T, storage)
    gen, cand, alive = _frontier(t, cuda_device, 10 + lanes)
    rhs01, rhs = _rhs_pair(t, gen, lanes, cuda_device)
    for flags in (None, block_col_flags(cand, T)):
        _check_dense(t, cand, alive, flags, rhs01, rhs)


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [8, 16, 32, 64, 128])
def test_split_spmv_bf16_rhs_on_card(cuda_device, T, storage):
    t = _card_tiling(cuda_device, T, storage)
    gen, cand, _ = _frontier(t, cuda_device, 20)
    rhs = torch.randn((t.n_padded, LANES), generator=gen, device=cuda_device)
    rhs = rhs.to(torch.bfloat16)
    for flags in (None, block_col_flags(cand, T)):
        torch.testing.assert_close(
            K.tc_spmv(t, rhs, col_flags=flags), K.tc_spmv_plain(t, rhs, col_flags=flags),
            rtol=1e-5, atol=1e-5,
        )


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [8, 16, 32, 64, 128])
def test_dense_spmv_empty_block_rows_on_card(cuda_device, T, storage):
    """Edges only among the first 100 of 600 vertices: every later
    block-row stores no tile, writes N_c = 0 and takes the trivial rule."""
    rng = np.random.default_rng(T)
    n, hi = 600, 100
    g = from_edges(rng.integers(0, hi, 4 * hi), rng.integers(0, hi, 4 * hi), n,
                   device=cuda_device)
    t = build_block_tiles(g, tile_size=T, storage=storage)
    empty = (t.row_starts[1:] == t.row_starts[:-1]).repeat_interleave(T)
    assert bool(empty.any())
    gen, cand, alive = _frontier(t, cuda_device, 21)
    rhs01, rhs = _rhs_pair(t, gen, LANES, cuda_device)
    for flags in (None, block_col_flags(cand, T)):
        n_c, new_alive, mis_add = _check_dense(t, cand, alive, flags, rhs01, rhs)
        assert not bool(n_c[empty].any())
        assert torch.equal(new_alive[empty], (alive & ~cand)[empty])
        assert torch.equal(mis_add, cand)


def _past_32_tiles(device, T, storage):
    """A tiling whose block-row 0 has an edge into each of 48 block-columns."""
    rng = np.random.default_rng(T)
    n = 48 * T
    j = np.arange(n)
    src = np.concatenate([(j + 1) % T, rng.integers(0, n, 2 * n)])   # no self-loop
    dst = np.concatenate([j, rng.integers(0, n, 2 * n)])
    t = build_block_tiles(from_edges(src, dst, n, device=device), tile_size=T,
                          storage=storage)
    assert int(t.row_starts[1]) == 48
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [8, 16, 128])
def test_dense_spmv_block_row_past_32_tiles_on_card(cuda_device, T, storage):
    """Block-row 0 has an edge into each of 48 block-columns, so its warp
    walks its tile list in two 32-tile chunks, gated or not."""
    t = _past_32_tiles(cuda_device, T, storage)
    gen, cand, alive = _frontier(t, cuda_device, 22)
    gate = torch.ones(t.n_block_cols, dtype=torch.int32, device=cuda_device)
    gate[::7] = 0
    first = t.tile_cols[: int(t.row_starts[1])].long()
    assert first.numel() == 48 and int(gate[first].sum()) > 32
    rhs01, rhs = _rhs_pair(t, gen, LANES, cuda_device)
    for flags in (None, gate):
        _check_dense(t, cand, alive, flags, rhs01, rhs)


def _full_mantissa(n, lanes, gen, device):
    """±(1 + k·2^-23)·2^e with k uniform over all 23-bit mantissas (and the
    largest, which rounds up to the next power in bf16), e in [-20, 20]."""
    k = torch.randint(0, 1 << 23, (n, lanes), generator=gen, device=device)
    k[::5] = (1 << 23) - 1
    e = torch.randint(-20, 21, (n, lanes), generator=gen, device=device)
    sign = torch.randint(0, 2, (n, lanes), generator=gen, device=device) * 2 - 1
    x = torch.ldexp(1 + k.double() * 2.0 ** -23, e.double()) * sign
    return x.float()


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [8, 16, 32, 64, 128])
def test_dense_spmv_full_mantissa_rhs_is_exact_on_card(cuda_device, T, storage):
    """Every row has exactly one neighbour (a random perfect matching), so
    each output is one RHS value: the three bf16 parts must give back all
    24 bits of it through the tensor cores."""
    rng = np.random.default_rng(T)
    n = 1000
    perm = rng.permutation(n)
    t = build_block_tiles(from_edges(perm[0::2], perm[1::2], n, device=cuda_device),
                          tile_size=T, storage=storage)
    gen, cand, alive = _frontier(t, cuda_device, 23)
    rhs = _full_mantissa(t.n_padded, LANES, gen, cuda_device)
    for flags in (None, block_col_flags(cand, T)):
        want = K.tc_spmv_plain(t, rhs, col_flags=flags)
        assert torch.equal(K.tc_spmv(t, rhs, col_flags=flags), want)
        got = K.tc_spmv_fused(t, rhs, cand, alive, col_flags=flags)
        for a, b in zip(got, K.tc_spmv_fused_plain(t, rhs, cand, alive, col_flags=flags)):
            assert torch.equal(a, b)
        assert bool((want[: n] != 0).any())


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


def _hold_fused_bits(t, cand, alive, flags):
    """The fused packed SpMV, launched once per call, bit-equal to its plain
    version; returns its (hit, new_alive, mis_add) words."""
    T = t.tile_size
    cand_w, alive_w = pack_frontier_words(cand, T), pack_frontier_words(alive, T)
    launches = K.tc_spmv_fused_bits.launches
    got = K.tc_spmv_fused_bits(t, cand_w, alive_w, col_flags=flags)
    assert K.tc_spmv_fused_bits.launches == launches + 1
    for a, b in zip(got, K.tc_spmv_fused_bits_plain(t, cand_w, alive_w, col_flags=flags)):
        assert torch.equal(a, b)
    return got


def _gated_flags(t, cand, gen):
    """Column flags of the candidates with about a third of the
    block-columns gated off besides."""
    gate = torch.rand(t.n_block_cols, generator=gen, device=cand.device) >= 1 / 3
    return (block_col_flags(cand, t.tile_size) * gate.to(torch.int32)).contiguous()


def _hold_split_bits(t, cand, flags):
    """The split packed SpMV, launched once per call, bit-equal to its plain
    version, with no bit above T set; returns its hit words."""
    cand_w = pack_frontier_words(cand, t.tile_size)
    launches = K.tc_spmv_bits.launches
    hit = K.tc_spmv_bits(t, cand_w, col_flags=flags)
    assert K.tc_spmv_bits.launches == launches + 1
    assert torch.equal(hit, K.tc_spmv_bits_plain(t, cand_w, col_flags=flags))
    assert not bool((hit & ~live_bits(t.tile_size)).any())
    return hit


def _wide_row_tiling(device, T):
    """Block-row 0 owns 48 tiles (two 32-tile chunks of the lane-per-tile
    warp at T <= 16) and the vertices past 48·T have no edge: returns the
    tiling and its empty block-rows."""
    rng = np.random.default_rng(T)
    n = 64 * T
    j = np.arange(48 * T)
    src = np.concatenate([(j + 1) % T, rng.integers(0, 48 * T, 96 * T)])   # no self-loop
    dst = np.concatenate([j, rng.integers(0, 48 * T, 96 * T)])
    t = build_block_tiles(from_edges(src, dst, n, device=device), tile_size=T,
                          storage="bitpack")
    assert int(t.row_starts[1]) == 48
    empty = t.row_starts[1:] == t.row_starts[:-1]
    assert bool(empty[48:].all())
    return t, empty


def _several_groups_tiling(device, T):
    """More groups of block-rows than the card holds warps (at most 64 per
    SM): each warp of a resident lane-per-tile grid strides over several
    groups."""
    from repro_torch.graphs import grid2d

    t = build_block_tiles(grid2d(1100, 1100, device=device), tile_size=T,
                          storage="bitpack")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    assert t.n_block_rows // max(64 // T, 1) > 64 * sms
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("T", [8, 16, 32, 64, 128])
def test_fused_bits_kernel_gated_columns_and_empty_block_rows_on_card(cuda_device, T):
    """Block-row 0 owns 48 tiles (two 32-tile chunks of the lane-per-tile
    warp at T <= 16), the vertices past 48·T have no edge (empty block-rows:
    hit 0, the trivial rule), and columns are ungated, gated by the
    candidates, or with a third gated off besides."""
    t, empty = _wide_row_tiling(cuda_device, T)
    gen, cand, alive = _frontier(t, cuda_device, 40)
    for flags in (None, block_col_flags(cand, T), _gated_flags(t, cand, gen)):
        hit, new_alive, mis_add = _hold_fused_bits(t, cand, alive, flags)
        assert not bool(hit[empty].any())
    assert bool(hit.any())


@pytest.mark.gpu
@pytest.mark.parametrize("T", [8, 16, 128])
def test_fused_bits_kernel_warps_take_several_groups_on_card(cuda_device, T):
    """More groups of block-rows than the card holds warps (at most 64 per
    SM), so each warp of the resident lane-per-tile grid strides over
    several groups and carries its prefetched bounds and columns from one
    to the next (T = 128 runs the thread-per-row kernel, on the same
    graph)."""
    t = _several_groups_tiling(cuda_device, T)
    gen, cand, alive = _frontier(t, cuda_device, 41)
    for flags in (None, _gated_flags(t, cand, gen)):
        _hold_fused_bits(t, cand, alive, flags)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [8, 16])
def test_split_bits_kernel_gated_columns_and_empty_block_rows_on_card(cuda_device, T):
    """The split packed SpMV's lane-per-tile form on the 48-tile block-row
    and the empty block-rows (hit 0), with columns ungated, gated by the
    candidates, or with a third gated off besides."""
    t, empty = _wide_row_tiling(cuda_device, T)
    gen, cand, _ = _frontier(t, cuda_device, 42)
    for flags in (None, block_col_flags(cand, T), _gated_flags(t, cand, gen)):
        hit = _hold_split_bits(t, cand, flags)
        assert not bool(hit[empty].any())
    assert bool(hit.any())


def _sub_grid(t, n_rows, n_cols):
    """The tiles of `t` in block-rows < n_rows and block-columns < n_cols,
    as an (n_rows x n_cols) block grid."""
    import dataclasses

    nt = t.n_tiles
    keep = ((t.tile_rows[:nt] < n_rows) & (t.tile_cols[:nt] < n_cols)).nonzero().flatten()
    rows = t.tile_rows[keep].contiguous()
    row_starts = torch.zeros(n_rows + 1, dtype=torch.int32, device=rows.device)
    row_starts[1:] = torch.bincount(rows.long(), minlength=n_rows).cumsum(0)
    return dataclasses.replace(
        t, tiles=t.tiles[keep].contiguous(), tile_rows=rows,
        tile_cols=t.tile_cols[keep].contiguous(), row_starts=row_starts,
        n_tiles=int(keep.numel()), n_nodes=max(n_rows, n_cols) * t.tile_size,
        n_block_rows=n_rows, n_block_cols=n_cols)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [8, 16])
def test_split_bits_kernel_non_square_block_grid_on_card(cuda_device, T):
    """The split kernel reads candidate words by block-column only, so a
    block grid with more rows than columns (block-rows past nbc) or more
    columns than rows runs; the fused wrapper refuses both."""
    t = _card_tiling(cuda_device, T, "bitpack")
    nb = t.n_block_rows
    for n_rows, n_cols in ((nb, nb // 3), (nb // 3, nb)):
        sub = _sub_grid(t, n_rows, n_cols)
        assert sub.n_tiles > 0
        gen = torch.Generator(device=cuda_device).manual_seed(43)
        cand = torch.rand(n_cols * T, generator=gen, device=cuda_device) < 0.3
        for flags in (None, _gated_flags(sub, cand, gen)):
            _hold_split_bits(sub, cand, flags)
        with pytest.raises(ValueError, match="square"):
            K.tc_spmv_fused_bits(sub, pack_frontier_words(cand, T),
                                 torch.zeros((n_rows, 1), dtype=torch.int32,
                                             device=cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize("T", [8, 16])
def test_split_bits_kernel_warps_take_several_groups_on_card(cuda_device, T):
    t = _several_groups_tiling(cuda_device, T)
    gen, cand, _ = _frontier(t, cuda_device, 44)
    for flags in (None, _gated_flags(t, cand, gen)):
        _hold_split_bits(t, cand, flags)


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


def _hold_maxes(t, mask, select_key, resolve_key):
    """Both neighbour maxes, each launched once per call and bit-equal to
    its plain version: the dense max of each key on the tiles as stored,
    and the plane scan (on the tiles as words) of the select key's 31
    unsigned planes and the resolve key's 32 sign-biased planes."""
    T = t.tile_size
    mask_w = pack_frontier_words(mask, T)
    outs = []
    for key, signed in ((select_key, False), (resolve_key, True)):
        launches = (N.tc_neighbor_max.launches, N.tc_neighbor_max_bits.launches)
        dense = N.tc_neighbor_max(t, key, mask)
        planes = pack_priority_planes(key, T, 32 if signed else 31, signed=signed)
        scan = N.tc_neighbor_max_bits(t, planes, mask_w, signed=signed)
        assert (N.tc_neighbor_max.launches, N.tc_neighbor_max_bits.launches) == (
            launches[0] + 1, launches[1] + 1)
        assert torch.equal(dense, N.tc_neighbor_max_plain(t, key, mask))
        assert torch.equal(scan, N.tc_neighbor_max_bits_plain(t, planes, mask_w, signed=signed))
        outs.append((dense, scan))
    return outs


def _keys(n, gen, device, extremes=()):
    """A select key (unsigned, 31 bits) and a resolve key (any int32), with
    about half of each drawn from `extremes` when given."""
    out = []
    for lo, hi, values in ((0, 1 << 31, [v for v in extremes if v >= 0]),
                           (-(1 << 31), 1 << 31, list(extremes))):
        key = torch.randint(lo, hi, (n,), generator=gen, device=device, dtype=torch.int64)
        if values:
            pick = torch.rand(n, generator=gen, device=device) < 0.5
            choice = torch.tensor(values, device=device)[
                torch.randint(0, len(values), (n,), generator=gen, device=device)]
            key = torch.where(pick, choice, key)
        out.append(key.to(torch.int32))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [8, 16, 128])
def test_neighbor_maxes_block_row_past_32_tiles_on_card(cuda_device, T, storage):
    """Block-row 0's 48 tiles span two 32-tile chunks of its warp (T >=
    32), or of the warp that owns it and its neighbours (T <= 16)."""
    t = _past_32_tiles(cuda_device, T, storage)
    gen, _, mask = _frontier(t, cuda_device, 30)
    _hold_maxes(t, mask, *_keys(t.n_padded, gen, cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [8, 16, 32, 64, 128])
def test_neighbor_maxes_empty_block_rows_on_card(cuda_device, T, storage):
    """Edges only among the first 100 of 600 vertices: every later
    block-row owns no tile and gets int32 min."""
    rng = np.random.default_rng(T)
    n, hi = 600, 100
    g = from_edges(rng.integers(0, hi, 4 * hi), rng.integers(0, hi, 4 * hi), n,
                   device=cuda_device)
    t = build_block_tiles(g, tile_size=T, storage=storage)
    empty = (t.row_starts[1:] == t.row_starts[:-1]).repeat_interleave(T)
    assert bool(empty.any())
    gen, _, mask = _frontier(t, cuda_device, 31)
    for dense, scan in _hold_maxes(t, mask, *_keys(t.n_padded, gen, cuda_device)):
        assert bool((dense[empty] == -(1 << 31)).all() and (scan[empty] == -(1 << 31)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [8, 16, 32, 64, 128])
def test_neighbor_maxes_all_dead_and_all_live_masks_on_card(cuda_device, T, storage):
    t = _card_tiling(cuda_device, T, storage)
    gen = torch.Generator(device=cuda_device).manual_seed(32)
    keys = _keys(t.n_padded, gen, cuda_device)
    covered = (t.row_starts[1:] > t.row_starts[:-1]).repeat_interleave(T)
    dead = torch.zeros(t.n_padded, dtype=torch.bool, device=cuda_device)
    for dense, scan in _hold_maxes(t, dead, *keys):
        assert bool((dense[covered] == -(1 << 30)).all() and (scan[covered] == -(1 << 30)).all())
    _hold_maxes(t, ~dead, *keys)


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
def test_neighbor_maxes_many_set_bits_at_T128_on_card(cuda_device, storage):
    """About 50 neighbours per row inside one 128-wide tile: the rows'
    set-bit loops run long and uneven across the warp."""
    rng = np.random.default_rng(33)
    n = 512
    src = rng.integers(0, n, 50 * n)
    dst = (src // 128) * 128 + rng.integers(0, 128, 50 * n)
    t = build_block_tiles(from_edges(src, dst, n, device=cuda_device), tile_size=128,
                          storage=storage)
    gen, _, mask = _frontier(t, cuda_device, 34)
    _hold_maxes(t, mask, *_keys(t.n_padded, gen, cuda_device))
    _hold_maxes(t, torch.ones_like(mask), *_keys(t.n_padded, gen, cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [8, 16, 32, 64, 128])
def test_neighbor_maxes_extreme_keys_on_card(cuda_device, T, storage):
    """Keys at the edges of the order: unsigned 0 and 2^31 - 1, signed
    int32 min, -1 and 0.  Blocks 0 and 1 are joined completely, so with
    all vertices live every tile row of block 0 is all live edges; both
    maxes still floor every covered row at _NEG, as the Pallas kernels
    (and the plain versions) do."""
    rng = np.random.default_rng(T)
    n = 8 * T
    a, b = np.meshgrid(np.arange(T), np.arange(T, 2 * T))
    src = np.concatenate([a.ravel(), rng.integers(2 * T, n, 3 * n)])
    dst = np.concatenate([b.ravel(), rng.integers(2 * T, n, 3 * n)])
    t = build_block_tiles(from_edges(src, dst, n, device=cuda_device), tile_size=T,
                          storage=storage)
    gen, _, mask = _frontier(t, cuda_device, 35)
    extremes = (0, (1 << 31) - 1, -(1 << 31), -1)
    for m in (mask, torch.ones_like(mask)):
        _hold_maxes(t, m, *_keys(t.n_padded, gen, cuda_device, extremes))
    low = torch.full((t.n_padded,), -(1 << 31), dtype=torch.int32, device=cuda_device)
    _, (dense, scan) = _hold_maxes(t, torch.ones_like(mask), low, low)
    assert bool((dense[:T] == -(1 << 30)).all() and (scan[:T] == -(1 << 30)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("T", [8, 16, 128])
def test_neighbor_maxes_warps_take_several_groups_on_card(cuda_device, T):
    """More groups of block-rows than the card holds warps (at most 64 per
    SM), so each warp of the resident grid strides over several groups
    and carries its prefetched bounds and columns from one to the next."""
    from repro_torch.graphs import grid2d

    t = build_block_tiles(grid2d(1100, 1100, device=cuda_device), tile_size=T,
                          storage="bitpack")
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert t.n_block_rows // max(64 // T, 1) > 64 * sms
    gen, _, mask = _frontier(t, cuda_device, 36)
    _hold_maxes(t, mask, *_keys(t.n_padded, gen, cuda_device))


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


def _counts():
    return {w.__name__: w.launches for w in (
        K.tc_spmv, K.tc_spmv_fused, K.tc_spmv_bits, K.tc_spmv_fused_bits,
        N.tc_neighbor_max, N.tc_neighbor_max_bits)}


def _solve_counted(solver, g, how="solve"):
    """One solve (or profile) and the kernel launches it made."""
    before = _counts()
    out = getattr(solver, how)(g)
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in _counts().items()}


# the split packed path, the main path and the dense tiled phase ①
CARD_PATHS = [
    dict(engine="tiled_pallas", phase1="tiled", storage="bitpack"),
    dict(engine="fused_pallas", phase1="segment", storage="bitpack"),
    dict(engine="fused_pallas", phase1="tiled", storage="int8"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("path", CARD_PATHS, ids=lambda p: "-".join(p.values()))
def test_telemetry_solve_on_card_equals_plain_solve(cuda_device, path):
    """Telemetry on the card launches the same kernels as often, changes no
    result, and records the trace `tiled_ref` records on the card."""
    from repro_torch.api import Solver, SolveOptions
    from repro_torch.graphs import grid2d

    g = grid2d(300, 300, device=cuda_device)
    opts = dict(tile_size=16, hybrid="off", **path)
    off, n_off = _solve_counted(Solver(SolveOptions(**opts), device=cuda_device), g)
    on, n_on = _solve_counted(
        Solver(SolveOptions(telemetry=True, **opts), device=cuda_device), g)
    assert n_on == n_off and sum(n_on.values()) > 0
    assert on.rounds == off.rounds and np.array_equal(on.in_mis, off.in_mis)
    rt = on.telemetry
    rt.check_invariants()
    assert rt.alive[0] == g.n_nodes and sum(rt.selected) == on.mis_size
    ref = Solver(SolveOptions(telemetry=True, **dict(opts, engine="tiled_ref")),
                 device=cuda_device).solve(g)
    assert {k: v for k, v in rt.to_dict().items() if k != "meta"} == {
        k: v for k, v in ref.telemetry.to_dict().items() if k != "meta"}


@pytest.mark.gpu
@pytest.mark.parametrize("path", CARD_PATHS, ids=lambda p: "-".join(p.values()))
def test_profile_on_card_equals_solve(cuda_device, path):
    """The profiler twin on the card: the same MIS and rounds as `solve`,
    the same kernels (plus one warm-up round), every phase timed."""
    from repro_torch.api import Solver, SolveOptions
    from repro_torch.graphs import grid2d

    g = grid2d(300, 300, device=cuda_device)
    solver = Solver(SolveOptions(tile_size=16, hybrid="off", **path), device=cuda_device)
    want, n_solve = _solve_counted(solver, g)
    (got, times), n_prof = _solve_counted(solver, g, "profile")
    assert got.rounds == want.rounds == times["rounds"]
    assert np.array_equal(got.in_mis, want.in_mis)
    assert {k: v * (want.rounds + 1) // want.rounds for k, v in n_solve.items()} == n_prof
    assert all(times[k] > 0.0 for k in ("phase1", "phase2", "phase3"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K_", [1, 39])
@pytest.mark.parametrize("D", [1, 8, 10, 32, 64])
def test_embedding_bag_matches_plain_on_card(cuda_device, D, K_, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(D * 100 + K_)
    V, B = 5000, 777
    table = torch.randn((V, D), generator=gen, device=cuda_device).to(dtype)
    idx = torch.randint(0, V, (B, K_), generator=gen, device=cuda_device, dtype=torch.int32)
    w = torch.rand((B, K_), generator=gen, device=cuda_device)
    w[:, 0] = 0.0
    for weights in (None, w):
        launches = E.embedding_bag.launches
        got = E.embedding_bag(table, idx, weights)
        assert E.embedding_bag.launches == launches + 1
        assert got.dtype == torch.float32 and got.shape == (B, D)
        assert torch.equal(got, E.embedding_bag_plain(table, idx, weights))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K_", [0, 1, 39, 100])
@pytest.mark.parametrize("D", [1, 2, 3, 8, 10, 16, 64])
def test_embedding_bag_runs_of_bags_match_plain_on_card(cuda_device, D, K_, dtype):
    """A CTA owns a run of 128 / G bags (G lanes per bag: a lane per
    element, or per pair of elements where D is even on an f32 table, at
    most 32): numbers of bags below one run, at it, above it and not a
    multiple of it; K odd (one staged block), even (rows of an odd stride)
    and past one chunk of staged slots at small D; K = 0 gives zeros."""
    gen = torch.Generator(device=cuda_device).manual_seed(D * 1000 + K_)
    V = 3000
    table = torch.randn((V, D), generator=gen, device=cuda_device).to(dtype)
    for B in (1, 4, 5, 25, 26, 128, 129, 1001):
        idx = torch.randint(0, V, (B, K_), generator=gen, device=cuda_device, dtype=torch.int32)
        w = torch.rand((B, K_), generator=gen, device=cuda_device) - 0.25
        for weights in (None, w):
            launches = E.embedding_bag.launches
            got = E.embedding_bag(table, idx, weights)
            assert E.embedding_bag.launches == launches + 1
            assert torch.equal(got, E.embedding_bag_plain(table, idx, weights)), (B, weights)
            if K_ == 0:
                assert not bool(got.any())


@pytest.mark.gpu
@pytest.mark.parametrize("D", [1, 10])
def test_embedding_bag_unaligned_views_on_card(cuda_device, D):
    """A table, indices and weights that start 4 bytes past a 16-byte
    boundary: the f32 pair loads give way to scalar ones, and the staging
    copies take a scalar head before their 16-byte loads."""
    gen = torch.Generator(device=cuda_device).manual_seed(D)
    V, B, K_ = 2000, 300, 39
    table = torch.randn((V * D + 1,), generator=gen, device=cuda_device)[1:].view(V, D)
    idx = torch.randint(0, V, (B * K_ + 1,), generator=gen, device=cuda_device,
                        dtype=torch.int32)[1:].view(B, K_)
    w = torch.rand((B * K_ + 1,), generator=gen, device=cuda_device)[1:].view(B, K_)
    assert table.data_ptr() % 8 == 4 and idx.data_ptr() % 16 == 4 and w.data_ptr() % 16 == 4
    for weights in (None, w):
        assert torch.equal(E.embedding_bag(table, idx, weights),
                           E.embedding_bag_plain(table, idx, weights))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_last_row_of_a_table_past_2_31_on_card(cuda_device, dtype):
    """Indices at V - 1 and V - 2 of a table of more than 2^31 elements,
    weighted and unweighted: the 64-bit row offset reaches the last row."""
    V, D = (1 << 25) + 4096, 64
    nbytes = V * D * torch.empty((), dtype=dtype).element_size()
    if torch.cuda.mem_get_info(cuda_device)[0] < 2 * nbytes:
        pytest.skip("the card has no room for the table")
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    table = torch.empty((V, D), dtype=dtype, device=cuda_device)
    table[-16:] = torch.randn((16, D), generator=gen, device=cuda_device).to(dtype)
    table[:16] = torch.randn((16, D), generator=gen, device=cuda_device).to(dtype)
    idx = torch.randint(0, 16, (37, 5), generator=gen, device=cuda_device, dtype=torch.int32)
    idx[:, 0] = V - 1
    idx[::2, 3] = V - 2
    assert (V - 1) * D >= 1 << 31
    w = torch.rand(idx.shape, generator=gen, device=cuda_device)
    for weights in (None, w):
        assert torch.equal(E.embedding_bag(table, idx, weights),
                           E.embedding_bag_plain(table, idx, weights))
    del table


@pytest.mark.gpu
def test_embedding_bag_row_offsets_past_2_31(cuda_device):
    """A bf16 table of more than 2^31 elements: row · D must not wrap."""
    V, D = (1 << 25) + 4096, 64
    if torch.cuda.mem_get_info(cuda_device)[0] < 3 * V * D * 2:
        pytest.skip("the card has no room for a 4.3 GB table")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    table = torch.empty((V, D), dtype=torch.bfloat16, device=cuda_device)
    table[-8192:] = torch.randn((8192, D), generator=gen, device=cuda_device).to(torch.bfloat16)
    table[:8192] = torch.randn((8192, D), generator=gen, device=cuda_device).to(torch.bfloat16)
    top = torch.randint(V - 8192, V, (64, 13), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    low = torch.randint(0, 8192, (64, 13), generator=gen, device=cuda_device, dtype=torch.int32)
    idx = torch.cat([top, low], dim=1)
    assert int(idx.max()) * D >= 1 << 31
    got = E.embedding_bag(table, idx)
    assert torch.equal(got, E.embedding_bag_plain(table, idx))
    del table


@pytest.mark.gpu
def test_embedding_bag_refuses_what_the_kernel_does_not_take(cuda_device):
    table = torch.randn((10, 4), device=cuda_device)
    idx = torch.zeros((3, 2), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="int32"):
        E.embedding_bag(table, idx.long())
    with pytest.raises(TypeError, match="dtype"):
        E.embedding_bag(table.half(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        E.embedding_bag(torch.randn((4, 10), device=cuda_device).t(), idx)
    with pytest.raises(ValueError, match="shape"):
        E.embedding_bag(table, idx, torch.ones((3, 3), device=cuda_device))
    with pytest.raises(RuntimeError, match="weights"):
        E.embedding_bag(table, idx, torch.ones((3, 2), device=cuda_device, requires_grad=True))
    with pytest.raises(RuntimeError, match="f32 tables only"):
        E.embedding_bag(table.bfloat16().requires_grad_(), idx)
    with pytest.raises(TypeError, match="int32"):
        E.embedding_bag_backward(torch.ones((3, 4), device=cuda_device), idx.long(), None, 10)
    with pytest.raises(TypeError, match="dtype"):
        E.embedding_bag_backward(torch.ones((3, 4), device=cuda_device).double(), idx, None, 10)
    with pytest.raises(ValueError, match="shape"):
        E.embedding_bag_backward(torch.ones((2, 4), device=cuda_device), idx, None, 10)


def _backward_case(device, B, K, D, V, weighted, seed, hot=None, gather=False):
    """grad_out (B, D), indices (B, K) into V rows (all into `hot` rows
    when given: long runs), weights or None, the gather's gradient (B, K,
    D) or None."""
    gen = torch.Generator(device=device).manual_seed(seed)
    idx = torch.randint(0, hot or V, (B, K), generator=gen, device=device, dtype=torch.int32)
    g = torch.randn((B, D), generator=gen, device=device)
    w = torch.rand((B, K), generator=gen, device=device) if weighted else None
    x = torch.randn((B, K, D), generator=gen, device=device) if gather else None
    return g, idx, w, x


def _hold_backward(g, idx, w, x, V):
    """Two launches bit-equal to each other and to the plain version, one
    launch each (none for an empty output), the slot plan equal to the
    plain sort's, and exact zeros on every row no slot touches."""
    launches = E.embedding_bag_backward.launches
    got = E.embedding_bag_backward(g, idx, w, V, extra=x)
    again = E.embedding_bag_backward(g, idx, w, V, extra=x)
    torch.cuda.synchronize()
    assert E.embedding_bag_backward.launches == launches + (2 if got.numel() else 0)
    assert got.shape == (V, g.shape[1]) and got.dtype == torch.float32
    assert torch.equal(got, again)
    assert torch.equal(got, E.embedding_bag_backward_plain(g, idx, w, V, extra=x))
    slots, want = E.sort_slots(idx, V), E.sort_slots_plain(idx, V)
    n_runs = int(want.n_runs)
    assert torch.equal(slots.n_runs, want.n_runs)
    for name in ("rows", "order"):
        assert torch.equal(getattr(slots, name), getattr(want, name)), name
    assert torch.equal(slots.run_rows[:n_runs], want.run_rows[:n_runs])
    assert torch.equal(slots.starts[:n_runs + 1], want.starts[:n_runs + 1])
    touched = torch.zeros(V, dtype=torch.bool, device=g.device)
    touched[idx.reshape(-1).long()] = True
    assert not got[~touched].any()
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("B, K, D, V, hot", [
    (4096, 39, 10, 200_000, None), (4096, 39, 1, 200_000, None), (2048, 13, 10, 5000, 16),
    (1000, 7, 40, 3000, None), (300, 1, 3, 50, None), (0, 39, 10, 100, None),
    (5, 0, 10, 100, None)])
def test_embedding_bag_backward_bit_equal_and_deterministic(cuda_device, B, K, D, V, hot,
                                                            weighted, gather):
    g, idx, w, x = _backward_case(cuda_device, B, K, D, V, weighted, seed=B + K + D, hot=hot,
                                  gather=gather)
    _hold_backward(g, idx, w, x, V)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [10, 1, 3])
@pytest.mark.parametrize("case", ["ends touched", "ends untouched", "one row", "tail rows",
                                  "no slots", "no rows"])
def test_embedding_bag_backward_dense_write_edges(cuda_device, case, D):
    """The dense write's edges: the first and last rows touched and
    untouched, every slot in one row, row counts that are no multiple of a
    CTA's rows (3 CTAs and 5 rows more), no slots, no rows."""
    R = E.dense_rows(D)
    V = 3 * R + 5
    g, idx, w, x = _backward_case(cuda_device, 700, 39, D, V, True, seed=D, gather=True)
    if case == "ends touched":
        idx[0, 0], idx[-1, -1] = 0, V - 1
    elif case == "ends untouched":
        idx = idx.clamp(1, V - 2)
    elif case == "one row":
        idx = torch.full_like(idx, R + 1)
    elif case == "tail rows":
        idx = 3 * R + idx % 5
    elif case == "no slots":
        g, idx, w, x = g[:0], idx[:0], w[:0], x[:0]
    else:
        g, idx, w, x, V = g[:0], idx[:0], w[:0], x[:0], 0
    got = _hold_backward(g, idx.contiguous(), w, x, V)
    if case == "ends touched":
        assert got[0].any() and got[-1].any()
    if case == "no slots":
        assert not got.any() and got.shape == (V, D)


@pytest.mark.gpu
def test_embedding_bag_autograd_takes_the_backward_kernel(cuda_device):
    g, idx, w, x = _backward_case(cuda_device, 512, 39, 10, 4000, True, seed=3, gather=True)
    table = torch.randn((4000, 10), device=cuda_device, requires_grad=True)
    fwd, bwd = E.embedding_bag.launches, E.embedding_bag_backward.launches
    out = E.embedding_bag(table, idx, w)
    (got,) = torch.autograd.grad(out, table, g)
    assert (E.embedding_bag.launches, E.embedding_bag_backward.launches) == (fwd + 1, bwd + 1)
    assert torch.equal(got, E.embedding_bag_backward_plain(g, idx, w, 4000))
    with torch.inference_mode():
        E.embedding_bag(table, idx, w)
    assert E.embedding_bag_backward.launches == bwd + 1
    # the gathered rows' gradient joins the same launch; two bags share one sort
    first = torch.randn((4000, 1), device=cuda_device, requires_grad=True)
    plan, sorts = E.SlotPlan(idx, 4000), E.sort_slots.calls
    out, rows = E.embedding_bag(table, idx, w, gather=True, plan=plan)
    lin = E.embedding_bag(first, idx, plan=plan)
    got, got_first = torch.autograd.grad((out, rows, lin), (table, first), (g, x, g[:, :1]))
    assert E.embedding_bag_backward.launches == bwd + 3 and E.sort_slots.calls == sorts + 1
    assert torch.equal(rows, table.detach()[idx.long()])
    assert torch.equal(got, E.embedding_bag_backward_plain(g, idx, w, 4000, extra=x))
    assert torch.equal(got_first, E.embedding_bag_backward_plain(g[:, :1].contiguous(), idx,
                                                                 None, 4000))


@pytest.mark.gpu
def test_deepfm_train_step_on_card_equals_plain_bags_and_cpu(cuda_device):
    """One small train step on the card: 2 forward and 2 backward bag
    launches over one slot sort, params and moments within 1e-6 of the step through both
    plain versions (the bags are bit-equal to them); the loss and gradients
    as the CPU's (f32 GEMMs without TF32): loss within 1e-6, gradients
    allclose(rtol=1e-5, atol=1e-7), as the CPU parity tests hold them."""
    from repro_torch.configs import deepfm as C
    from repro_torch.data.pipeline import ClickStream
    from repro_torch.models import deepfm as M
    from repro_torch.train.optimizer import adamw_init

    vocabs = tuple([64] * 13 + [4000, 3000, 2000] + [500] * 23)
    cfg = M.DeepFMConfig(field_vocabs=vocabs, mlp_dims=(64, 64))
    model = M.DeepFM(cfg, seed=0, device=cuda_device)
    fields, labels = (torch.from_numpy(a).to(cuda_device)
                      for a in ClickStream(vocabs, 256, seed=0).batch_at(0))
    params = C.train_params(model)
    opt = adamw_init(params)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        fwd, bwd = E.embedding_bag.launches, E.embedding_bag_backward.launches
        sorts = E.sort_slots.calls
        p, s, loss = C.train_step(model, params, opt, fields, labels)
        assert (E.embedding_bag.launches - fwd, E.embedding_bag_backward.launches - bwd) == (2, 2)
        assert E.sort_slots.calls - sorts == 1
        assert bool(torch.isfinite(loss))
        pp, ps, ploss = C.train_step(model, params, opt, fields, labels,
                                     bag=E.embedding_bag_plain)
        _, grads = C.loss_and_grads(model, params, fields, labels)
        cpu = M.DeepFM(cfg, device="cpu")
        cpu.load_state_dict(model.state_dict())
        closs, cgrads = C.loss_and_grads(cpu, C.train_params(cpu), fields.cpu(), labels.cpu())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    assert abs(float(loss) - float(ploss)) <= 1e-6
    assert abs(float(loss) - float(closs)) <= 1e-6
    for k in params:
        for got, plain in ((p[k], pp[k]), (s.m[k], ps.m[k]), (s.v[k], ps.v[k])):
            torch.testing.assert_close(got, plain, rtol=0, atol=1e-6)
        torch.testing.assert_close(grads[k].cpu(), cgrads[k], rtol=1e-5, atol=1e-7)


@pytest.mark.gpu
def test_deepfm_forward_on_card_equals_plain_and_cpu(cuda_device):
    from repro_torch.configs.deepfm import retrieval_step, serve_step
    from repro_torch.data.pipeline import ClickStream
    from repro_torch.models import deepfm as M

    vocabs = tuple([64] * 13 + [4000, 3000, 2000] + [500] * 23)
    cfg = M.DeepFMConfig(field_vocabs=vocabs)
    model = M.DeepFM(cfg, seed=0, device=cuda_device)
    fields = torch.from_numpy(ClickStream(vocabs, 300, seed=0).batch_at(0)[0]).to(cuda_device)
    launches = E.embedding_bag.launches
    got = serve_step(model, fields)
    assert E.embedding_bag.launches == launches + 2
    with torch.inference_mode():
        torch.testing.assert_close(
            got, M.deepfm_logits(model, fields, bag=E.embedding_bag_plain), rtol=1e-5, atol=1e-5)
        cpu = M.DeepFM(cfg, device="cpu")
        cpu.load_state_dict(model.state_dict())
        torch.testing.assert_close(got.cpu(), cpu(fields.cpu()), rtol=1e-5, atol=1e-5)
    cands = torch.arange(4000, dtype=torch.int32, device=cuda_device)
    launches = E.embedding_bag.launches
    sc = retrieval_step(model, fields[0], cands, 13)
    assert E.embedding_bag.launches == launches + 2
    with torch.inference_mode():
        want = M.retrieval_score(model, fields[0], cands, 13, bag=E.embedding_bag_plain)
    torch.testing.assert_close(sc, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("B, D", [(0, 10), (5, 0)])
def test_embedding_bag_empty_output_counts_no_launch(cuda_device, B, D):
    table = torch.randn((10, D), device=cuda_device)
    idx = torch.zeros((B, 3), dtype=torch.int32, device=cuda_device)
    launches = E.embedding_bag.launches
    got = E.embedding_bag(table, idx)
    assert got.shape == (B, D) and got.dtype == torch.float32
    assert E.embedding_bag.launches == launches


# --------------------------------------------------------------------------
# the compacted dense partition of a hybrid plan
# --------------------------------------------------------------------------

def _dense_partition(device, T, storage, kind):
    """The dense half of a tile partition of a graph whose block-rows range
    from sparse to dense (a lattice with 0 to 10 extra random edges per
    vertex, by vertex id): "mixed" at the median of the block-rows' largest
    tile nnz, so some block-rows own a dense tile and the others none,
    "empty" above every tile's nnz, so the partition holds only its 8 zero
    padding tiles and `row_starts` is all 0."""
    rng = np.random.default_rng(T)
    n = 150 * 150
    lattice = grid2d(150, 150, seed=T, device="cpu")
    extra = rng.integers(0, 11 * np.arange(n) // n + 1)
    src = np.repeat(np.arange(n), extra)
    dst = np.clip(src + rng.integers(-2 * T, 2 * T, src.shape[0]), 0, n - 1)
    E = lattice.n_edges
    g = from_edges(np.concatenate([lattice.senders[:E].numpy(), src]),
                   np.concatenate([lattice.receivers[:E].numpy(), dst]), n, device=device)
    t = build_block_tiles(g, tile_size=T, storage=storage)
    nnz = tile_nnz(t)[: t.n_tiles]
    row_max = np.zeros(t.n_block_rows, np.int64)
    np.maximum.at(row_max, t.tile_rows[: t.n_tiles].cpu().numpy(), nnz)
    thr = int(np.median(row_max)) if kind == "mixed" else int(nnz.max()) + 1
    dense = partition_tiles(t, thr).dense
    uncovered = int((dense.row_starts[1:] == dense.row_starts[:-1]).sum())
    if kind == "mixed":
        assert dense.n_tiles > 0 and 0 < uncovered < dense.n_block_rows
    else:
        assert dense.n_tiles == 0 and dense.n_tiles_pad == 8
        assert uncovered == dense.n_block_rows
    return dense


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mixed", "empty"])
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [16, 128])
def test_kernels_on_a_dense_partition_on_card(cuda_device, T, storage, kind):
    """The four kernels a hybrid round runs on its dense half, each held to
    its plain version: the split SpMV (exact on a 0/1 RHS, within 1e-5 on
    randn), the split packed SpMV and both neighbour maxes (exact), with
    and without gated columns.  Uncovered block-rows read N_c = 0, no hit,
    and int32 min from both maxes."""
    t = _dense_partition(cuda_device, T, storage, kind)
    uncovered = (t.row_starts[1:] == t.row_starts[:-1]).repeat_interleave(T)
    gen, cand, alive = _frontier(t, cuda_device, 40)
    rhs01, rhs = _rhs_pair(t, gen, LANES, cuda_device)
    cand_w = pack_frontier_words(cand, T)
    for flags in (None, block_col_flags(alive, T)):
        launches = (K.tc_spmv.launches, K.tc_spmv_bits.launches)
        n01 = K.tc_spmv(t, rhs01, col_flags=flags)
        assert torch.equal(n01, K.tc_spmv_plain(t, rhs01, col_flags=flags))
        torch.testing.assert_close(K.tc_spmv(t, rhs, col_flags=flags),
                                   K.tc_spmv_plain(t, rhs, col_flags=flags),
                                   rtol=1e-5, atol=1e-5)
        hit = K.tc_spmv_bits(t, cand_w, col_flags=flags)
        assert torch.equal(hit, K.tc_spmv_bits_plain(t, cand_w, col_flags=flags))
        assert (K.tc_spmv.launches, K.tc_spmv_bits.launches) == (launches[0] + 2,
                                                                 launches[1] + 1)
        assert bool((n01[uncovered] == 0).all())
        assert bool((hit[uncovered.reshape(-1, T)[:, 0]] == 0).all())
    for dense, scan in _hold_maxes(t, alive, *_keys(t.n_padded, gen, cuda_device)):
        assert bool((dense[uncovered] == -(1 << 31)).all()
                    and (scan[uncovered] == -(1 << 31)).all())


# --------------------------------------------------------------------------
# the batched and dynamic routes: gated batch kernels, the covered pass
# --------------------------------------------------------------------------

def _card_batch(device, T, storage, hybrid="off"):
    """A block-diagonal batch of five members (an edgeless one among them)
    on the card, whose bucket leaves padding block-columns that `col_gate`
    zeroes, with each member's H3 priorities under its request key."""
    from repro_torch.api import Plan
    from repro_torch.core import prng
    from repro_torch.serve_mis.batcher import member_priorities, pack_batch, request_key

    rng = np.random.default_rng(T)
    graphs = [grid2d(40, 30, device=device), grid2d(7, 9, device=device),
              from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64), 5, device=device)]
    for n in (700, 333):
        graphs.append(from_edges(rng.integers(0, n, 3 * n), rng.integers(0, n, 3 * n), n,
                                 device=device))
    plans = [Plan.build(g, tile_size=T, storage=storage, hybrid=hybrid, hybrid_threshold=8)
             for g in graphs]
    pris = [member_priorities(p, request_key(prng.key(0), p), "h3") for p in plans]
    batch = pack_batch(plans, pris)
    gate = batch.col_gate
    assert 0 < int(gate.sum()) < gate.numel(), "the bucket should leave gated columns"
    return plans, pris, batch


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [8, 16, 32, 128])
def test_kernels_on_a_gated_batch_on_card(cuda_device, T, storage):
    """All four SpMVs and both maxes on a packed batch, with the column
    flags its `col_gate` zeroes (the engines' `flags * col_gate`), each
    held to its plain version; the padding slots stay dead and unhit."""
    from repro_torch.core.tiling import tiles_as_words

    _, _, batch = _card_batch(cuda_device, T, storage)
    t = batch.tiled
    gen = torch.Generator(device=cuda_device).manual_seed(T)
    alive = batch.alive0 & (torch.rand(t.n_padded, generator=gen, device=cuda_device) < 0.8)
    cand = alive & (torch.rand(t.n_padded, generator=gen, device=cuda_device) < 0.3)
    gate = batch.col_gate
    flags = block_col_flags(cand, T) * gate
    rhs01, rhs = _rhs_pair(t, gen, LANES, cuda_device)
    _check_dense(t, cand, alive, flags, rhs01, rhs)
    words = tiles_as_words(t.tiles, T)
    cand_w, alive_w = pack_frontier_words(cand, T), pack_frontier_words(alive, T)
    fused = K.tc_spmv_fused_bits(t, cand_w, alive_w, tiles_words=words, col_flags=flags)
    for a, b in zip(fused, K.tc_spmv_fused_bits_plain(t, cand_w, alive_w, tiles_words=words,
                                                      col_flags=flags)):
        assert torch.equal(a, b)
    hit = K.tc_spmv_bits(t, cand_w, tiles_words=words, col_flags=flags)
    assert torch.equal(hit, K.tc_spmv_bits_plain(t, cand_w, tiles_words=words, col_flags=flags))
    pad = ~batch.alive0
    assert not bool((fused[1] & pack_frontier_words(pad, T)).any())
    n_c = K.tc_spmv(t, rhs01, col_flags=gate)
    assert bool((n_c[pad] == 0).all())
    _hold_maxes(t, alive, batch.priorities.select, batch.priorities.resolve)


@pytest.mark.gpu
@pytest.mark.parametrize("hybrid", ["off", "forced"])
@pytest.mark.parametrize("engine, phase1", [("fused_pallas", "segment"),
                                            ("fused_pallas", "tiled"),
                                            ("tiled_pallas", "tiled"), ("segment", "segment")])
def test_batched_members_equal_solo_on_card(cuda_device, engine, phase1, hybrid):
    """A batch's loop on the card: each member's MIS and rounds are those of
    its solo solve with its priorities, and of `tiled_ref`'s batch."""
    from repro_torch.api import SolveOptions
    from repro_torch.core.tc_mis import run_tc_mis

    plans, pris, batch = _card_batch(cuda_device, 16, "bitpack", hybrid)
    assert (batch.tiled.partition is not None) == (hybrid == "forced")
    opts = SolveOptions(engine=engine, phase1=phase1)
    kw = dict(priorities=batch.priorities, alive0=batch.alive0, col_gate=batch.col_gate,
              member_rounds=True)
    before = _counts()
    got = run_tc_mis(batch.g, batch.tiled, None, opts, **kw)
    launched = sum(v - before[k] for k, v in _counts().items())
    assert (launched > 0) == (engine != "segment")
    want = run_tc_mis(batch.g, batch.tiled, None,
                      dataclasses.replace(opts, engine="tiled_ref"), **kw)
    assert torch.equal(got.in_mis, want.in_mis) and torch.equal(got.rounds, want.rounds)
    for plan, pri, mis, rnd in zip(plans, pris, batch.unpack(got.in_mis),
                                   batch.unpack(got.rounds)):
        solo = run_tc_mis(plan.g, plan.tiled, None, opts, priorities=pri)
        assert np.array_equal(mis, solo.in_mis.cpu().numpy())
        assert (int(rnd.max()) if rnd.size else 0) == int(solo.rounds)


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
def test_covered_pass_on_an_empty_partition_on_card(cuda_device, storage):
    """The warm start's covered pass runs the engine's kernel over the full
    tiling even when the plan's dense partition holds no tile: the same
    warm state as `tiled_ref`'s plain SpMV, one `tc_spmv` (dense frontier)
    or `tc_spmv_bits` (packed) launch."""
    from repro_torch.api import Plan, SolveOptions, patch_plan
    from repro_torch.dyngraph import random_delta
    from repro_torch.dyngraph.repair import dirty_mask, warm_start

    g = grid2d(200, 200, device=cuda_device)
    plan = Plan.build(g, tile_size=16, storage=storage, hybrid="forced",
                      hybrid_threshold=10 ** 6)
    assert plan.tiled.partition.n_dense_tiles == 0
    d = random_delta(g, n_add=300, n_remove=300, seed=1)
    p1 = patch_plan(plan, d)
    prior = torch.from_numpy(np.random.default_rng(0).random(g.n_nodes) < 0.3).to(cuda_device)
    prior &= ~torch.from_numpy(dirty_mask(g.n_nodes, d.touched())).to(cuda_device)
    # any independent seed set will do: keep the lower-id end of each edge
    s, r = p1.g.senders.long(), p1.g.receivers.long()
    clash = prior[s] & prior[r] & (s > r)
    prior[s[clash]] = False
    dirty = torch.from_numpy(dirty_mask(g.n_nodes, d.touched())).to(cuda_device)
    for phase1, kernel in (("segment", "tc_spmv"), ("tiled", "tc_spmv_bits")):
        if storage == "int8" and phase1 == "tiled":
            kernel = "tc_spmv"    # int8 plans keep the dense frontier
        opts = SolveOptions(engine="fused_pallas", phase1=phase1)
        before = _counts()
        alive, mis = warm_start(p1.g, p1.tiled, opts, prior, dirty)
        torch.cuda.synchronize()
        after = _counts()
        assert {k: after[k] - before[k] for k in after} == {
            k: int(k == kernel) for k in after}
        want = warm_start(p1.g, p1.tiled, dataclasses.replace(opts, engine="tiled_ref"),
                          prior, dirty)
        assert torch.equal(alive, want[0]) and torch.equal(mis, want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("path", [dict(), dict(hybrid="off"),
                                  dict(hybrid="off", phase1="tiled")],
                         ids=["default", "off", "packed"])
def test_update_on_card_equals_tiled_ref(cuda_device, path):
    """`Solver.update` on the card: the tile-local patch equals a rebuild on
    the card, and the incremental repair equals `tiled_ref`'s, valid."""
    from repro_torch.api import Solver, SolveOptions
    from repro_torch.core.validate import is_valid_mis
    from repro_torch.dyngraph import EdgeDelta, apply_graph_delta, random_delta

    g = grid2d(300, 300, device=cuda_device)
    out = {}
    for engine in ("fused_pallas", "tiled_ref"):
        solver = Solver(SolveOptions(engine=engine, repair="incremental", **path),
                        device=cuda_device)
        prior = solver.solve(g)
        d = random_delta(g, n_add=900, n_remove=900, seed=2)
        res = solver.update(prior, d)
        assert res.stats["repair"] == "incremental" and res.converged
        assert is_valid_mis(res.plan.g, torch.from_numpy(res.in_mis_plan).to(cuda_device))
        rebuilt = build_block_tiles(apply_graph_delta(g, d), tile_size=res.plan.tile_size,
                                    storage=res.plan.storage)
        for name in ("tiles", "tile_rows", "tile_cols", "row_starts"):
            assert torch.equal(getattr(res.plan.tiled, name), getattr(rebuilt, name))
        out[engine] = res
        same = solver.update(prior, EdgeDelta.make())
        assert same.rounds == 0 and np.array_equal(same.in_mis, prior.in_mis)
    assert out["fused_pallas"].rounds == out["tiled_ref"].rounds
    assert np.array_equal(out["fused_pallas"].in_mis, out["tiled_ref"].in_mis)


@pytest.mark.gpu
def test_plan_cache_disk_layer_loads_onto_the_card(cuda_device, tmp_path):
    from repro_torch.api import PlanCache

    g = grid2d(120, 120, device=cuda_device)
    a, st = PlanCache(tile_size=16, storage="bitpack", cache_dir=str(tmp_path)).plan(
        g, hybrid="auto")
    b, st2 = PlanCache(tile_size=16, storage="bitpack", cache_dir=str(tmp_path)).plan(
        g.to("cpu"), hybrid="auto")
    assert (st, st2) == ("built", "disk") and b.device == a.device
    for name in ("tiles", "tile_rows", "tile_cols", "row_starts"):
        assert torch.equal(getattr(a.tiled, name), getattr(b.tiled, name))
    assert torch.equal(a.tiled.partition.tail_rows, b.tiled.partition.tail_rows)


@pytest.mark.gpu
@pytest.mark.parametrize("phase1", ["segment", "tiled"])
def test_service_window_and_update_on_card_equal_tiled_ref(cuda_device, phase1):
    """`MISService` on the card: a mixed window (files and graphs, two
    (T, storage) groups) and one update, each response valid and equal,
    in MIS and rounds, to the same service on `tiled_ref`; the window
    launched the kernels of its path."""
    import os

    from repro_torch.dyngraph import random_delta
    from repro_torch.graphs.generators import erdos_renyi, powerlaw
    from repro_torch.serve_mis import MISService, ServeConfig

    fixtures = os.path.join(os.path.dirname(__file__), "fixtures")
    graphs = [grid2d(40, 40, device=cuda_device), erdos_renyi(900, 6.0, seed=1, device=cuda_device),
              powerlaw(1200, 4.0, seed=2, device=cuda_device)]
    out = {}
    for engine in ("fused_pallas", "tiled_ref"):
        svc = MISService(ServeConfig(engine=engine, phase1=phase1, max_batch=8,
                                     repair="incremental"), device=cuda_device)
        ids = [svc.submit(os.path.join(fixtures, f)) for f in ("tiny.mtx", "tiny.dimacs")]
        ids += [svc.submit(g) for g in graphs]
        before = _counts()
        window = svc.step()
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in _counts().items() if v > before[k]}
        svc.submit_update(ids[2], random_delta(graphs[0], n_add=20, n_remove=20, seed=3))
        (upd,) = svc.drain()
        assert all(r.valid for r in window + [upd])
        assert upd.stats["repair"] == "incremental" and upd.stats["base_id"] == ids[2]
        assert all(r.stats["batch_size"] == 5 for r in window)
        out[engine] = (window + [upd], launched)
    (got, launched), (want, plain) = out["fused_pallas"], out["tiled_ref"]
    for a, b in zip(got, want):
        assert (a.id, a.rounds) == (b.id, b.rounds)
        assert np.array_equal(a.in_mis, b.in_mis)
    # the int8 group runs the fused SpMV, the partitioned bitpack group the
    # split one; a batch's frontier is dense, so phase ① is the dense max
    want_kernels = {"tc_spmv", "tc_spmv_fused"} | ({"tc_neighbor_max"} if phase1 == "tiled"
                                                   else set())
    assert not plain and set(launched) == want_kernels


@pytest.mark.gpu
def test_serving_cli_once_on_card(cuda_device, tmp_path):
    """`python -m repro_torch.serve_mis --once` on the fixtures, on the
    card by default: every response line valid, exit 0."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fixtures = [os.path.join(repo, "tests", "fixtures", f)
                for f in ("tiny.mtx", "tiny.edges", "tiny.dimacs")]
    delta = tmp_path / "g.delta"
    delta.write_text("+ 0 9\n- 0 1\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve_mis", "--once", "--repeat", "2",
         "--update", f"0:{delta}", "--metrics-path", str(tmp_path / "m.prom"), *fixtures],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(l) for l in proc.stdout.splitlines() if l.startswith("{")]
    assert len(lines) == 7 and all(r["valid"] for r in lines)
    assert lines[-1]["base_id"] == 0 and lines[-1]["repair"] == "incremental"
    assert "repro_service_requests_total 7" in (tmp_path / "m.prom").read_text()


# --------------------------------------------------------------------------
# the sharded route's slabs, the tiled wrappers, the one-rank route
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("T", [16, 64])
@pytest.mark.parametrize("n_shards", [3, 4])
def test_split_spmv_on_non_square_slabs_on_card(cuda_device, n_shards, T, storage):
    """The split SpMV on each rows_per_shard x nbr_pad slab of a sharded
    tiling, gated by a candidate set over the global columns: exact on the
    0/1 lanes, within 1e-5 on a random f32 RHS."""
    from repro_torch.core.distributed import shard_tiled

    t = _card_tiling(cuda_device, T, storage)
    sh = shard_tiled(t, n_shards)
    gen = torch.Generator(device=cuda_device).manual_seed(n_shards)
    alive = torch.rand(sh.n_padded, generator=gen, device=cuda_device) < 0.7
    cand = alive & (torch.rand(sh.n_padded, generator=gen, device=cuda_device) < 0.3)
    flags = block_col_flags(cand, T)
    rhs = torch.zeros((sh.n_padded, LANES), device=cuda_device)
    rhs[:, 0], rhs[:, 1] = cand, alive
    noise = torch.randn((sh.n_padded, LANES), generator=gen, device=cuda_device)
    for s in range(n_shards):
        slab = sh.slab(s)
        assert slab.n_block_rows < slab.n_block_cols
        launches = K.tc_spmv.launches
        assert torch.equal(K.tc_spmv(slab, rhs, col_flags=flags),
                           K.tc_spmv_plain(slab, rhs, col_flags=flags))
        assert K.tc_spmv.launches == launches + 1
        torch.testing.assert_close(K.tc_spmv(slab, noise, col_flags=flags),
                                   K.tc_spmv_plain(slab, noise, col_flags=flags),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
def test_tiled_wrappers_at_gin_width_on_card(cuda_device, storage):
    """`spmv_tiled(backend="pallas")` at L = 64 (GIN's hidden width) within
    1e-5 of the plain version; `neighbor_max_tiled(backend="pallas")` exact."""
    from repro_torch.core import spmv

    t = _card_tiling(cuda_device, 16, storage)
    gen = torch.Generator(device=cuda_device).manual_seed(64)
    h = torch.randn((t.n_padded, 64), generator=gen, device=cuda_device)
    launches = K.tc_spmv.launches
    got = spmv.spmv_tiled(t, h, backend="pallas")
    assert K.tc_spmv.launches == launches + 1
    torch.testing.assert_close(got, K.tc_spmv_plain(t, h), rtol=1e-5, atol=1e-5)
    p = torch.randint(-(1 << 30), 1 << 30, (t.n_padded,), generator=gen, device=cuda_device,
                      dtype=torch.int32)
    mask = torch.rand(t.n_padded, generator=gen, device=cuda_device) < 0.5
    assert torch.equal(spmv.neighbor_max_tiled(t, p, mask, backend="pallas"),
                       N.tc_neighbor_max_plain(t, p, mask))


@pytest.mark.gpu
def test_sharded_solve_on_one_nccl_rank_equals_local(cuda_device):
    """`placement="sharded"` on the card: a one-rank NCCL group, the split
    SpMV once a round, the MIS and rounds of the local route."""
    import torch.distributed as dist

    from repro_torch.api import Solver, SolveOptions

    g = grid2d(90, 90, device=cuda_device)
    try:
        solver = Solver(SolveOptions(placement="sharded", tile_size=16), device=cuda_device)
        launches = K.tc_spmv.launches
        res = solver.solve(g)
        assert K.tc_spmv.launches == launches + res.rounds
        assert dist.get_backend() == "nccl"
    finally:
        dist.destroy_process_group()
    want = Solver(SolveOptions(placement="local", tile_size=16), device=cuda_device).solve(g)
    assert (res.placement, res.stats["n_shards"]) == ("sharded", 1)
    assert res.rounds == want.rounds and np.array_equal(res.in_mis, want.in_mis)


# --------------------------------------------------------------------------
# the GNN family: GIN's multi-lane split SpMV, GIN tiled, the sampler
# --------------------------------------------------------------------------

def _gin_graph(device):
    """full_graph_sm's degree (2·10,556 / 2,708) on a tenth of its vertices."""
    from repro_torch.graphs.generators import erdos_renyi

    return erdos_renyi(271, avg_deg=2 * 10556 / 2708, seed=0, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1433, 64, 3])
@pytest.mark.parametrize("T", [16, 32])
def test_split_spmv_at_gin_widths_on_card(cuda_device, T, lanes):
    """GIN's layer-1 width (odd, 180 lane passes), its hidden width and an
    odd few: a 0/1 RHS exact, randn within 1e-5."""
    t = build_block_tiles(_gin_graph(cuda_device), tile_size=T)
    gen = torch.Generator(device=cuda_device).manual_seed(lanes)
    rhs01 = (torch.rand((t.n_padded, lanes), generator=gen, device=cuda_device) < 0.5).float()
    assert torch.equal(K.tc_spmv(t, rhs01), K.tc_spmv_plain(t, rhs01))
    rhs = torch.randn((t.n_padded, lanes), generator=gen, device=cuda_device)
    torch.testing.assert_close(K.tc_spmv(t, rhs), K.tc_spmv_plain(t, rhs), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [16, 32])
def test_gin_tiled_forward_on_card(cuda_device, T):
    """GIN's tiled forward on the card, one split-SpMV launch a layer,
    against its segment forward (scale-normalised 1e-4); it refuses to
    differentiate."""
    from repro_torch.models.gnn import GIN

    g = _gin_graph(cuda_device)
    t = build_block_tiles(g, tile_size=T)
    feats = torch.randn((g.n_nodes, 1433), generator=torch.Generator(
        device=cuda_device).manual_seed(T), device=cuda_device)
    model = GIN(1433, 64, 5, 7, device=cuda_device)
    args = (feats, g.senders, g.receivers, g.edge_mask)
    with torch.no_grad():
        launches = K.tc_spmv.launches
        h, out = model(*args, tiled=t, backend="tiled")
        assert K.tc_spmv.launches == launches + 5
        h_seg, out_seg = model(*args)
    for a, b in ((h, h_seg), (out, out_seg)):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-4
    with pytest.raises(RuntimeError, match="no gradient"):
        model(*args, tiled=t, backend="tiled")


@pytest.mark.gpu
def test_sampler_on_card(cuda_device):
    """The CSR built on the card equals the host `build_csr`; every
    masked-in slot of a sample and of the minibatch cell's tree is a CSR
    neighbour of its parent."""
    from repro_torch.configs import gnn_cells as C
    from repro_torch.graphs.generators import erdos_renyi
    from repro_torch.graphs.graph import build_csr
    from repro_torch.core import prng
    from repro_torch.graphs.sampler import NeighborSampler

    g = erdos_renyi(5000, avg_deg=3.0, seed=1, device=cuda_device)
    sampler = NeighborSampler(g, (15, 10))
    indptr, indices = build_csr(g)
    assert np.array_equal(sampler.indptr.cpu().numpy(), indptr)
    assert np.array_equal(sampler.indices.cpu().numpy(), indices)
    nbrs = [set(indices[indptr[v]:indptr[v + 1]].tolist()) for v in range(g.n_nodes)]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    seeds = torch.randperm(g.n_nodes, generator=gen, device=cuda_device)[:64].to(torch.int32)
    sub = sampler.sample(prng.key(0), seeds)
    pairs = []
    for k in range(1, len(sub.layers)):
        parent = sub.layers[k - 1][..., None].expand(sub.layers[k].shape)
        m = sub.masks[k]
        pairs += zip(parent[m].tolist(), sub.layers[k][m].tolist())
    ids, snd, rcv, emask = C.minibatch_tree(sampler.indptr, sampler.indices, seeds,
                                            C.minibatch_draws(prng.key(1), 64, (15, 10),
                                                              cuda_device))
    pairs += zip(ids[rcv.long()][emask].tolist(), ids[snd.long()][emask].tolist())
    assert pairs and all(c in nbrs[p] for p, c in pairs)


LM_CPU_TOL = 1e-5       # the LM on the card against the LM on the CPU, f32 logits


def _lm_serve_trace(params, cfg, prompts, steps, monkeypatch):
    """Prefill `prompts`, then feed `steps` (B, n) teacher-forced; returns
    the logits of every call and the expert ids of every MoE call."""
    from repro_torch.configs import lm_cells as C
    from repro_torch.models import moe

    experts = []
    assign = moe.assign_slots

    def recording(e, n_experts, capacity):
        experts.append(e.cpu())
        return assign(e, n_experts, capacity)

    monkeypatch.setattr(moe, "assign_slots", recording)
    logits, cache = C.prefill_step(params, cfg, prompts, max_len=prompts.shape[1] + steps.shape[1])
    out = [logits.cpu()]
    for i in range(steps.shape[1]):
        logits, cache = C.serve_step(params, cfg, cache, steps[:, i])
        out.append(logits.cpu())
    monkeypatch.setattr(moe, "assign_slots", assign)
    return out, experts


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "mixtral-8x22b", "nemotron-4-340b",
                                  "qwen1.5-0.5b", "qwen3-0.6b"])
def test_lm_serving_on_card_equals_cpu(cuda_device, arch, monkeypatch):
    from repro_torch.configs import LM_ARCHS
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import transformer as tf

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = LM_ARCHS[arch].SMOKE
    params = tf.init_lm(prng.key(0), cfg, device="cpu")
    tree = {}

    def to_numpy(src, dst):
        for k, v in src.items():
            if isinstance(v, dict):
                to_numpy(v, dst.setdefault(k, {}))
            else:
                dst[k] = v.numpy()

    to_numpy(params, tree)
    card = tf.lm_params_from_numpy(tree, cfg, device=cuda_device)
    toks = torch.from_numpy(TokenStream(cfg.vocab, 2, 16, seed=17).batch_at(0)[0])
    prompts, steps = toks[:, :12], toks[:, 12:]
    cpu_logits, cpu_experts = _lm_serve_trace(params, cfg, prompts, steps, monkeypatch)
    card_logits, card_experts = _lm_serve_trace(card, cfg, prompts.to(cuda_device),
                                                steps.to(cuda_device), monkeypatch)
    for got, want in zip(card_logits, cpu_logits):
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= LM_CPU_TOL
    assert len(card_experts) == len(cpu_experts) == (0 if cfg.moe is None else
                                                     5 * (cfg.n_layers - cfg.n_dense_layers))
    assert all(torch.equal(a, b) for a, b in zip(card_experts, cpu_experts))


def _host_leaves(tree):
    from repro_torch.train import tree as T

    return [t.detach().cpu() for t in T.leaves(tree)]


@pytest.mark.gpu
def test_lm_train_step_on_card_equals_cpu(cuda_device, monkeypatch):
    """qwen3-0.6b at full width, 2 of 28 layers, in f32: one train step
    (B 1, S 128) on the card and on the CPU from the same weights."""
    from repro_torch.configs import LM_ARCHS
    from repro_torch.configs import lm_cells as C
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import transformer as tf
    from repro_torch.train import OptConfig, adamw_init
    from repro_torch.train import tree as T

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(LM_ARCHS["qwen3-0.6b"].CONFIG, n_layers=2, dtype=torch.float32)
    params = tf.init_lm(prng.key(0), cfg, device="cpu")
    card = T.tree_map(lambda t: t.to(cuda_device), params)
    toks, tgts = (torch.from_numpy(a)
                  for a in TokenStream(cfg.vocab, 1, 128, seed=17).batch_at(0))
    step = C.make_lm_train_step(cfg, OptConfig(total_steps=10000))
    want_p, want_o, want_loss, _ = step(params, adamw_init(params), toks, tgts)
    got_p, got_o, loss, _ = step(card, adamw_init(card), toks.to(cuda_device),
                                 tgts.to(cuda_device))
    assert abs(float(loss) - float(want_loss)) <= LM_CPU_TOL * (1 + abs(float(want_loss)))
    got = _host_leaves(got_p) + _host_leaves(got_o.m) + _host_leaves(got_o.v)
    want = _host_leaves(want_p) + _host_leaves(want_o.m) + _host_leaves(want_o.v)
    for a, b in zip(got, want):
        assert float(((a - b).abs() - LM_CPU_TOL * (1 + b.abs())).max()) <= 0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v3-671b"])
def test_lm_remat_modes_agree_on_card(cuda_device, arch):
    from repro_torch.configs import LM_ARCHS
    from repro_torch.configs import lm_cells as C
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(LM_ARCHS[arch].SMOKE, dtype=torch.bfloat16)
    params = tf.init_lm(prng.key(0), cfg, device=cuda_device)
    toks, tgts = (torch.from_numpy(a).to(cuda_device)
                  for a in TokenStream(cfg.vocab, 2, 64, seed=17).batch_at(0))
    runs = [C.lm_loss_and_grads(params, dataclasses.replace(cfg, remat=r, remat_policy=p),
                                toks, tgts)
            for r, p in ((False, "full"), (True, "full"), (True, "dots"))]
    want_loss, _, want = runs[0]
    for loss, _, grads in runs[1:]:
        assert abs(float(loss) - float(want_loss)) <= 1e-6 * abs(float(want_loss))
        for g, w in zip(_host_leaves(grads), _host_leaves(want)):
            g, w = g.float(), w.float()
            assert float((g - w).abs().max()) <= 1e-6 * max(float(w.abs().max()), 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 512])
def test_flash_attention_out_of_place_equals_in_place_on_card(cuda_device, window):
    """qwen3-0.6b's attention shape (16 heads over 8 KV heads, d 128, bf16)
    at S 2,048: the forward autograd records equals the serving one."""
    from repro_torch.models.attention import flash_attention

    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(1, 2048, h, 128, generator=g, device=cuda_device).to(torch.bfloat16)
               for h in (16, 8, 8))
    with torch.no_grad():
        served = flash_attention(q, k, v, window=window)
    trained = flash_attention(q.requires_grad_(), k, v, window=window)
    assert trained.requires_grad
    assert torch.equal(served, trained.detach())


def test_lm_entry_points_raise_on_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.configs import LM_ARCHS
    from repro_torch.core import prng
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    cfg = LM_ARCHS["qwen3-0.6b"].SMOKE
    with pytest.raises(RuntimeError, match="cuda"):
        tf.init_decode_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        tf.lm_params_from_numpy({}, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        tf.init_lm(prng.key(0), cfg)


# --------------------------------------------------------------------------
# the Threefry draws
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["bits", "uniform"])
@pytest.mark.parametrize("n", [1, 2, 3, 1023, 300_000, (1 << 20) + 17])
def test_threefry_matches_plain_on_card(cuda_device, n, mode):
    from repro_torch.hopper import threefry as TF

    for k0, k1 in ((0, 0), (0, 0xFFFFFFFF), (0x9E3779B9, 0x7F4A7C15)):
        before = TF.threefry_bits.launches
        got = TF.threefry_bits(k0, k1, n, cuda_device, mode)
        torch.cuda.synchronize()
        assert TF.threefry_bits.launches == before + 1
        want = TF.threefry_bits(k0, k1, n, "cpu", mode)
        assert got.dtype == want.dtype and got.shape == (n,)
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def _ordered_f32(t: torch.Tensor) -> torch.Tensor:
    b = t.cpu().view(torch.int32).long()
    return torch.where(b < 0, -(b & 0x7FFFFFFF), b)


@pytest.mark.gpu
@pytest.mark.parametrize("start", [0, (1 << 32) - 5, 3 << 32])
@pytest.mark.parametrize("n", [1, 1023, (1 << 20) + 17])
def test_threefry_modes_from_a_start_match_plain_on_card(cuda_device, n, start):
    """The kernel's bits, ranged uniforms and normals from a start counter
    against the plain version as torch ops on the card and on the host:
    bit for bit, the normals within 4 ulp; written into a slice of a larger
    tensor (`out=`), the same bits and nothing outside it."""
    from repro_torch.hopper import threefry as TF

    for mode, lo, hi in (("bits", 0.0, 1.0), ("uniform", 0.0, 1.0), ("uniform", -3.5, 2.25),
                         ("normal", 0.0, 1.0)):
        before = TF.threefry_bits.launches
        got = TF.threefry_bits(0x9E3779B9, 0x7F4A7C15, n, cuda_device, mode, start=start,
                               minval=lo, maxval=hi)
        torch.cuda.synchronize()
        assert TF.threefry_bits.launches == before + 1
        on_card = TF.threefry_bits_plain(0x9E3779B9, 0x7F4A7C15, torch.empty_like(got), mode,
                                         start=start, minval=lo, maxval=hi)
        on_host = TF.threefry_bits(0x9E3779B9, 0x7F4A7C15, n, "cpu", mode, start=start,
                                   minval=lo, maxval=hi)
        for want in (on_card.cpu(), on_host):
            if mode == "normal":
                assert int((_ordered_f32(got) - _ordered_f32(want)).abs().max()) <= 4
            else:
                assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
        into = torch.zeros(n + 2, dtype=got.dtype, device=cuda_device)
        TF.threefry_bits(0x9E3779B9, 0x7F4A7C15, n, cuda_device, mode, start=start, minval=lo,
                         maxval=hi, out=into[1:-1])
        assert torch.equal(into[1:-1].view(torch.int32), got.view(torch.int32))
        assert int(into[0]) == int(into[-1]) == 0


@pytest.mark.gpu
def test_threefry_empty_draw_launches_nothing_on_card(cuda_device):
    from repro_torch.hopper import threefry as TF

    before = TF.threefry_bits.launches
    assert TF.threefry_bits(1, 2, 0, cuda_device).shape == (0,)
    assert TF.threefry_bits.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("heuristic", ["h1", "h2", "h3", "ecl"])
def test_priorities_on_card_equal_the_cpu_draw(cuda_device, heuristic):
    """One key gives one draw on either device: the priorities (through
    the kernel, the permutation's sorts on the card) and Luby's integers."""
    from repro_torch.core import prng
    from repro_torch.core.heuristics import make_priorities

    g = grid2d(70, 40, device="cpu")
    key = prng.fold_in(prng.key(9), 4)
    want = make_priorities(heuristic, key, g.n_nodes, g.degrees())
    got = make_priorities(heuristic, key, g.n_nodes, g.degrees().to(cuda_device))
    assert torch.equal(got.select.cpu(), want.select)
    if heuristic == "h3":
        assert torch.equal(got.resolve.cpu(), want.resolve)
    assert torch.equal(prng.randint(key, 5000, 0, (1 << 31) - 1, cuda_device).cpu(),
                       prng.randint(key, 5000, 0, (1 << 31) - 1, "cpu"))
