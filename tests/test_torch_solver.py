"""The port's convergence loop, engines, heuristics, plan and Solver against
the JAX reference.  The engine cases hand the reference's priorities (and
its plan arrays) over as numpy and demand identical `in_mis` and `rounds`;
`Solver.solve` on the suite graphs is held to the reference's from the
seed alone (the port draws the reference's bits, `core.prng`).
The reference side runs its `tiled_ref` / `segment` engines here;
tests/test_engine.py holds the reference's Pallas engines to those, and
test_torch_spmv.py holds the port's kernels' plain versions to the Pallas
kernels in interpret mode."""
import functools
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import SolveOptions as RefOptions
from repro.api.plan import Plan as RefPlan
from repro.api.plan import choose_tile_size as ref_choose_tile_size
from repro.api.plan import graph_content_key as ref_graph_content_key
from repro.api.plan import plan_cache_key as ref_plan_cache_key
from repro.api.plan import resolve_storage as ref_resolve_storage
from repro.core import engine as ref_engine
from repro.core import heuristics as ref_heur
from repro.core import spmv as ref_spmv
from repro.core.tc_mis import _tc_mis_impl
from repro.api import Solver as RefSolver
from repro.graphs.generators import GRAPH_SUITE as REF_SUITE
from repro.graphs.graph import from_edges as ref_from_edges
from repro_torch.api import Solver, SolveOptions, plan_from_arrays
from repro_torch.api import plan as port_plan
from repro_torch.core import engine as port_engine
from repro_torch.core import heuristics as heur
from repro_torch.core import prng
from repro_torch.core import spmv
from repro_torch.core.heuristics import Priorities
from repro_torch.core.tc_mis import _setup, run_tc_mis
from repro_torch.core.validate import cardinality, is_independent, is_maximal, is_valid_mis
from repro_torch.graphs.graph import from_edges

PORT_ENGINES = ("segment", "tiled_ref", "tiled_pallas", "fused_pallas")
TILE_ENGINES = PORT_ENGINES[1:]
HEURISTICS = ("h1", "h2", "h3", "ecl")
FRONTIERS = ("auto", "dense", "bitwise")


def _edges(kind):
    rng = np.random.default_rng(11)
    if kind == "clustered":   # empty block-rows, isolated vertices
        n, hi = 150, 50
        return rng.integers(0, hi, 4 * hi), rng.integers(0, hi, 4 * hi), n
    n = 260
    return rng.integers(0, n, 3 * n), rng.integers(0, n, 3 * n), n


def _plan_arrays(ref_plan):
    """A reference plan's arrays in the reference's npz cache layout."""
    g, t = ref_plan.g, ref_plan.tiled
    return dict(
        senders=np.asarray(g.senders)[: g.n_edges],
        receivers=np.asarray(g.receivers)[: g.n_edges],
        tiles=np.asarray(t.tiles),
        tile_rows=np.asarray(t.tile_rows),
        tile_cols=np.asarray(t.tile_cols),
        row_starts=np.asarray(t.row_starts),
        meta=np.asarray([g.n_nodes, g.n_edges, t.n_tiles, t.tile_size,
                         t.n_block_rows, t.n_block_cols, 3,
                         ("int8", "bitpack").index(t.storage), 0, 0], np.int64),
    )


@functools.lru_cache(maxsize=None)
def _reference(kind, T, storage, heuristic, phase1="segment", frontier="auto"):
    """(ref plan, numpy priorities, ref in_mis, ref rounds) — the reference
    solved on its `tiled_ref` engine under jax.random.key(7)."""
    src, dst, n = _edges(kind)
    plan = RefPlan.build(ref_from_edges(src, dst, n), tile_size=T, storage=storage)
    pri = ref_heur.make_priorities(heuristic, jax.random.key(7), n, plan.g.degrees())
    opts = RefOptions(engine="tiled_ref", heuristic=heuristic, phase1=phase1,
                      frontier=frontier)
    res = _tc_mis_impl(plan.g, plan.tiled, jax.random.key(7), opts, priorities=pri)
    pri_np = (np.asarray(pri.select),
              None if pri.resolve is None else np.asarray(pri.resolve))
    return plan, pri_np, np.asarray(res.in_mis), int(res.rounds)


def _port_priorities(pri_np):
    sel, res = pri_np
    return Priorities(torch.tensor(sel), None if res is None else torch.tensor(res))


@pytest.mark.parametrize("heuristic", HEURISTICS)
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_every_port_engine_matches_reference(engine, storage, heuristic):
    ref_plan, pri_np, want_mis, want_rounds = _reference("random", 16, storage, heuristic)
    plan = plan_from_arrays(_plan_arrays(ref_plan), device="cpu")
    res = run_tc_mis(plan.g, plan.tiled, None,
                     SolveOptions(engine=engine, heuristic=heuristic),
                     priorities=_port_priorities(pri_np))
    np.testing.assert_array_equal(res.in_mis.numpy(), want_mis)
    assert int(res.rounds) == want_rounds
    assert bool(res.converged) and is_valid_mis(plan.g, res.in_mis)


@pytest.mark.parametrize("T", [8, 32])
@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_clustered_graph_matches_reference(engine, T):
    """Empty block-rows and isolated vertices: the kernels' uncovered-row
    rule must fire, and every isolated vertex joins the MIS."""
    ref_plan, pri_np, want_mis, want_rounds = _reference("clustered", T, "bitpack", "h3")
    plan = plan_from_arrays(_plan_arrays(ref_plan), device="cpu")
    res = run_tc_mis(plan.g, plan.tiled, None, SolveOptions(engine=engine),
                     priorities=_port_priorities(pri_np))
    np.testing.assert_array_equal(res.in_mis.numpy(), want_mis)
    assert int(res.rounds) == want_rounds
    isolated = (plan.g.degrees() == 0).numpy()
    assert isolated.any() and res.in_mis.numpy()[isolated].all()


@pytest.mark.parametrize("storage", ["int8", "bitpack"])
def test_tiled_phase1_matches_reference_and_hopper_engines_refuse_it(storage):
    """Parity of `phase1="tiled"` on every tile engine, on both frontiers,
    against the reference on the clustered graph; the Hopper engines run
    it on their neighbour-max kernels.  The name's "refuse" is historical
    and kept so the test keeps its history; nothing refuses here."""
    for frontier in ("dense", "auto"):
        ref_plan, pri_np, want_mis, want_rounds = _reference(
            "clustered", 16, storage, "h3", phase1="tiled", frontier=frontier
        )
        plan = plan_from_arrays(_plan_arrays(ref_plan), device="cpu")
        pri = _port_priorities(pri_np)
        for engine in TILE_ENGINES:
            res = run_tc_mis(plan.g, plan.tiled, None,
                             SolveOptions(engine=engine, phase1="tiled", frontier=frontier),
                             priorities=pri)
            np.testing.assert_array_equal(res.in_mis.numpy(), want_mis, err_msg=engine)
            assert int(res.rounds) == want_rounds, engine


@pytest.mark.parametrize("phase1", ["segment", "tiled"])
@pytest.mark.parametrize("frontier", FRONTIERS)
@pytest.mark.parametrize("storage", ["int8", "bitpack"])
@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_every_engine_frontier_and_phase1_matches_reference(engine, storage, frontier, phase1):
    ref_plan, pri_np, want_mis, want_rounds = _reference(
        "random", 16, storage, "h3", phase1=phase1, frontier=frontier)
    plan = plan_from_arrays(_plan_arrays(ref_plan), device="cpu")
    opts = SolveOptions(engine=engine, phase1=phase1, frontier=frontier)
    res = run_tc_mis(plan.g, plan.tiled, None, opts, priorities=_port_priorities(pri_np))
    np.testing.assert_array_equal(res.in_mis.numpy(), want_mis)
    assert int(res.rounds) == want_rounds
    assert bool(res.converged) and res.in_mis.dtype == torch.bool


@pytest.mark.parametrize("heuristic", HEURISTICS)
@pytest.mark.parametrize("engine", TILE_ENGINES)
def test_bitwise_path_matches_reference_for_every_heuristic(engine, heuristic):
    """The plane scan assumes select keys fit 31 unsigned bits: every
    heuristic's keys go through it (Hopper engines) and the clz form."""
    ref_plan, pri_np, want_mis, want_rounds = _reference(
        "random", 16, "bitpack", heuristic, phase1="tiled")
    plan = plan_from_arrays(_plan_arrays(ref_plan), device="cpu")
    opts = SolveOptions(engine=engine, heuristic=heuristic, phase1="tiled")
    _, ctx, _, _ = _setup(plan.g, plan.tiled, None, opts, _port_priorities(pri_np))
    assert ctx.frontier == "bitwise"
    assert (ctx.bits.select_planes is not None) == (engine != "tiled_ref")
    assert pri_np[0].min() >= 0
    res = run_tc_mis(plan.g, plan.tiled, None, opts, priorities=_port_priorities(pri_np))
    np.testing.assert_array_equal(res.in_mis.numpy(), want_mis)
    assert int(res.rounds) == want_rounds


@pytest.mark.parametrize("T", [8, 32])
@pytest.mark.parametrize("engine", TILE_ENGINES)
def test_bitwise_path_on_clustered_graph_matches_reference(engine, T):
    """Empty block-rows on the packed frontier: hit 0, Max_Np int32 min."""
    ref_plan, pri_np, want_mis, want_rounds = _reference(
        "clustered", T, "bitpack", "h3", phase1="tiled")
    plan = plan_from_arrays(_plan_arrays(ref_plan), device="cpu")
    res = run_tc_mis(plan.g, plan.tiled, None, SolveOptions(engine=engine, phase1="tiled"),
                     priorities=_port_priorities(pri_np))
    np.testing.assert_array_equal(res.in_mis.numpy(), want_mis)
    assert int(res.rounds) == want_rounds


class _PlanePathJax:
    """`jax` as `repro.core.tc_mis` sees it, with `default_backend()`
    saying "tpu": the reference then builds the priority planes and its
    Pallas engines run their plane-scan kernel.  Every other attribute is
    jax's own, and `repro.kernels.ops` keeps the real module, so the
    Pallas calls still run in interpret mode."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


def _complete_bipartite_probe():
    """K_{16,16} (vertices 0-15 x 16-31), H3 keys select 0 and resolve
    -2^30 - 1 - id: every vertex ties on select, and every resolve key lies
    below _NEG, on tile rows whose 16 cells are all live edges."""
    a, b = np.meshgrid(np.arange(16), np.arange(16, 32))
    n = 32
    sel = np.zeros(n, np.int32)
    res = (-(1 << 30) - 1 - np.arange(n)).astype(np.int32)
    return a.ravel(), b.ravel(), n, sel, res


@pytest.mark.parametrize("storage, frontier", [("int8", "dense"), ("bitpack", "bitwise")])
@pytest.mark.parametrize("engine", PORT_ENGINES)
def test_phase1_floor_matches_reference_engine_of_the_same_name(engine, storage, frontier,
                                                                monkeypatch):
    """Each port engine against the reference engine of the same name on
    the K_{16,16} probe, tiled phase ①, at most 8 rounds.  The Pallas
    neighbour maxes start every covered row at _NEG, so under the Pallas
    engines no resolve key beats its neighbours' max and nothing joins
    the MIS in 8 rounds; `segment` and `tiled_ref` keep the keys below
    _NEG and finish in one round.

    On the packed frontier the reference is run on its plane path, the
    path of the `_nbr_max_bits_kernel` that the port's plane scan ports:
    on the CPU the reference takes its clz form instead, which builds no
    planes and keeps the keys below _NEG like `tiled_ref`, so there its
    Pallas engines would finish in one round."""
    from repro.core.heuristics import Priorities as RefPriorities

    src, dst, n, sel, res = _complete_bipartite_probe()
    ref_plan = RefPlan.build(ref_from_edges(src, dst, n), tile_size=16, storage=storage)
    kw = dict(engine=engine, heuristic="h3", phase1="tiled", frontier=frontier, max_rounds=8)
    if frontier == "bitwise":
        monkeypatch.setattr(importlib.import_module("repro.core.tc_mis"), "jax",
                            _PlanePathJax())
    want = _tc_mis_impl(ref_plan.g, ref_plan.tiled, jax.random.key(0), RefOptions(**kw),
                        priorities=RefPriorities(jnp.asarray(sel), jnp.asarray(res)))
    plan = plan_from_arrays(_plan_arrays(ref_plan), device="cpu")
    got = run_tc_mis(plan.g, plan.tiled, None, SolveOptions(**kw),
                     priorities=Priorities(torch.tensor(sel), torch.tensor(res)))
    np.testing.assert_array_equal(got.in_mis.numpy(), np.asarray(want.in_mis))
    assert int(got.rounds) == int(want.rounds)
    pallas = engine in ("tiled_pallas", "fused_pallas")
    assert (int(got.in_mis.sum()), int(got.rounds)) == ((0, 8) if pallas else (16, 1))


def _warm_state(g, t):
    """A prior independent set with its closed neighbourhood dead, and the
    last block-column's vertices dead and gated off (as a batch bucket's
    empty slots are): (alive0, in_mis0, col_gate) as numpy."""
    n = g.n_nodes
    rng = np.random.default_rng(3)
    prior = np.zeros(n, bool)
    prior[rng.choice(n, 20, replace=False)] = True
    s, r = np.asarray(g.senders)[: g.n_edges], np.asarray(g.receivers)[: g.n_edges]
    for v in np.flatnonzero(prior):
        if prior[r[s == v]].any():
            prior[v] = False
    last = (t.n_block_cols - 1) * t.tile_size
    prior[last:] = False
    covered = prior.copy()
    covered[r[np.isin(s, np.flatnonzero(prior))]] = True
    covered[last:] = True
    gate = np.ones(t.n_block_cols, np.int32)
    gate[-1] = 0
    return ~covered, prior, gate


@pytest.mark.parametrize("engine", TILE_ENGINES)
def test_packed_warm_start_seams_match_reference(engine):
    """alive0 / in_mis0 handed over as packed words pass through `_setup`
    on the bitwise frontier, as the reference's repair path hands them."""
    from repro.core.tiling import pack_frontier_words as ref_pack_words
    from repro.core.tiling import pack_vertex_vector as ref_pack_vertex

    ref_plan, pri_np, _, _ = _reference("random", 16, "bitpack", "h3")
    g, t = ref_plan.g, ref_plan.tiled
    alive0, prior, gate = _warm_state(g, t)

    def packed(x):
        return ref_pack_words(ref_pack_vertex(jnp.asarray(x), t), 16)

    pri = ref_heur.Priorities(jnp.asarray(pri_np[0]), jnp.asarray(pri_np[1]))
    want = _tc_mis_impl(
        g, t, jax.random.key(0), RefOptions(engine="tiled_ref", phase1="tiled"),
        priorities=pri, alive0=packed(alive0), in_mis0=packed(prior),
        col_gate=jnp.asarray(gate),
    )
    plan = plan_from_arrays(_plan_arrays(ref_plan), device="cpu")
    words = [torch.from_numpy(np.array(packed(x)).view(np.int32)) for x in (alive0, prior)]
    assert words[0].shape == (t.n_block_rows, 1) and words[0].dtype == torch.int32
    got = run_tc_mis(
        plan.g, plan.tiled, None, SolveOptions(engine=engine, phase1="tiled"),
        priorities=_port_priorities(pri_np), alive0=words[0], in_mis0=words[1],
        col_gate=torch.from_numpy(gate),
    )
    np.testing.assert_array_equal(got.in_mis.numpy(), np.asarray(want.in_mis))
    assert int(got.rounds) == int(want.rounds)
    assert bool(got.converged) == bool(want.converged)
    assert got.in_mis.numpy()[prior].all()


@pytest.mark.parametrize("engine", ["segment", "fused_pallas"])
def test_warm_start_and_batch_seams_match_reference(engine):
    """alive0 + in_mis0 + col_gate + member_rounds, all at once: the
    reference's batch and warm-start seams give the same result."""
    ref_plan, pri_np, _, _ = _reference("random", 16, "int8", "h3")
    g, t = ref_plan.g, ref_plan.tiled
    alive0, prior, gate = _warm_state(g, t)
    pri = ref_heur.Priorities(jnp.asarray(pri_np[0]), jnp.asarray(pri_np[1]))
    want = _tc_mis_impl(
        g, t, jax.random.key(0), RefOptions(engine="tiled_ref"), priorities=pri,
        alive0=jnp.asarray(alive0), in_mis0=jnp.asarray(prior),
        col_gate=jnp.asarray(gate), member_rounds=True,
    )
    plan = plan_from_arrays(_plan_arrays(ref_plan), device="cpu")
    got = run_tc_mis(
        plan.g, plan.tiled, None, SolveOptions(engine=engine),
        priorities=_port_priorities(pri_np), alive0=torch.from_numpy(alive0),
        in_mis0=torch.from_numpy(prior), col_gate=torch.from_numpy(gate),
        member_rounds=True,
    )
    np.testing.assert_array_equal(got.in_mis.numpy(), np.asarray(want.in_mis))
    np.testing.assert_array_equal(got.rounds.numpy(), np.asarray(want.rounds))
    assert bool(got.converged) == bool(want.converged)


def test_max_rounds_bounds_the_loop_like_reference():
    ref_plan, pri_np, _, want_rounds = _reference("random", 16, "int8", "h1")
    assert want_rounds > 1
    plan = plan_from_arrays(_plan_arrays(ref_plan), device="cpu")
    res = run_tc_mis(plan.g, plan.tiled, None, SolveOptions(max_rounds=1),
                     priorities=_port_priorities(pri_np))
    assert int(res.rounds) == 1 and not bool(res.converged)


# --------------------------------------------------------------------------
# segment ops: fills
# --------------------------------------------------------------------------

def test_segment_ops_fills_match_reference():
    # vertex 0: neighbours 1, 2 (1 masked off); vertex 3: only neighbour 4,
    # masked; vertex 5: isolated; padding edges ride along
    src, dst, n = np.array([0, 0, 3]), np.array([1, 2, 4]), 6
    ref_g = ref_from_edges(src, dst, n, pad_to=10)
    g = from_edges(src, dst, n, pad_to=10, device="cpu")
    p = np.array([5, 7, 9, 11, 13, 15], np.int32)
    mask = np.array([True, False, True, True, False, True])
    got = spmv.neighbor_max_segment(g, torch.from_numpy(p), torch.from_numpy(mask))
    want = np.asarray(ref_spmv.neighbor_max_segment(ref_g, jnp.asarray(p), jnp.asarray(mask)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[3] == spmv._NEG and got[5] == np.iinfo(np.int32).min
    x = np.arange(1, 7, dtype=np.float32)
    np.testing.assert_array_equal(
        spmv.neighbor_sum_segment(g, torch.from_numpy(x)).numpy(),
        np.asarray(ref_spmv.neighbor_sum_segment(ref_g, jnp.asarray(x))),
    )
    np.testing.assert_array_equal(
        spmv.neighbor_any_segment(g, torch.from_numpy(mask)).numpy(),
        np.asarray(ref_spmv.neighbor_any_segment(ref_g, jnp.asarray(mask))),
    )


def test_tile_neighbor_max_matches_reference_oracle():
    from repro.core.engine import tile_neighbor_max as ref_tnm

    ref_plan, _, _, _ = _reference("clustered", 16, "bitpack", "h3")
    t = plan_from_arrays(_plan_arrays(ref_plan), device="cpu").tiled
    rng = np.random.default_rng(0)
    pm = np.where(rng.random(t.n_padded) < 0.5,
                  rng.integers(-1000, 1000, t.n_padded), spmv._NEG).astype(np.int32)
    want = np.asarray(ref_tnm(ref_plan.tiled.tiles, ref_plan.tiled.tile_rows,
                              ref_plan.tiled.tile_cols, jnp.asarray(pm),
                              t.n_block_rows, 16))
    got = port_engine.tile_neighbor_max(t.tiles, t.tile_rows, t.tile_cols,
                                        torch.from_numpy(pm), t.n_block_rows, 16)
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# heuristics
# --------------------------------------------------------------------------

def test_h3_resolve_is_bit_exact_including_wraparound():
    n = 1000
    rng = np.random.default_rng(4)
    # degrees large enough that -deg·n overflows int32 and wraps
    deg = rng.integers(0, 5_000_000, n).astype(np.int32)
    want = ref_heur.h3_priorities(jax.random.key(0), n, jnp.asarray(deg))
    got = heur.h3_priorities(prng.key(0), n, torch.from_numpy(deg))
    assert (-deg.astype(np.int64) * n).min() < np.iinfo(np.int32).min
    np.testing.assert_array_equal(got.resolve.numpy(), np.asarray(want.resolve))
    assert got.resolve.dtype == torch.int32


@pytest.mark.parametrize("heuristic,bits", [("h1", 0), ("h2", 4), ("h3", 8), ("ecl", 8)])
def test_priorities_lie_in_eq1_range(heuristic, bits):
    n = 500
    deg = torch.from_numpy(np.random.default_rng(1).integers(0, 12, n).astype(np.int32))
    pri = heur.make_priorities(heuristic, prng.key(2), n, deg)
    sel = pri.select.to(torch.int64)
    assert pri.select.dtype == torch.int32 and pri.select.shape == (n,)
    q, low = sel >> 23, sel & ((1 << 23) - 1)
    assert int(q.min()) >= 0 and int(q.max()) <= (1 << bits) - 1
    if heuristic == "h3":
        assert int(low.abs().sum()) == 0 and pri.resolve is not None
        assert torch.unique(pri.resolve).numel() == n
    else:
        assert torch.equal(torch.sort(low).values, torch.arange(n))
        assert torch.unique(pri.select).numel() == n
    with pytest.raises(ValueError, match="unknown heuristic"):
        heur.make_priorities("h9", prng.key(0), n, deg)


# --------------------------------------------------------------------------
# plan, options, registry, Solver
# --------------------------------------------------------------------------

def test_plan_policies_and_keys_match_reference():
    for n, e in [(50, 200), (5000, 40000), (1_089_936, 4_461_800), (524_288, 3_145_000)]:
        T = port_plan.choose_tile_size(n, e)
        assert T == ref_choose_tile_size(n, e)
        for storage in ("auto", "int8", "bitpack"):
            assert port_plan.resolve_storage(storage, n, e, T) == ref_resolve_storage(
                storage, n, e, T
            )
    assert port_plan.choose_tile_size(1_089_936, 4_461_800) == 16
    src, dst, n = _edges("random")
    g, ref_g = from_edges(src, dst, n, device="cpu"), ref_from_edges(src, dst, n)
    assert port_plan.graph_content_key(g) == ref_graph_content_key(ref_g)
    assert port_plan.plan_cache_key(g, 16, "rcm", "bitpack") == ref_plan_cache_key(
        ref_g, 16, "rcm", "bitpack"
    )


def test_options_validate_like_reference():
    assert SolveOptions() == SolveOptions(heuristic="h3", engine="fused_pallas",
                                          phase1="segment", lanes=8, hybrid="auto")
    ref_fields = {f: getattr(RefOptions(), f) for f in RefOptions.__dataclass_fields__}
    port_fields = {f: getattr(SolveOptions(), f) for f in SolveOptions.__dataclass_fields__}
    assert port_fields == ref_fields
    for bad in (dict(storage="int4"), dict(hybrid="on"), dict(frontier="x"),
                dict(placement="cloud"), dict(repair="x"), dict(hybrid_threshold=0)):
        with pytest.raises(ValueError):
            SolveOptions(**bad)
        with pytest.raises(ValueError):
            RefOptions(**bad)


def test_registry_names_and_aliases():
    assert port_engine.engine_names() == PORT_ENGINES
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert port_engine.get_engine("ref") is port_engine.get_engine("tiled_ref")
        assert port_engine.get_engine("pallas") is port_engine.get_engine("tiled_pallas")
    assert port_engine.get_engine("fused") is port_engine.get_engine("fused_pallas")
    with pytest.warns(DeprecationWarning):
        port_engine.get_engine("ref")
    with pytest.raises(ValueError, match="unknown engine"):
        port_engine.get_engine("cuda_warp")
    for name, e in port_engine.ENGINES.items():
        ref = ref_engine.get_engine(name)
        assert e.supports_bitwise == ref.supports_bitwise == (name != "segment")
        assert e.supports_hybrid == ref.supports_hybrid == (name != "segment")
        assert e.plane_kernel_nbr_max == ref.plane_kernel_nbr_max
        for phase1 in ("segment", "tiled"):
            got = port_engine.resolve_frontier(
                SolveOptions(phase1=phase1), e, storage="bitpack")
            assert got == ref_engine.resolve_frontier(
                RefOptions(phase1=phase1), ref, storage="bitpack")
            assert got == ("bitwise" if phase1 == "tiled" and name != "segment" else "dense")


@pytest.mark.parametrize("reorder", [None, "rcm"])
@pytest.mark.parametrize("engine", ["fused_pallas", "tiled_ref"])
def test_solver_solve_equals_the_loop(engine, reorder):
    src, dst, n = _edges("random")
    g = from_edges(src, dst, n, device="cpu")
    opts = SolveOptions(engine=engine, reorder=reorder, hybrid="forced")
    solver = Solver(opts, device="cpu")
    res = solver.solve(g)
    assert res.placement == "local" and res.converged
    plan = res.plan
    assert plan.storage == port_plan.resolve_storage("auto", n, g.n_edges, plan.tile_size)
    loop = run_tc_mis(plan.g, plan.tiled, prng.key(0), opts)
    np.testing.assert_array_equal(res.in_mis_plan, loop.in_mis.numpy())
    assert res.rounds == int(loop.rounds)
    mis = torch.from_numpy(res.in_mis)
    assert is_independent(g, mis) and is_maximal(g, mis)
    assert cardinality(mis) == res.mis_size == int(res.in_mis.sum())
    assert not is_maximal(g, torch.zeros(n, dtype=torch.bool))
    assert not is_independent(g, torch.ones(n, dtype=torch.bool))
    assert solver.solve(g).plan is plan     # the memory cache hit
    assert solver.plans.stats == {"mem_hits": 1, "disk_hits": 0, "misses": 1,
                                  "evicted_stale": 0}


@pytest.mark.parametrize("gid", sorted(REF_SUITE))
def test_solver_solve_matches_reference_from_the_seed(gid):
    """`SolveOptions()` as it is (fused_pallas, h3, auto tile size, storage
    and hybrid) on each suite graph at 3,000 vertices: the same MIS and
    rounds as the reference's Solver from `seed` alone."""
    ref_g = REF_SUITE[gid].make(3000, 1)
    want = RefSolver(RefOptions(seed=3)).solve(ref_g)
    E = ref_g.n_edges
    g = from_edges(np.asarray(ref_g.senders)[:E], np.asarray(ref_g.receivers)[:E],
                   ref_g.n_nodes, device="cpu")
    got = Solver(SolveOptions(seed=3), device="cpu").solve(g)
    np.testing.assert_array_equal(got.in_mis, np.asarray(want.in_mis))
    assert (got.rounds, got.converged) == (want.rounds, want.converged)


def test_solver_refuses_what_is_not_ported():
    """Nothing is refused any more: the sharded route, once refused, runs
    (a one-rank gloo group in this process) to the local route's MIS, and
    hybrid plans, refused before the partition was ported, build."""
    import torch.distributed as dist

    src, dst, n = _edges("random")
    g = from_edges(src, dst, n, device="cpu")
    try:
        res = Solver(SolveOptions(placement="sharded"), device="cpu").solve(g)
    finally:
        dist.destroy_process_group()
    want = Solver(SolveOptions(placement="local"), device="cpu").solve(g)
    assert (res.placement, res.stats["n_shards"], res.converged) == ("sharded", 1, True)
    np.testing.assert_array_equal(res.in_mis, want.in_mis)
    assert res.rounds == want.rounds
    for hybrid in ("auto", "forced"):
        plan = port_plan.Plan.build(g, hybrid=hybrid)
        assert plan.hybrid == hybrid and plan.hybrid_threshold > 0
    assert port_plan.Plan.build(g, hybrid="forced").tiled.partition is not None


def test_solver_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Solver()
    with pytest.raises(RuntimeError, match="cuda"):
        from_edges(np.array([0]), np.array([1]), 2)
