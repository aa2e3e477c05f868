"""The port's Luby and ECL-MIS baselines against the reference's.

From the key alone (`core.prng.key(seed)`, the reference's
`jax.random.key(seed)`), `luby_mis` and `ecl_mis` must give the
reference's MIS, rounds and convergence, exactly.  The round bodies are
also held apart from the draws: for Luby, each round's
`jax.random.randint(fold_in(key, round), (n,), 0, int32 max)` as
`luby.py` makes it, fed into the port's `luby_round`; for ECL-MIS, the
reference's priorities into `ecl_rounds`.  Then the reference's own property, that
ECL-MIS is TC-MIS with `heuristic="ecl"` on the same priorities, and the
properties of tests/test_mis_properties.py: valid, maximal, converged,
and the `max_rounds` cap."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ecl_mis import ecl_mis as ref_ecl_mis
from repro.core.heuristics import make_priorities as ref_make_priorities
from repro.core.luby import luby_mis as ref_luby_mis
from repro.graphs.generators import grid2d as ref_grid2d
from repro.graphs.generators import powerlaw as ref_powerlaw
from repro.graphs.graph import from_edges as ref_from_edges
from repro_torch.api import Plan, SolveOptions
from repro_torch.core import ecl_mis, ecl_rounds, luby_mis, luby_round, prng, run_tc_mis
from repro_torch.core.heuristics import Priorities
from repro_torch.core.validate import cardinality, is_independent, is_maximal
from repro_torch.graphs import powerlaw
from repro_torch.graphs.graph import from_edges


def _random_edges(n, density, seed):
    rng = np.random.default_rng(seed)
    m = max(int(density * n * (n - 1) / 2), 1)
    return rng.integers(0, n, m), rng.integers(0, n, m), n


def _ref_graph(kind):
    if kind == "grid":
        return ref_grid2d(20, 20, seed=1)
    if kind == "powerlaw":
        return ref_powerlaw(400, avg_deg=6.0, seed=2)
    return ref_from_edges(*_random_edges(150, 0.05, 3))


def _port_graph(ref_g):
    E = ref_g.n_edges
    return from_edges(np.asarray(ref_g.senders)[:E], np.asarray(ref_g.receivers)[:E],
                      ref_g.n_nodes, device="cpu")


def _luby_with_reference_draws(g, key, n, max_rounds):
    """The port's round body under the reference's per-round draws."""
    alive = torch.ones(n, dtype=torch.bool)
    in_mis = torch.zeros(n, dtype=torch.bool)
    rounds = 0
    while rounds < max_rounds and bool(alive.any()):
        p = jax.random.randint(jax.random.fold_in(key, rounds), (n,), 0,
                               jnp.iinfo(jnp.int32).max, dtype=jnp.int32)
        alive, in_mis = luby_round(g, torch.tensor(np.asarray(p)), alive, in_mis)
        rounds += 1
    return in_mis, rounds, not bool(alive.any())


@pytest.mark.parametrize("max_rounds", [1024, 2])
@pytest.mark.parametrize("kind", ["grid", "powerlaw", "random"])
def test_luby_matches_reference_fed_its_draws(kind, max_rounds):
    ref_g = _ref_graph(kind)
    key = jax.random.key(11)
    want = ref_luby_mis(ref_g, key, max_rounds=max_rounds)
    in_mis, rounds, converged = _luby_with_reference_draws(
        _port_graph(ref_g), key, ref_g.n_nodes, max_rounds)
    np.testing.assert_array_equal(in_mis.numpy(), np.asarray(want.in_mis))
    assert rounds == int(want.rounds)
    assert converged == bool(want.converged)
    assert converged or rounds == max_rounds


@pytest.mark.parametrize("max_rounds", [1024, 2])
@pytest.mark.parametrize("kind", ["grid", "powerlaw", "random"])
def test_luby_matches_reference_from_the_key(kind, max_rounds):
    ref_g = _ref_graph(kind)
    want = ref_luby_mis(ref_g, jax.random.key(11), max_rounds=max_rounds)
    got = luby_mis(_port_graph(ref_g), prng.key(11), max_rounds=max_rounds)
    np.testing.assert_array_equal(got.in_mis.numpy(), np.asarray(want.in_mis))
    assert int(got.rounds) == int(want.rounds)
    assert bool(got.converged) == bool(want.converged)


@pytest.mark.parametrize("heuristic", ["ecl", "h3"])
@pytest.mark.parametrize("kind", ["grid", "powerlaw", "random"])
def test_ecl_matches_reference_from_the_key(kind, heuristic):
    ref_g = _ref_graph(kind)
    want = ref_ecl_mis(ref_g, jax.random.key(5), heuristic=heuristic)
    got = ecl_mis(_port_graph(ref_g), prng.key(5), heuristic=heuristic)
    np.testing.assert_array_equal(got.in_mis.numpy(), np.asarray(want.in_mis))
    assert int(got.rounds) == int(want.rounds)
    assert bool(got.converged) and bool(want.converged)


@pytest.mark.parametrize("heuristic", ["ecl", "h3"])
@pytest.mark.parametrize("kind", ["grid", "powerlaw", "random"])
def test_ecl_matches_reference_fed_its_priorities(kind, heuristic):
    ref_g = _ref_graph(kind)
    key = jax.random.key(5)
    want = ref_ecl_mis(ref_g, key, heuristic=heuristic)
    pri = ref_make_priorities(heuristic, key, ref_g.n_nodes, ref_g.degrees())
    port_pri = Priorities(torch.from_numpy(np.asarray(pri.select)),
                          None if pri.resolve is None else torch.from_numpy(np.asarray(pri.resolve)))
    got = ecl_rounds(_port_graph(ref_g), port_pri)
    np.testing.assert_array_equal(got.in_mis.numpy(), np.asarray(want.in_mis))
    assert int(got.rounds) == int(want.rounds)
    assert bool(got.converged) and bool(want.converged)


@pytest.mark.parametrize("engine", ["segment", "tiled_ref", "fused_pallas"])
def test_ecl_mis_equals_tc_mis_with_the_ecl_heuristic(engine):
    for seed in range(3):
        g = from_edges(*_random_edges(300, 0.05, seed), device="cpu")
        plan = Plan.build(g, tile_size=32)
        e = ecl_mis(g, prng.key(seed))
        t = run_tc_mis(plan.g, plan.tiled, prng.key(seed),
                       SolveOptions(engine=engine, heuristic="ecl"))
        np.testing.assert_array_equal(e.in_mis.numpy(), t.in_mis.numpy())
        assert int(e.rounds) == int(t.rounds)


@pytest.mark.parametrize("baseline", ["luby", "ecl"])
@pytest.mark.parametrize("n, density, seed",
                         [(5, 0.5, 0), (40, 0.2, 1), (120, 0.01, 2), (120, 0.4, 3), (77, 0.05, 4)])
def test_baseline_is_a_maximal_independent_set(baseline, n, density, seed):
    g = from_edges(*_random_edges(n, density, seed), device="cpu")
    run = luby_mis if baseline == "luby" else ecl_mis
    res = run(g, prng.key(seed))
    assert bool(res.converged) and res.in_mis.dtype == torch.bool
    assert is_independent(g, res.in_mis) and is_maximal(g, res.in_mis)


def test_baselines_on_empty_and_complete_graphs_and_the_round_cap():
    empty = from_edges(np.array([], np.int64), np.array([], np.int64), 10, device="cpu")
    for run in (luby_mis, ecl_mis):
        assert cardinality(run(empty, prng.key(0)).in_mis) == 10
    src, dst = np.triu_indices(12, 1)
    complete = from_edges(src, dst, 12, device="cpu")
    for run in (luby_mis, ecl_mis):
        assert cardinality(run(complete, prng.key(0)).in_mis) == 1
    g = powerlaw(400, avg_deg=6.0, seed=2, device="cpu")
    for run in (luby_mis, ecl_mis):
        capped = run(g, prng.key(0), max_rounds=1)
        assert int(capped.rounds) == 1 and not bool(capped.converged)
        assert is_independent(g, capped.in_mis)
