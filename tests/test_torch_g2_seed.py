"""G2 (`grid2d(1044, 1044)`, 1,089,936 vertices) from seed 0 alone, on the
CPU, in both packages: `Solver(SolveOptions()).solve`, `luby_mis`,
`ecl_mis` and a quarter-G2 member of `solve_many` (its solo solve under
`request_key`) give the reference's MIS bit for bit.  `chip_smoke.py`
holds the card's runs to constants (`G2_SEED_MIS`: |MIS|, rounds and the
SHA-256 of `np.packbits(in_mis)`); this file checks those constants
against the reference, reading them from the script's source, which
imports no JAX and is not imported here."""
import ast
import functools
import hashlib
import pathlib

import jax
import numpy as np
import pytest

from repro.api import Solver as RefSolver
from repro.api import SolveOptions as RefOptions
from repro.core.ecl_mis import ecl_mis as ref_ecl_mis
from repro.core.luby import luby_mis as ref_luby_mis
from repro.graphs.generators import grid2d as ref_grid2d
from repro_torch.api import Solver, SolveOptions
from repro_torch.core import ecl_mis, luby_mis, prng
from repro_torch.graphs import grid2d

CHIP_SMOKE = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"


def _pinned() -> dict:
    """`G2_SEED_MIS`, `G2_SHAPE` and `G2_MEMBER` as chip_smoke.py assigns them."""
    out = {}
    for node in ast.parse(CHIP_SMOKE.read_text()).body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if name in ("G2_SEED_MIS", "G2_SHAPE", "G2_MEMBER"):
                out[name] = ast.literal_eval(node.value)
    return out


PINNED = _pinned()


def _digest(in_mis) -> tuple:
    x = np.asarray(in_mis).astype(bool)
    return int(x.sum()), hashlib.sha256(np.packbits(x).tobytes()).hexdigest()


@functools.lru_cache(maxsize=None)
def _reference(path: str) -> tuple:
    """(|MIS|, rounds, digest) of the reference's run of `path` from seed 0."""
    if path == "member":
        solver = RefSolver(RefOptions())
        plan = solver.plan(ref_grid2d(*PINNED["G2_MEMBER"], seed=0))
        res = solver.solve(plan, key=solver.request_key(plan))
        size, digest = _digest(res.in_mis)
        return size, int(res.rounds), digest
    g2 = ref_grid2d(*PINNED["G2_SHAPE"])
    if path == "solve":
        res = RefSolver(RefOptions()).solve(g2)
    else:
        res = (ref_luby_mis if path == "luby" else ref_ecl_mis)(g2, jax.random.key(0))
    size, digest = _digest(res.in_mis)
    return size, int(res.rounds), digest


def test_chip_smoke_pins_g2_shapes():
    assert PINNED["G2_SHAPE"] == (1044, 1044) and PINNED["G2_MEMBER"] == (522, 522)
    assert sorted(PINNED["G2_SEED_MIS"]) == ["ecl", "luby", "member", "solve"]


def test_g2_solve_matches_reference_from_the_seed():
    """The acceptance case: 392,658 vertices in 5 rounds, no priorities
    handed over."""
    got = Solver(SolveOptions(), device="cpu").solve(grid2d(*PINNED["G2_SHAPE"], device="cpu"))
    size, digest = _digest(got.in_mis)
    assert (size, got.rounds, digest) == _reference("solve") == PINNED["G2_SEED_MIS"]["solve"]
    assert size == 392_658 and got.rounds == 5


@pytest.mark.parametrize("path", ["luby", "ecl", "member"])
def test_g2_paths_match_reference_and_chip_smoke(path):
    if path == "member":
        solver = Solver(SolveOptions(), device="cpu")
        members = [grid2d(*PINNED["G2_MEMBER"], seed=s, device="cpu") for s in (0, 1)]
        res = solver.solve_many(members)[0]
        assert res.placement == "batched"
        rounds = res.rounds
    else:
        g2 = grid2d(*PINNED["G2_SHAPE"], device="cpu")
        res = (luby_mis if path == "luby" else ecl_mis)(g2, prng.key(0))
        rounds = int(res.rounds)
    size, digest = _digest(res.in_mis)
    assert (size, rounds, digest) == _reference(path) == PINNED["G2_SEED_MIS"][path]
