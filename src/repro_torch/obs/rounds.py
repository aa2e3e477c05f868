"""Round-telemetry buffer layout and the host-side `RoundTrace` view
(counterpart of `repro.obs.rounds`, the same layout and checks).

When `SolveOptions.telemetry` is on, `core.tc_mis.run_tc_mis` carries a
fixed-shape ``(max_rounds, TELEMETRY_COLS)`` int32 buffer on the solve's
device.  Each executed round r writes row r with six reductions over state
the round body already holds (`core.engine.TorchRoundEngine.
step_with_stats`): no extra SpMV, no host read inside the loop, one
device→host transfer after it:

    col 0  COL_ALIVE          popcount(alive) at round entry
    col 1  COL_FRONTIER       popcount(candidates C), the phase-① frontier
    col 2  COL_SELECTED       popcount(in_mis_new) − popcount(in_mis_old)
    col 3  COL_TILES_SKIPPED  n_tiles_pad − Σ col_flags[tile_cols]  (0 when
                              the engine computes no flags: segment); under
                              hybrid routing, over the dense partition
    col 4  COL_TILES_DENSE    tiles dispatched on the dense path this round
                              (n_tiles_pad − skipped; 0 for segment)
    col 5  COL_TILES_SPARSE   tiles routed through the COO tail: the
                              partition's n_sparse_tiles, 0 without one

Rows past the executed round count keep the fill value −1, which is how
`RoundTrace.from_buffer` tells "round never ran" from an all-zero round.

numpy only: `core.engine` takes the column constants from here.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

TELEMETRY_COLS = 6
COL_ALIVE = 0
COL_FRONTIER = 1
COL_SELECTED = 2
COL_TILES_SKIPPED = 3
COL_TILES_DENSE = 4
COL_TILES_SPARSE = 5

# rows beyond the executed rounds keep this fill; col 0 (alive) is never
# negative for an executed round, so it doubles as the row-validity mark
TELEMETRY_FILL = -1

COLUMN_NAMES = (
    "alive", "frontier", "selected", "tiles_skipped",
    "tiles_dense", "tiles_sparse",
)


@dataclass(frozen=True)
class RoundTrace:
    """Host-side per-round series for one solve.

    ``alive[r]`` etc. are python lists of ints, length == ``rounds`` — the
    executed prefix of the device buffer, already validated and trimmed.
    """

    rounds: int
    alive: List[int]
    frontier: List[int]
    selected: List[int]
    tiles_skipped: List[int]
    tiles_dense: List[int] = field(default_factory=list)
    tiles_sparse: List[int] = field(default_factory=list)
    tiles_total: int = 0
    meta: Dict[str, object] = field(default_factory=dict)

    @classmethod
    def from_buffer(
        cls,
        buf,
        rounds: int,
        *,
        tiles_total: int = 0,
        meta: Optional[Dict[str, object]] = None,
    ) -> "RoundTrace":
        """Trim the raw ``(max_rounds, K)`` device buffer to the executed
        prefix.  ``rounds`` comes from the result epilogue; rows past it are
        required to still hold the fill value (a mismatch means the loop
        wrote outside its round index — worth failing loudly)."""
        a = np.asarray(buf, dtype=np.int64)
        if a.ndim != 2 or a.shape[1] != TELEMETRY_COLS:
            raise ValueError(f"telemetry buffer shape {a.shape}, want (R, {TELEMETRY_COLS})")
        rounds = int(rounds)
        if rounds < 0 or rounds > a.shape[0]:
            raise ValueError(f"rounds={rounds} outside buffer of {a.shape[0]} rows")
        used = a[:rounds]
        if used.size and (used[:, COL_ALIVE] < 0).any():
            bad = int(np.argmax(used[:, COL_ALIVE] < 0))
            raise ValueError(f"round {bad} < rounds={rounds} was never recorded")
        return cls(
            rounds=rounds,
            alive=[int(v) for v in used[:, COL_ALIVE]],
            frontier=[int(v) for v in used[:, COL_FRONTIER]],
            selected=[int(v) for v in used[:, COL_SELECTED]],
            tiles_skipped=[int(v) for v in used[:, COL_TILES_SKIPPED]],
            tiles_dense=[int(v) for v in used[:, COL_TILES_DENSE]],
            tiles_sparse=[int(v) for v in used[:, COL_TILES_SPARSE]],
            tiles_total=int(tiles_total),
            meta=dict(meta or {}),
        )

    # -- serialization ----------------------------------------------------

    def to_dict(self) -> Dict[str, object]:
        return dict(
            rounds=self.rounds,
            alive=list(self.alive),
            frontier=list(self.frontier),
            selected=list(self.selected),
            tiles_skipped=list(self.tiles_skipped),
            tiles_dense=list(self.tiles_dense),
            tiles_sparse=list(self.tiles_sparse),
            tiles_total=self.tiles_total,
            meta=dict(self.meta),
        )

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "RoundTrace":
        return cls(
            rounds=int(d["rounds"]),
            alive=[int(v) for v in d["alive"]],
            frontier=[int(v) for v in d["frontier"]],
            selected=[int(v) for v in d["selected"]],
            tiles_skipped=[int(v) for v in d["tiles_skipped"]],
            tiles_dense=[int(v) for v in d.get("tiles_dense", [])],
            tiles_sparse=[int(v) for v in d.get("tiles_sparse", [])],
            tiles_total=int(d.get("tiles_total", 0)),
            meta=dict(d.get("meta", {})),
        )

    def to_jsonl_line(self) -> str:
        return json.dumps({"kind": "rounds", **self.to_dict()}, sort_keys=True)

    @classmethod
    def from_jsonl_line(cls, line: str) -> "RoundTrace":
        d = json.loads(line)
        if d.get("kind") != "rounds":
            raise ValueError(f"not a rounds record: kind={d.get('kind')!r}")
        return cls.from_dict(d)

    # -- analysis ---------------------------------------------------------

    def summary(self) -> Dict[str, object]:
        """Compact scalars for BENCH rows / log lines: total selected, the
        frontier-shrinkage profile, and the tile-gating win."""
        if not self.rounds:
            return dict(rounds=0, selected_total=0)
        skip_frac = None
        if self.tiles_total:
            skip_frac = round(
                sum(self.tiles_skipped) / (self.tiles_total * self.rounds), 4
            )
        return dict(
            rounds=self.rounds,
            alive0=self.alive[0],
            alive_final=self.alive[-1],
            selected_total=sum(self.selected),
            frontier_peak=max(self.frontier),
            frontier_final=self.frontier[-1],
            tiles_skipped_mean=round(sum(self.tiles_skipped) / self.rounds, 1),
            tiles_skip_frac=skip_frac,
            tiles_dense_mean=(
                round(sum(self.tiles_dense) / self.rounds, 1)
                if self.tiles_dense else None
            ),
            tiles_sparse_mean=(
                round(sum(self.tiles_sparse) / self.rounds, 1)
                if self.tiles_sparse else None
            ),
        )

    def check_invariants(self) -> None:
        """The monotonicity contracts the solver guarantees (a cheap
        sanity hook for callers and tests):

        * alive is non-increasing round over round;
        * every executed round selects ≥1 vertex (the global max-priority
          alive vertex always survives phase ②), so selected ≥ 1;
        * counts are bounded by alive₀.
        """
        for r in range(1, self.rounds):
            if self.alive[r] > self.alive[r - 1]:
                raise AssertionError(
                    f"alive increased at round {r}: {self.alive[r-1]} -> {self.alive[r]}"
                )
        for r in range(self.rounds):
            if self.selected[r] < 1:
                raise AssertionError(f"round {r} selected {self.selected[r]} (< 1)")
            if self.frontier[r] > self.alive[r]:
                raise AssertionError(
                    f"round {r} frontier {self.frontier[r]} > alive {self.alive[r]}"
                )
