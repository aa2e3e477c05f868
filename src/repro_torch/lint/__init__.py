"""repro_torch.lint — the hot-path lint of the PyTorch port (counterpart of
`repro.lint`, whose call-graph engine it keeps).

The reference's lint seeds its hot path by leaf name at its jitted entry
points; the port's names stay off that list, so the reference's lint reads
the port but seeds none of it.  This package holds the port to the same
invariants — one host sync a round, no 64-bit creep, packed stays packed,
no hidden fallback — with:

  * the reference's engine: the one-pass AST index, import table and
    suppression spans (`# repro-lint: disable=RPT0xx <reason>`), the
    interprocedural call graph, the version-1 baseline and the text / JSON
    / SARIF emitters;
  * the port's seeds, by key: the convergence loop `core.tc_mis._converge`,
    the profiler twin `run_phases`, the sharded per-rank `run`, the warm
    re-entry (`repair_solution`, `warm_start`, `_seed_cover*`), the `step*`
    methods of `TorchRoundEngine` and its descendants, and every `_launch*`
    function and public wrapper of the kernel modules in
    `repro_torch.hopper`;
  * a rule catalog for eager PyTorch on a card (RPT001–RPT016, each
    numbered after the reference rule it ports).

Run `python -m repro_torch.lint` (default `src/repro_torch`; exit 0 =
clean).  The default baseline is tools/torch_lint_baseline.json, shipped
empty.
"""
from repro_torch.lint.analysis import LintContext, load_universe
from repro_torch.lint.baseline import Baseline
from repro_torch.lint.callgraph import CallGraph, DEFAULT_SEEDS
from repro_torch.lint.cli import main
from repro_torch.lint.model import Finding, Rule, Severity
from repro_torch.lint.rules import ALL_RULES, get_rules, run_rules

__all__ = [
    "ALL_RULES",
    "Baseline",
    "CallGraph",
    "DEFAULT_SEEDS",
    "Finding",
    "LintContext",
    "Rule",
    "Severity",
    "get_rules",
    "load_universe",
    "main",
    "run_rules",
]
