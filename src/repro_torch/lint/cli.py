"""`python -m repro_torch.lint` — the command-line front end (counterpart
of `repro.lint.cli`).

Exit codes: 0 clean (no active findings), 1 active findings, 2 bad usage.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
from typing import List, Optional, Sequence

from repro_torch.lint.analysis import load_universe
from repro_torch.lint.baseline import Baseline
from repro_torch.lint.emit import BASELINE_FILE, TOOL_NAME, emit_json, emit_sarif, emit_text
from repro_torch.lint.rules import ALL_RULES, get_rules, run_rules

DEFAULT_BASELINE = BASELINE_FILE
DEFAULT_PATH = "src/repro_torch"


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="hot-path static analysis for the PyTorch port "
        "(rule catalog: README.md, \"The hot-path lint\")",
    )
    p.add_argument(
        "paths",
        nargs="*",
        default=[DEFAULT_PATH],
        help=f"files or directories to lint (default: {DEFAULT_PATH})",
    )
    p.add_argument(
        "--format",
        choices=("text", "json", "sarif"),
        default="text",
        help="output format (default: text)",
    )
    p.add_argument(
        "--output", "-o", default=None, help="write report to a file"
    )
    p.add_argument(
        "--rules",
        default=None,
        help="comma-separated rule ids to run (default: all)",
    )
    p.add_argument(
        "--baseline",
        default=None,
        help=f"baseline file (default: {DEFAULT_BASELINE} when it exists)",
    )
    p.add_argument(
        "--no-baseline",
        action="store_true",
        help="ignore any baseline file",
    )
    p.add_argument(
        "--update-baseline",
        action="store_true",
        help="write all current findings to the baseline file and exit 0",
    )
    p.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog"
    )
    return p


def _find_baseline(args) -> Optional[pathlib.Path]:
    if args.no_baseline:
        return None
    if args.baseline:
        return pathlib.Path(args.baseline)
    # default baseline lives next to the repo root: walk up from the first
    # lint path looking for tools/torch_lint_baseline.json
    start = pathlib.Path(args.paths[0]).resolve()
    start = start if start.is_dir() else start.parent
    for d in (start, *start.parents):
        cand = d / DEFAULT_BASELINE
        if cand.is_file():
            return cand
    cand = pathlib.Path.cwd() / DEFAULT_BASELINE
    return cand if cand.is_file() else None


def _list_rules() -> str:
    lines = ["rule      severity  name                     summary"]
    for r in ALL_RULES:
        lines.append(
            f"{r.id:<9} {r.severity:<9} {r.name:<24} {r.summary}"
        )
    return "\n".join(lines) + "\n"


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.list_rules:
        sys.stdout.write(_list_rules())
        return 0

    try:
        rule_ids = (
            [r.strip() for r in args.rules.split(",") if r.strip()]
            if args.rules
            else None
        )
        rules = get_rules(rule_ids)
    except KeyError as e:
        sys.stderr.write(f"{TOOL_NAME}: {e.args[0]}\n")
        return 2

    paths: List[pathlib.Path] = []
    for raw in args.paths:
        p = pathlib.Path(raw)
        if not p.exists():
            sys.stderr.write(f"{TOOL_NAME}: no such path: {raw}\n")
            return 2
        paths.append(p)

    ctx = load_universe(paths)
    findings = run_rules(ctx, rules)

    baseline_path = _find_baseline(args)
    if args.update_baseline:
        target = pathlib.Path(
            args.baseline or baseline_path or DEFAULT_BASELINE
        )
        target.parent.mkdir(parents=True, exist_ok=True)
        Baseline.from_findings(findings).save(target)
        sys.stderr.write(
            f"{TOOL_NAME}: baseline written to {target} "
            f"({sum(1 for f in findings if not f.suppressed)} entries)\n"
        )
        return 0
    if baseline_path is not None:
        try:
            findings = Baseline.load(baseline_path).apply(findings)
        except (ValueError, OSError, KeyError) as e:
            sys.stderr.write(f"{TOOL_NAME}: bad baseline: {e}\n")
            return 2

    if args.format == "text":
        report = emit_text(findings)
    elif args.format == "json":
        report = emit_json(findings)
    else:
        report = emit_sarif(findings, rules)

    if args.output:
        pathlib.Path(args.output).write_text(report, encoding="utf-8")
    else:
        sys.stdout.write(report)

    return 1 if any(f.active for f in findings) else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
