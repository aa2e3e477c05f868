"""Core datatypes of the rule engine: findings, severities, rule protocol
(counterpart of `repro.lint.model`).

Kept dependency-free (stdlib only), so the lint runs without torch
installed.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Iterable, List

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.lint.analysis import LintContext


class Severity:
    """SARIF-aligned severity levels.  `ERROR` findings fail the run;
    `WARNING`/`NOTE` findings are reported but never flip the exit code."""

    ERROR = "error"
    WARNING = "warning"
    NOTE = "note"

    ORDER = (ERROR, WARNING, NOTE)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a source location.

    `symbol` is the dotted qualname of the innermost enclosing function
    (`<module>` at module scope) — baselining keys on (rule, module, symbol,
    message) rather than line numbers so unrelated edits above a
    grandfathered finding do not un-baseline it.
    """

    rule: str
    severity: str
    path: str            # root-relative posix path
    line: int
    col: int
    module: str          # dotted module name within the lint universe
    symbol: str          # enclosing function qualname or "<module>"
    message: str
    suppressed: bool = False
    baselined: bool = False

    @property
    def active(self) -> bool:
        """True when the finding should count against the exit code."""
        return (
            not self.suppressed
            and not self.baselined
            and self.severity == Severity.ERROR
        )

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"


@dataclasses.dataclass(frozen=True)
class Rule:
    """One entry of the rule catalog (README.md, "The hot-path lint").

    `check` receives the whole `LintContext` (every parsed module, the call
    graph, the hot set) and yields findings for the modules under report.
    `escapes` documents the sanctioned ways around the rule — the README
    catalog table and `--list-rules` render it.
    """

    id: str
    name: str
    severity: str
    summary: str
    rationale: str
    escapes: str
    check: "object" = None  # Callable[[LintContext], Iterable[Finding]]

    def run(self, ctx: "LintContext") -> List[Finding]:
        return list(self.check(ctx))


def sort_findings(findings: Iterable[Finding]) -> List[Finding]:
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))
