"""Checked-in baseline of grandfathered findings (counterpart of
`repro.lint.baseline`: the same version-1 file format, so a baseline
written by either package loads in the other).

A baseline entry fingerprints a finding as (rule, module, symbol, message) —
deliberately **not** line numbers, so edits above a grandfathered finding do
not un-baseline it and a moved-but-unfixed violation stays grandfathered.
Entries carry a count: two identical findings in one function need two
baseline slots, and fixing one of them surfaces the other.

The shipped baseline (tools/torch_lint_baseline.json) is EMPTY for
src/repro_torch — every finding of the catalog was fixed or suppressed
inline with a reason instead.  The mechanism exists for trees adopting the
lint incrementally.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from collections import Counter
from typing import Iterable, List

from repro_torch.lint.model import Finding

VERSION = 1
_SEP = "␟"  # symbol-for-unit-separator; never appears in fingerprints


def _fingerprint(f: Finding) -> str:
    return _SEP.join((f.rule, f.module, f.symbol, f.message))


@dataclasses.dataclass
class Baseline:
    entries: Counter = dataclasses.field(default_factory=Counter)

    # -- io ------------------------------------------------------------------
    @classmethod
    def load(cls, path: pathlib.Path) -> "Baseline":
        data = json.loads(path.read_text(encoding="utf-8"))
        if data.get("version") != VERSION:
            raise ValueError(
                f"{path}: unsupported baseline version {data.get('version')!r}"
            )
        entries: Counter = Counter()
        for item in data.get("entries", []):
            key = _SEP.join(
                (item["rule"], item["module"], item["symbol"], item["message"])
            )
            entries[key] += int(item.get("count", 1))
        return cls(entries=entries)

    def save(self, path: pathlib.Path) -> None:
        items = []
        for key in sorted(self.entries):
            rule, module, symbol, message = key.split(_SEP)
            items.append(
                {
                    "rule": rule,
                    "module": module,
                    "symbol": symbol,
                    "message": message,
                    "count": self.entries[key],
                }
            )
        path.write_text(
            json.dumps({"version": VERSION, "entries": items}, indent=2)
            + "\n",
            encoding="utf-8",
        )

    # -- matching ------------------------------------------------------------
    @classmethod
    def from_findings(cls, findings: Iterable[Finding]) -> "Baseline":
        """Baseline every non-suppressed finding (for --update-baseline)."""
        entries: Counter = Counter()
        for f in findings:
            if not f.suppressed:
                entries[_fingerprint(f)] += 1
        return cls(entries=entries)

    def apply(self, findings: Iterable[Finding]) -> List[Finding]:
        """Mark matched findings `baselined` (consuming counts in source
        order, so a fixed duplicate un-baselines exactly one slot)."""
        budget = Counter(self.entries)
        out: List[Finding] = []
        for f in findings:
            key = _fingerprint(f)
            if not f.suppressed and budget[key] > 0:
                budget[key] -= 1
                f = dataclasses.replace(f, baselined=True)
            out.append(f)
        return out

    def __len__(self) -> int:
        return sum(self.entries.values())
