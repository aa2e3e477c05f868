"""Finding emitters: text (humans/CI logs), JSON (tooling), SARIF 2.1.0
(code-scanning annotations) — counterpart of `repro.lint.emit`.

Text and JSON are the reference's formats byte for byte (the JSON `tool`
and the text summary name the engine, `repro-lint`); SARIF names the
port's tool, `repro-torch-lint`, so a code-scanning view keeps the two
catalogs apart.

Suppressed and baselined findings are emitted too (text marks them, SARIF
uses the `suppressions` property) so a clean run still documents what was
grandfathered; only `active` findings flip the exit code.
"""
from __future__ import annotations

import json
from typing import Iterable, List, Sequence

from repro_torch.lint.model import Finding, Rule

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)
FORMAT_NAME = "repro-lint"
TOOL_NAME = "repro-torch-lint"
BASELINE_FILE = "tools/torch_lint_baseline.json"


def _tag(f: Finding) -> str:
    if f.suppressed:
        return " [suppressed]"
    if f.baselined:
        return " [baselined]"
    return ""


def emit_text(findings: Sequence[Finding]) -> str:
    lines: List[str] = []
    for f in findings:
        lines.append(
            f"{f.location()}: {f.severity} {f.rule}[{_rule_name(f)}]"
            f"{_tag(f)}: {f.message}"
        )
    active = sum(1 for f in findings if f.active)
    suppressed = sum(1 for f in findings if f.suppressed)
    baselined = sum(1 for f in findings if f.baselined)
    lines.append(
        f"{FORMAT_NAME}: {active} error(s), {suppressed} suppressed, "
        f"{baselined} baselined"
    )
    return "\n".join(lines) + "\n"


def _rule_name(f: Finding) -> str:
    from repro_torch.lint.rules import ALL_RULES

    for r in ALL_RULES:
        if r.id == f.rule:
            return r.name
    return "?"


def emit_json(findings: Sequence[Finding]) -> str:
    return (
        json.dumps(
            {
                "tool": FORMAT_NAME,
                "findings": [
                    {
                        "rule": f.rule,
                        "severity": f.severity,
                        "path": f.path,
                        "line": f.line,
                        "col": f.col,
                        "module": f.module,
                        "symbol": f.symbol,
                        "message": f.message,
                        "suppressed": f.suppressed,
                        "baselined": f.baselined,
                    }
                    for f in findings
                ],
            },
            indent=2,
        )
        + "\n"
    )


def emit_sarif(
    findings: Sequence[Finding], rules: Iterable[Rule]
) -> str:
    rule_objs = [
        {
            "id": r.id,
            "name": r.name,
            "shortDescription": {"text": r.summary},
            "fullDescription": {"text": r.rationale},
            "help": {"text": f"Sanctioned escapes: {r.escapes}"},
            "defaultConfiguration": {"level": r.severity},
        }
        for r in rules
    ]
    rule_index = {r["id"]: i for i, r in enumerate(rule_objs)}
    results = []
    for f in findings:
        result = {
            "ruleId": f.rule,
            "ruleIndex": rule_index.get(f.rule, -1),
            "level": f.severity,
            "message": {"text": f.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": f.path,
                            "uriBaseId": "%SRCROOT%",
                        },
                        "region": {
                            "startLine": f.line,
                            "startColumn": f.col,
                        },
                    }
                }
            ],
        }
        if f.suppressed or f.baselined:
            result["suppressions"] = [
                {
                    "kind": "inSource" if f.suppressed else "external",
                    "justification": (
                        "inline repro-lint: disable comment"
                        if f.suppressed
                        else f"grandfathered in {BASELINE_FILE}"
                    ),
                }
            ]
        results.append(result)
    doc = {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": TOOL_NAME,
                        "informationUri": "README.md#the-hot-path-lint",
                        "rules": rule_objs,
                    }
                },
                "results": results,
            }
        ],
    }
    return json.dumps(doc, indent=2) + "\n"
