"""SARIF 2.1.0 export for ytpu-analyze findings.

Minimal single-run document: one ``run`` whose driver lists every rule
in the catalog and whose ``results`` carry one entry per finding.
Suppressed findings are exported with a ``suppressions`` entry (SARIF's
own notion) so CI annotation surfaces can show-or-hide them without
re-running the analyzer; unsuppressed findings are plain ``error``
results.  Round-trip fidelity (rule id, path, line, message,
suppression state) is pinned by tests/test_asyncproto.py.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from .core import RULES, Finding

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")
_TOOL_NAME = "ytpu-analyze"


def to_sarif(findings: Sequence[Finding],
             tool_version: str = "3.0") -> Dict:
    """Findings -> SARIF 2.1.0 document (a plain JSON-ready dict)."""
    rules = [{
        "id": rule,
        "shortDescription": {"text": desc},
    } for rule, desc in sorted(RULES.items())]
    results: List[Dict] = []
    for f in findings:
        result: Dict = {
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": f.line},
                },
            }],
        }
        if f.suppressed:
            result["suppressions"] = [{"kind": "inSource"}]
        results.append(result)
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": _TOOL_NAME,
                "version": tool_version,
                "informationUri":
                    "README.md",
                "rules": rules,
            }},
            "results": results,
        }],
    }


def from_sarif(doc: Dict) -> List[Finding]:
    """SARIF document -> findings (the round-trip test's other half,
    and the hook for diffing two CI runs' annotation sets)."""
    findings: List[Finding] = []
    for run in doc.get("runs", ()):
        for result in run.get("results", ()):
            locs = result.get("locations") or [{}]
            phys = locs[0].get("physicalLocation", {})
            findings.append(Finding(
                rule=result.get("ruleId", "?"),
                path=phys.get("artifactLocation", {}).get("uri", "?"),
                line=phys.get("region", {}).get("startLine", 0),
                message=result.get("message", {}).get("text", ""),
                suppressed=bool(result.get("suppressions")),
            ))
    return findings
