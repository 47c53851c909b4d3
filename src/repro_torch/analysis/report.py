"""Finding reporters: human one-line-per-finding, and JSON for CI.

The JSON document is what the CI lint job uploads as an artifact; its
shape is stable (``version`` bumps on change) so downstream tooling can
trend finding counts without scraping the log.

PyTorch port: a copy of :mod:`repro.analysis.report`; everything below this
docstring is unchanged.
"""
from __future__ import annotations

import json
from typing import Any, Dict

from .engine import LintResult
from .rules import RULES

JSON_VERSION = 1


def render_human(result: LintResult) -> str:
    lines = [f.render() for f in result.findings]
    verdict = "clean" if result.ok else f"{len(result.findings)} finding(s)"
    lines.append(
        f"bigset-lint: {verdict} — {result.files_checked} file(s), "
        f"{len(result.rules)} rule(s), {result.suppressed} suppressed")
    return "\n".join(lines)


def render_json(result: LintResult) -> Dict[str, Any]:
    return {
        "version": JSON_VERSION,
        "ok": result.ok,
        "files_checked": result.files_checked,
        "rules": list(result.rules),
        "suppressed": result.suppressed,
        "findings": [
            {"rule": f.rule, "path": f.path, "line": f.line,
             "col": f.col, "message": f.message}
            for f in result.findings
        ],
    }


def render_json_text(result: LintResult) -> str:
    return json.dumps(render_json(result), indent=1)


def render_rule_list() -> str:
    """``--list-rules``: id, scope-defining invariant, one-line title."""
    lines = []
    for rid in sorted(RULES):
        rule = RULES[rid]
        lines.append(f"{rid}  {rule.title}")
        lines.append(f"       enforces: {rule.invariant}")
    return "\n".join(lines)
