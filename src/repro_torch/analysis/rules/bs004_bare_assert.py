"""BS004 — no bare ``assert`` in library code (``python -O`` strips them).

CI runs an assert-stripped smoke job (``python -O``): any ``assert`` used
to validate inputs or guard a precondition silently vanishes there, and
the invalid state flows on — exactly how ``decode_element_key`` once
decoded clock keys into garbage dots (fixed by raising).
Validation must raise a typed exception (``ValueError``, ``PlanError``,
``KeyCodecError`` …); internal sanity checks that genuinely may be
compiled out can be suppressed with a justification.

Test-support code (``testing/``) is exempt: it exists to assert.

PyTorch port: a copy of :mod:`repro.analysis.rules.bs004_bare_assert`; everything below this
docstring is unchanged.
"""
from __future__ import annotations

import ast

from .base import Rule, register


@register
class BareAssertRule(Rule):
    id = "BS004"
    title = "library code raises typed exceptions, not assert"
    invariant = "CI `python -O` smoke discipline"

    def applies(self) -> bool:
        return not self.ctx.rel.startswith(
            tuple(self.ctx.config.assert_exempt))

    def visit_Assert(self, node: ast.Assert) -> None:
        self.report(node, "bare assert is stripped under python -O — raise "
                          "a typed exception so the -O smoke job exercises "
                          "the real error path")
        self.generic_visit(node)
