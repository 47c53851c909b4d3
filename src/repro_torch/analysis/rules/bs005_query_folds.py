"""BS005 — ``query/`` and ``serve/`` seek; they never full-fold.

Invariant 4 is the paper's §4.4 promise: a query costs O(result + causal
metadata), because every plan positions the LSM iterator and stops at
its range end.  The full-fold entry points on the vnode —
``fold``/``fold_values`` (whole-set streams), ``read_full``/``value``
(materialise the set) — exist for tests, checkpoints, and anti-entropy's
baseline, and one call from the query or serve layer would quietly turn
a seek-priced plan into an O(n) scan that still returns the right
answer.  The bounded entry points (``fold_raw``, ``fold_postings``,
``element_cursor``, ``store.seek(lo, hi)``) are the sanctioned surface.

Also flagged: ``.scan()`` called with no bounds — the storage layer's
everything-iterator.

PyTorch port: a copy of :mod:`repro.analysis.rules.bs005_query_folds`; everything below this
docstring is unchanged.
"""
from __future__ import annotations

import ast

from .base import Rule, register


@register
class QueryFoldRule(Rule):
    id = "BS005"
    title = "query/serve layers never call full-fold storage entry points"
    invariant = "invariants 4 and 7 (queries seek, never fold)"

    def applies(self) -> bool:
        return self.ctx.rel.startswith(
            tuple(self.ctx.config.seek_only_layers))

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            if func.attr in self.ctx.config.fold_denylist:
                self.report(node, f"full-fold entry point .{func.attr}() in "
                                  f"a seek-only layer — use fold_raw/"
                                  f"fold_postings/element_cursor with bounds "
                                  f"(invariant 4)")
            elif func.attr == "scan" and not node.args and not node.keywords:
                self.report(node, "unbounded .scan() in a seek-only layer — "
                                  "pass [lo, hi) bounds or use seek()")
        self.generic_visit(node)
