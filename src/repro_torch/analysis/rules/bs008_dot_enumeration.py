"""BS008 — no raw per-dot cloud enumeration outside ``core/``.

Invariant 12 is the interval-clock bound: every clock operation and every
serialized clock costs O(interval runs) — causal metadata — never
O(events) or O(removed dots).  The run-granular surface
(``iter_runs``/``diff_runs``/``add_runs``/``subtract_clock``/
``intersect``/``n_runs``/``size_bytes``) preserves that bound; the
per-dot surface exists for core internals, tests, and oracles only.
One ``clock.all_dots()`` loop in cluster or serve code would quietly
re-introduce the O(fragmentation) cost the refactor removed — correct
answers, paper-breaking asymptotics.

Flagged, outside the mutation home (``core/``): reads of the ``.cloud``
compatibility property (it *materialises* per-actor frozensets from the
runs) and calls to ``.all_dots()``.  When the receiver provably has some
other type the access is fine; unresolved receivers are flagged
conservatively (suppress with a justification if the name is a
coincidence).  ``diff_dots`` stays sanctioned: it enumerates only the
actual divergence, already materialised from run subtraction.

PyTorch port: a copy of :mod:`repro.analysis.rules.bs008_dot_enumeration`; everything below this
docstring is unchanged.
"""
from __future__ import annotations

import ast

from .base import Rule, register


@register
class DotEnumerationRule(Rule):
    id = "BS008"
    title = "no raw per-dot cloud enumeration outside core/"
    invariant = "invariant 12 (clock cost is bounded by interval runs)"

    def applies(self) -> bool:
        return not self.ctx.rel.startswith(self.ctx.config.mutation_home)

    # ------------------------------------------------------------- visitors
    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if (isinstance(func, ast.Attribute)
                and func.attr in self.ctx.config.dot_enumeration_calls
                and self._clock_receiver(func.value)):
            self.report(func, f".{func.attr}() outside "
                              f"{self.ctx.config.mutation_home} — enumerates "
                              f"every dot; use the run-granular surface "
                              f"(iter_runs/diff_runs/add_runs, invariant 12)")
            # the callee Attribute is handled; still walk args etc.
            for child in ast.iter_child_nodes(node):
                if child is not func:
                    self.visit(child)
            self.visit(func.value)
            return
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (node.attr in self.ctx.config.dot_enumeration_fields
                and self._clock_receiver(node.value)):
            self.report(node, f".{node.attr} outside "
                              f"{self.ctx.config.mutation_home} — the per-dot "
                              f"cloud view is O(events) to materialise; use "
                              f"iter_runs()/n_runs() (invariant 12)")
        self.generic_visit(node)

    # -------------------------------------------------------------- checks
    def _clock_receiver(self, value: ast.AST) -> bool:
        recv_type = self.ctx.resolver.infer_type(value)
        return recv_type is None or recv_type == "Clock"
