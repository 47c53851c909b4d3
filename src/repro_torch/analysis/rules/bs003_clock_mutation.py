"""BS003 — ``Clock``/``SetDigest`` internals are mutated only in ``core/``.

The clock is documented as *purely functional* (every operation returns a
new clock) and the digest's structures are maintained solely by the write
path — invariants 2, 3, and 9 all assume no other layer reaches in and
attribute-assigns their fields.  ``Clock.zero()`` is even a shared
singleton: one ``clock.base = {...}`` outside ``core/`` could corrupt
every empty clock in the process.

Flagged, outside the mutation home (``core/``): plain, augmented, and
annotated assignments — including item assignment through the field,
``clock.cloud[a] = ...`` — to any protected field
(``Clock.base/cloud``, ``SetDigest.fences/buckets/...``).  When the
receiver's type resolves to something *else* the assignment is fine;
when it cannot be resolved at all the rule stays conservative and flags
(suppress with a justification if the name is a coincidence).

PyTorch port: a copy of :mod:`repro.analysis.rules.bs003_clock_mutation`; everything below this
docstring is unchanged.
"""
from __future__ import annotations

import ast
from typing import Optional

from .base import Rule, register


@register
class ClockMutationRule(Rule):
    id = "BS003"
    title = "no Clock/SetDigest attribute assignment outside core/"
    invariant = "invariants 2, 3, 9 (functional clocks, write-path digests)"

    def applies(self) -> bool:
        return not self.ctx.rel.startswith(self.ctx.config.mutation_home)

    # ------------------------------------------------------------- visitors
    def visit_Assign(self, node: ast.Assign) -> None:
        for target in node.targets:
            self._check_target(target)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_target(node.target)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self._check_target(node.target)
        self.generic_visit(node)

    # -------------------------------------------------------------- checks
    def _check_target(self, target: ast.AST) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._check_target(elt)
            return
        attr = self._protected_attr(target)
        if attr is None:
            return
        owners = [t for t, fields in self.ctx.config.protected_fields.items()
                  if attr.attr in fields]
        recv_type = self.ctx.resolver.infer_type(attr.value)
        if recv_type is not None and recv_type not in owners:
            return  # provably some other type's field
        certainty = (f"{recv_type}.{attr.attr}" if recv_type
                     else f".{attr.attr} (receiver type unresolved; field "
                          f"belongs to {'/'.join(owners)})")
        self.report(attr, f"assignment to {certainty} outside "
                          f"{self.ctx.config.mutation_home} — clocks and "
                          f"digests are mutated only by their own layer")

    def _protected_attr(self, target: ast.AST) -> Optional[ast.Attribute]:
        """The protected Attribute being written, unwrapping item writes
        (``x.cloud[a] = ...`` assigns *through* field ``cloud``)."""
        if isinstance(target, ast.Subscript):
            target = target.value
        if isinstance(target, ast.Attribute):
            fields = self.ctx.config.protected_fields.values()
            if any(target.attr in fs for fs in fields):
                return target
        return None
