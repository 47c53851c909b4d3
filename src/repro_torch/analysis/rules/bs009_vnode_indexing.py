"""BS009 — no direct vnode indexing outside ``cluster/placement.py``.

Partitioned placement (invariant 13) makes "which vnode holds this?" a
ring question: owners come from ``Ring.preference_list`` /
``plan_coverage``, never from a position in a vnode list.  A literal
``self.vnodes[0]`` or ``_actor(2)`` hardwires an owner that a ring-epoch
bump may move — correct today, silently wrong after the next handoff,
and invisible to the coverage accounting the wire-billing claims rest
on.  The placement module itself is the one home allowed to turn
positions into identities (it *defines* the ranking); everywhere else,
indexing a vnode collection is only sanctioned with a computed key (an
actor name, a routed variable) — literal integer positions are flagged.

Flagged, outside ``placement_home``: subscripts of receivers named in
``vnode_collections`` (``vnodes`` / ``actors`` / ``stores``) with a
literal-int index, and calls to the routing helpers in
``vnode_route_calls`` (``_actor`` / ``_coordinator``) passing a literal
int.  Slices (``actors[:r]``) and computed keys stay clean — quorum
prefixes and name-keyed lookups are not placement decisions.

PyTorch port: a copy of :mod:`repro.analysis.rules.bs009_vnode_indexing`; everything below this
docstring is unchanged.
"""
from __future__ import annotations

import ast

from .base import Rule, register


@register
class VnodeIndexingRule(Rule):
    id = "BS009"
    title = "no direct vnode indexing outside cluster/placement.py"
    invariant = "invariant 13 (all routing goes through the ring)"

    def applies(self) -> bool:
        return self.ctx.rel != self.ctx.config.placement_home

    # ------------------------------------------------------------- visitors
    def visit_Subscript(self, node: ast.Subscript) -> None:
        name = self._collection_name(node.value)
        if (name in self.ctx.config.vnode_collections
                and self._literal_int(node.slice) is not None):
            self.report(
                node,
                f"literal index into .{name} — placement belongs to the "
                f"ring ({self.ctx.config.placement_home}); route via "
                f"Ring.preference_list/plan_coverage (invariant 13)")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        name = (func.attr if isinstance(func, ast.Attribute)
                else func.id if isinstance(func, ast.Name) else None)
        if name in self.ctx.config.vnode_route_calls and any(
                self._literal_int(a) is not None for a in node.args):
            self.report(
                node,
                f"{name}() with a literal vnode position — hardwires an "
                f"owner the ring may move; pass a routed actor "
                f"(invariant 13)")
        self.generic_visit(node)

    # -------------------------------------------------------------- checks
    @staticmethod
    def _collection_name(value: ast.AST):
        if isinstance(value, ast.Attribute):
            return value.attr
        if isinstance(value, ast.Name):
            return value.id
        return None

    @staticmethod
    def _literal_int(node: ast.AST):
        """The int a literal (possibly negated) index denotes, else None."""
        if (isinstance(node, ast.UnaryOp)
                and isinstance(node.op, (ast.USub, ast.UAdd))):
            node = node.operand
        if (isinstance(node, ast.Constant) and isinstance(node.value, int)
                and not isinstance(node.value, bool)):
            return node.value
        return None
