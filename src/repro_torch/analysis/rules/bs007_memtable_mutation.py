"""BS007 — ``storage/`` memtables are mutated only by WAL-billed entry points.

Invariant 11 (acknowledged ⇒ durable) holds because every memtable write
is framed into the WAL *in the same entry point* that applies it:
``put_batch`` (append + group commit), ``flush`` (swaps in a fresh dict
after publishing the durable segment), ``recover`` (replays the durable
WAL), and construction.  A memtable mutation anywhere else in the
storage layer is state a crash cannot replay — silently un-durable data
that no test would catch until a restart loses it.

Flagged, inside ``storage/`` but outside the configured entry points
(matched by *enclosing function name*, so helpers must route through the
write path rather than rename themselves around the rule): item and
attribute assignment to a ``memtable`` (including through-subscript
writes and tuple-unpacking targets), ``del``, augmented assignment, and
the mutating dict methods (``pop``/``clear``/``update``/``setdefault``/
``popitem``).  Reads are free.

PyTorch port: a copy of :mod:`repro.analysis.rules.bs007_memtable_mutation`; everything below this
docstring is unchanged.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from .base import Rule, register

_MUTATING_CALLS = frozenset({"pop", "clear", "update", "setdefault",
                             "popitem"})


@register
class MemtableMutationRule(Rule):
    id = "BS007"
    title = "storage/ memtable writes flow through WAL-billed entry points"
    invariant = "invariant 11 (acknowledged => durable)"

    def __init__(self, ctx):
        super().__init__(ctx)
        self._funcs: List[str] = []

    def applies(self) -> bool:
        return self.ctx.rel.startswith(self.ctx.config.memtable_layer)

    # ---------------------------------------------------------- func stack
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._funcs.append(node.name)
        self.generic_visit(node)
        self._funcs.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def _allowed_here(self) -> bool:
        return bool(self._funcs) and (
            self._funcs[-1] in self.ctx.config.memtable_entrypoints)

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

    def visit_Delete(self, node: ast.Delete) -> None:
        for target in node.targets:
            self._check_target(target)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if (isinstance(func, ast.Attribute)
                and func.attr in _MUTATING_CALLS
                and self._memtable_attr(func.value) is not None
                and not self._allowed_here()):
            self._flag(func, f"memtable.{func.attr}(...)")
        self.generic_visit(node)

    # -------------------------------------------------------------- checks
    def _check_target(self, target: ast.AST) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._check_target(elt)
            return
        written = target
        if isinstance(written, ast.Subscript):
            written = written.value  # memtable[k] = v writes *through* it
        if self._memtable_attr(written) is None:
            return
        if self._allowed_here():
            return
        kind = ("memtable[...]" if isinstance(target, ast.Subscript)
                else "memtable rebind")
        self._flag(written, kind)

    def _memtable_attr(self, node: ast.AST) -> Optional[ast.AST]:
        """The node naming a memtable: ``x.memtable`` or a bare ``memtable``."""
        if isinstance(node, ast.Attribute) and node.attr == "memtable":
            return node
        if isinstance(node, ast.Name) and node.id == "memtable":
            return node
        return None

    def _flag(self, node: ast.AST, what: str) -> None:
        where = self._funcs[-1] if self._funcs else "<module>"
        allowed = "/".join(sorted(self.ctx.config.memtable_entrypoints))
        self.report(node, f"{what} mutated in {where}() — storage memtables "
                          f"change only inside {allowed} (WAL-billed write "
                          f"path), anything else is un-replayable state")
