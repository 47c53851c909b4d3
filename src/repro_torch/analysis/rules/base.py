"""Rule plumbing: the registry, the base visitor, and findings.

A rule is one :class:`ast.NodeVisitor` subclass with a stable ``id``
(``BS###``), a one-line ``title``, and the architecture invariant it
enforces (``invariant`` — the number in docs/ARCHITECTURE.md, or a CI
discipline).  Rules see one file at a time through a
:class:`~repro_torch.analysis.engine.FileContext` that carries the parsed
tree, the package-relative path for scoping, the shared
:class:`~repro_torch.analysis.resolve.Resolver`, and the active config.

PyTorch port: a copy of :mod:`repro.analysis.rules.base`; everything below this
docstring is unchanged.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, Type

#: meta rule id used by the engine itself: parse failures, unknown rule
#: ids in suppressions, unused suppressions, missing justifications
META_RULE = "BS000"


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # as given on the command line / to run_lint
    line: int
    col: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


RULES: Dict[str, Type["Rule"]] = {}


def register(cls: Type["Rule"]) -> Type["Rule"]:
    if cls.id in RULES:
        raise ValueError(f"duplicate rule id {cls.id}")
    RULES[cls.id] = cls
    return cls


class Rule(ast.NodeVisitor):
    id: str = ""
    title: str = ""
    invariant: str = ""

    def __init__(self, ctx):
        self.ctx = ctx

    def applies(self) -> bool:
        """Path scoping: return False to skip this file entirely."""
        return True

    def run(self) -> None:
        if self.applies():
            self.visit(self.ctx.tree)

    def report(self, node: ast.AST, message: str) -> None:
        self.ctx.report(self.id, node, message)
