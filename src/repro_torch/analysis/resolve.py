"""Shared symbol and import resolution for the rule pack.

One :class:`Resolver` is built per file and handed to every rule, so each
rule answers two questions without owning its own scope analysis:

* :meth:`Resolver.dotted` — what fully-qualified module path does this
  ``Name``/``Attribute`` chain denote?  (``np.random.rand`` resolves
  through ``import numpy as np`` to ``numpy.random.rand``; a chain rooted
  in a local variable resolves to ``None``.)
* :meth:`Resolver.infer_type` — what class does this expression hold?
  Resolution is deliberately shallow but covers the codebase's idioms:
  constructor calls (``Network()``), classmethod factories
  (``Clock.zero()``), ``a or Network()`` defaults, annotated parameters
  (``net: Network``), annotated/constructed locals, and ``self.x``
  attributes assigned or annotated anywhere in the enclosing class.

Unknown stays unknown (``None``) — rules choose how conservative to be.

PyTorch port: a copy of :mod:`repro.analysis.resolve`; everything below this
docstring is unchanged.
"""
from __future__ import annotations

import ast
from typing import Dict, Optional, Tuple


def terminal_name(node: ast.AST) -> Optional[str]:
    """The last identifier of a ``Name``/``Attribute`` chain (else None)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _annotation_type(ann: Optional[ast.AST]) -> Optional[str]:
    """Class name out of a simple annotation (``Network``, ``sim.Network``,
    ``Optional[Network]`` is *not* unwrapped — shallow on purpose)."""
    name = terminal_name(ann) if ann is not None else None
    if name and name[:1].isupper():
        return name
    return None


class Resolver:
    def __init__(self, tree: ast.Module):
        self.tree = tree
        #: local alias -> dotted module/attr path ("np" -> "numpy")
        self.imports: Dict[str, str] = {}
        #: module-level class definitions in this file
        self.classes: set = set()
        #: (class name, attr) -> type name, from self.<attr> = / : annotations
        self.class_attr_types: Dict[Tuple[str, str], str] = {}
        #: id(function node) -> {local name: type name}
        self.func_local_types: Dict[int, Dict[str, str]] = {}
        #: id(node) -> parent node, for enclosing-scope lookup
        self.parents: Dict[int, ast.AST] = {}
        self._build(tree)

    # ------------------------------------------------------------- building
    def _build(self, tree: ast.Module) -> None:
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[id(child)] = node
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    self.imports[alias.asname or alias.name.split(".")[0]] = (
                        alias.name if alias.asname else alias.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                for alias in node.names:
                    full = f"{node.module}.{alias.name}" if node.module else alias.name
                    self.imports[alias.asname or alias.name] = full
            elif isinstance(node, ast.ImportFrom):
                # relative import: unresolvable module path, but the bound
                # name may still be a class (".clock" -> "Clock")
                for alias in node.names:
                    if alias.name[:1].isupper():
                        self.classes.add(alias.asname or alias.name)
            elif isinstance(node, ast.ClassDef):
                self.classes.add(node.name)
                self._index_class(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._index_function(node)

    def _index_class(self, cls: ast.ClassDef) -> None:
        for node in ast.walk(cls):
            target = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                target, value = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign):
                target, value = node.target, node.value
            else:
                continue
            if not (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"):
                continue
            typ = (_annotation_type(node.annotation)
                   if isinstance(node, ast.AnnAssign) else None)
            typ = typ or self._expr_type(value)
            if typ:
                self.class_attr_types.setdefault((cls.name, target.attr), typ)

    def _index_function(self, fn) -> None:
        locals_: Dict[str, str] = {}
        args = fn.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs
                  + ([args.vararg] if args.vararg else [])
                  + ([args.kwarg] if args.kwarg else [])):
            typ = _annotation_type(a.annotation)
            if typ:
                locals_[a.arg] = typ
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                typ = self._expr_type(node.value)
                if typ:
                    locals_[node.targets[0].id] = typ
            elif isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name):
                typ = _annotation_type(node.annotation) \
                    or self._expr_type(node.value)
                if typ:
                    locals_[node.target.id] = typ
        self.func_local_types[id(fn)] = locals_

    def _expr_type(self, expr: Optional[ast.AST]) -> Optional[str]:
        """Type of a constructing expression, else None."""
        if expr is None:
            return None
        if isinstance(expr, ast.Call):
            return self._ctor_name(expr.func)
        if isinstance(expr, ast.BoolOp):  # ``net or Network()`` defaults
            for operand in expr.values:
                typ = self._expr_type(operand)
                if typ:
                    return typ
        return None

    def _ctor_name(self, func: ast.AST) -> Optional[str]:
        """Class name a call constructs: ``Network(...)``, ``sim.Network(...)``,
        and classmethod factories like ``Clock.zero()``."""
        dotted = self.dotted(func)
        segs = dotted.split(".") if dotted else []
        if not segs:
            name = terminal_name(func)
            if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name) \
                    and func.value.id in self.classes:
                return func.value.id  # LocalClass.factory()
            if name and name in self.classes:
                return name
            return name if name and name[:1].isupper() else None
        # rightmost Capitalized segment is the class; trailing lowercase
        # segments are factory methods on it
        for seg in reversed(segs):
            if seg[:1].isupper():
                return seg
        return None

    # -------------------------------------------------------------- queries
    def dotted(self, node: ast.AST) -> Optional[str]:
        """Fully-resolved dotted path of a Name/Attribute chain rooted in an
        import, else None (local receivers are *not* module references)."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.imports.get(node.id)
        if root is None:
            return None
        parts.append(root)
        return ".".join(reversed(parts))

    def enclosing(self, node: ast.AST, kinds) -> Optional[ast.AST]:
        cur = self.parents.get(id(node))
        while cur is not None:
            if isinstance(cur, kinds):
                return cur
            cur = self.parents.get(id(cur))
        return None

    def infer_type(self, expr: ast.AST) -> Optional[str]:
        """Best-effort class name held by ``expr`` (see module docstring)."""
        if isinstance(expr, ast.Name) and expr.id == "self":
            cls = self.enclosing(expr, ast.ClassDef)
            if cls is not None:
                return cls.name
        if isinstance(expr, ast.Name):
            fn = self.enclosing(expr, (ast.FunctionDef, ast.AsyncFunctionDef))
            while fn is not None:
                typ = self.func_local_types.get(id(fn), {}).get(expr.id)
                if typ:
                    return typ
                fn = self.enclosing(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
            return None
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self":
            cls = self.enclosing(expr, ast.ClassDef)
            if cls is not None:
                return self.class_attr_types.get((cls.name, expr.attr))
            return None
        return self._expr_type(expr)
