"""BS006 — kernel launchers import only torch, ctypes and the build loader.

In the port a kernel package splits three ways.  ``csrc/*.cu`` is the
device code, CUDA C++ for ``sm_90a``.  ``kernels/*/kernel.py`` is its
launcher: it builds the source through the shared loader
(``kernels/build.py``), binds the entry points with ``ctypes`` and
launches them on tensors already on the card.  The siblings hold the rest
(``ref.py``: the plain PyTorch version the tests and the CPU run;
``ops.py``: dispatch between the two, padding, launch counts).  An import
of ``ref`` or ``ops`` inside ``kernel.py`` is how the plain version would
cross into the card's path, a silent fallback that still passes every
comparison; a ``numpy`` import is host logic leaking into the launch, and
a ``jax`` one has no place in the port at all.

Allowed roots: ``torch``, ``ctypes`` and stdlib the launchers use
(``functools``/``typing``/``math``/``pathlib``/``collections``/
``__future__``).  Allowed relative imports: the build loader (``..build``)
and another kernel's launcher (``..flash_attention.kernel``, which owns
``DTYPE_CODES``); every other relative import is flagged.

PyTorch port of :mod:`repro.analysis.rules.bs006_kernel_imports`, whose
``kernel.py`` is the Pallas-lowered device code itself.
"""
from __future__ import annotations

import ast
import re
from fnmatch import fnmatch

from .base import Rule, register


@register
class KernelImportRule(Rule):
    id = "BS006"
    title = ("kernels/*/kernel.py imports only torch/ctypes, the build "
             "loader and other launchers (+stdlib)")
    invariant = "launcher/csrc split of the kernel packages"

    def applies(self) -> bool:
        return fnmatch(self.ctx.rel, self.ctx.config.kernel_glob)

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self._check_root(node, alias.name.split(".")[0])

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.level > 0:
            self._check_relative(node)
            return
        self._check_root(node, (node.module or "").split(".")[0])

    def _check_relative(self, node: ast.ImportFrom) -> None:
        spec = "." * node.level + (node.module or "")
        if any(re.fullmatch(pattern, spec)
               for pattern in self.ctx.config.kernel_allowed_relative):
            return
        names = ", ".join(alias.name for alias in node.names)
        self.report(node, f"relative import from {spec!r} ({names}) in a "
                          f"kernel launcher — only the build loader "
                          f"(..build) and another kernel's launcher "
                          f"(..<kernel>.kernel) may be imported; the plain "
                          f"version (ref.py) and the dispatch (ops.py) stay "
                          f"off the card's path")

    def _check_root(self, node: ast.AST, root: str) -> None:
        if root in self.ctx.config.kernel_allowed_roots:
            return
        hint = (" (host-side numpy belongs in ref.py/ops.py)"
                if root == "numpy" else "")
        self.report(node, f"import of {root!r} in a kernel launcher — "
                          f"only {'/'.join(sorted(self.ctx.config.kernel_allowed_roots))} "
                          f"may cross into the launch{hint}")
