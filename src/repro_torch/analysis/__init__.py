"""bigset-lint for the PyTorch port: static analysis over Python's ``ast``.

The architecture's invariants (docs/ARCHITECTURE.md) are discipline the
code cannot locally see — writes read only clocks, queries seek and
never fold, every ``Network.send`` bills wire bytes, disabled tracing
leaves traffic byte-identical.  This package turns the enforceable
subset into rules over the port's own layers:

========  ==========================================================
BS001     deterministic layers read only injected clocks/RNGs (torch's
          samplers only with ``generator=``)
BS002     ``Network.send`` call sites pass an explicit ``size_bytes``
BS003     ``Clock``/``SetDigest`` fields mutated only in ``core/``
BS004     library code raises typed exceptions, not bare ``assert``
BS005     ``query/``/``serve/`` never call full-fold entry points
BS006     ``kernels/*/kernel.py`` launchers import only torch/ctypes,
          the build loader and other launchers
BS007     ``storage/`` memtables mutate only in WAL-billed entry points
BS008     no raw dot-cloud enumeration outside ``core/``
BS009     vnode identities come from ``cluster/placement.py`` only
========  ==========================================================

Run it: ``python -m repro_torch.analysis`` (default ``src/repro_torch``;
exit 1 on findings).  Silence a deliberate exception at its line,
justification required::

    ... # bigset-lint-torch: disable=BS001 -- injectable default; tests inject

The reference's linter (``python -m repro.analysis src``, CI's lint job)
reads only its own ``# bigset-lint:`` escapes, and this one only
``# bigset-lint-torch:``, so each tree's escapes serve one linter.

Programmatic use: :func:`run_lint` returns a :class:`LintResult`; the
per-rule ``NodeVisitor``s share one import/symbol
:class:`~repro_torch.analysis.resolve.Resolver` per file, and new rules
register by decorating a :class:`~repro_torch.analysis.rules.Rule`
subclass with :func:`~repro_torch.analysis.rules.register`.

PyTorch port of :mod:`repro.analysis`.
"""
from .config import DEFAULT_CONFIG, LintConfig
from .engine import FileContext, LintResult, lint_file, run_lint
from .report import render_human, render_json, render_json_text
from .rules import META_RULE, RULES, Finding, Rule, register

__all__ = [
    "DEFAULT_CONFIG", "LintConfig", "FileContext", "LintResult",
    "lint_file", "run_lint", "render_human", "render_json",
    "render_json_text", "META_RULE", "RULES", "Finding", "Rule", "register",
]
