"""The bigset-lint rule pack.

Importing this package registers every rule in :data:`RULES` (keyed by
``BS###`` id).  Adding a rule = adding a module here that decorates its
class with :func:`register`; the roadmap's interval-clock and
partitioned-placement work is expected to land rules the same way.

PyTorch port: a copy of :mod:`repro.analysis.rules`; everything below this
docstring is unchanged.
"""
from .base import META_RULE, RULES, Finding, Rule, register

from . import (bs001_wallclock, bs002_billed_send, bs003_clock_mutation,
               bs004_bare_assert, bs005_query_folds, bs006_kernel_imports,
               bs007_memtable_mutation, bs008_dot_enumeration,
               bs009_vnode_indexing)  # noqa: F401 (import = registration)

__all__ = ["META_RULE", "RULES", "Finding", "Rule", "register"]
