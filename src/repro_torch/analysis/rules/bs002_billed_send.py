"""BS002 — every ``Network.send`` call site bills explicit wire bytes.

``Network.bytes_sent`` feeds the paper's wire-cost comparisons (§3, §5)
and the ``net.*`` metrics; one call site passing a default or missing
``size_bytes`` silently zeroes a whole benchmark column (a known bug
class: a zero-billed send made anti-entropy traffic look free).  The
runtime guard in ``cluster/sim.py`` rejects non-empty payloads billed at
zero, but only when that path *executes* — this rule moves the check to
the call site, statically.

A send is compliant when it passes four positional arguments
(``src, dst, payload, size_bytes``) or an explicit ``size_bytes=``
keyword.  Receivers are recognised by resolved type (``Network``) or,
when unresolvable, by the conventional attribute names ``net`` /
``network``.

PyTorch port: a copy of :mod:`repro.analysis.rules.bs002_billed_send`; everything below this
docstring is unchanged.
"""
from __future__ import annotations

import ast

from .base import Rule, register
from ..resolve import terminal_name


@register
class BilledSendRule(Rule):
    id = "BS002"
    title = "Network.send call sites pass an explicit size_bytes"
    invariant = "wire-cost accounting (§3/§5 tables, net.* metrics)"

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr == "send":
            recv_type = self.ctx.resolver.infer_type(func.value)
            hinted = terminal_name(func.value) in \
                self.ctx.config.network_attr_hints
            if recv_type in self.ctx.config.network_types \
                    or (recv_type is None and hinted):
                if not self._bills_size(node):
                    self.report(node, "Network.send without an explicit "
                                      "size_bytes — unbilled wire traffic "
                                      "zeroes the §3/§5 byte comparisons")
        self.generic_visit(node)

    @staticmethod
    def _bills_size(node: ast.Call) -> bool:
        if any(kw.arg == "size_bytes" for kw in node.keywords):
            return True
        if any(kw.arg is None for kw in node.keywords):
            return True  # **kwargs: give the benefit of the doubt
        if any(isinstance(a, ast.Starred) for a in node.args):
            return True  # *args: cannot count statically
        return len(node.args) >= 4
