"""The lint engine: file discovery, suppressions, and rule execution.

One pass per file: parse once, build one shared
:class:`~repro_torch.analysis.resolve.Resolver`, run every in-scope rule
over the tree, then apply suppressions.

Suppression syntax (line-scoped, justification **required**)::

    self.clock = time.monotonic  # bigset-lint-torch: disable=BS001 -- injectable default; tests inject a fake

A suppression that names an unknown rule, lacks the ``-- why`` tail, or
suppresses nothing on its line is itself a finding (``BS000``) — stale
escapes rot into silent holes otherwise, so the engine treats them as
lint debt too.

PyTorch port of :mod:`repro.analysis.engine`, with two changes.  Paths
scope by the enclosing ``repro_torch`` package (a ``repro`` one is still
recognised, so the reference's fixtures scope as they always did), and
the escape is the port's own ``# bigset-lint-torch:`` directive.  CI
still runs the reference's linter over all of ``src/``, which reads only
``# bigset-lint:``: an escape one linter needs would be an unused
suppression to the other, so neither reads the other's.
"""
from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .config import DEFAULT_CONFIG, LintConfig
from .resolve import Resolver
from .rules import META_RULE, RULES, Finding

_SUPPRESS_RE = re.compile(
    r"#\s*bigset-lint-torch:\s*disable=([A-Za-z0-9_,\s]+?)"
    r"(?:--\s*(.*?))?\s*$")


@dataclass
class Suppression:
    line: int
    rules: Tuple[str, ...]
    justification: str
    used: set = field(default_factory=set)


@dataclass
class FileContext:
    """Everything a rule sees about the file under analysis."""
    path: str            # as reported in findings
    rel: str             # package-relative path, for config scoping
    tree: ast.Module
    resolver: Resolver
    config: LintConfig
    findings: List[Finding] = field(default_factory=list)

    def report(self, rule_id: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            rule_id, self.path,
            getattr(node, "lineno", 0), getattr(node, "col_offset", 0),
            message))


@dataclass
class LintResult:
    findings: List[Finding]
    files_checked: int
    rules: Tuple[str, ...]        # rule ids that ran
    suppressed: int = 0           # findings silenced by used suppressions

    @property
    def ok(self) -> bool:
        return not self.findings


#: the package directories a path scopes by, the port's and the reference's
PACKAGES = ("repro_torch", "repro")


def package_rel(path: Path) -> str:
    """``path`` relative to its enclosing ``repro_torch`` (or ``repro``)
    package directory.

    ``src/repro_torch/core/clock.py`` -> ``core/clock.py``;
    ``tests/lint_fixtures/repro/core/x.py`` -> ``core/x.py`` — the same
    scoped config lints the port's tree, the reference's, and the test
    fixtures.  A path with no such ancestor scopes by its own parts.
    """
    parts = path.parts
    for i in range(len(parts) - 2, -1, -1):
        if parts[i] in PACKAGES:
            return "/".join(parts[i + 1:])
    return path.as_posix()


def iter_python_files(paths: Sequence[str]) -> Iterable[Path]:
    seen = set()
    for raw in paths:
        p = Path(raw)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            if f not in seen:
                seen.add(f)
                yield f


def parse_suppressions(source: str, active_rules: Sequence[str]
                       ) -> Tuple[Dict[int, Suppression], List[Tuple[int, str]]]:
    """Line -> suppression, plus (line, message) syntax problems.

    Tokenizes rather than greps, so only genuine ``#`` comments count — a
    docstring *describing* the syntax is not a suppression.
    """
    table: Dict[int, Suppression] = {}
    problems: List[Tuple[int, str]] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError):
        return table, problems  # the parse finding already covers this file
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        lineno = tok.start[0]
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        justification = (m.group(2) or "").strip()
        for r in rules:
            if r not in RULES and r != META_RULE:
                problems.append(
                    (lineno, f"suppression names unknown rule {r!r}"))
        if not justification:
            problems.append(
                (lineno, "suppression without a justification — append "
                         "'-- why this is safe'"))
        table[lineno] = Suppression(lineno, rules, justification)
    return table, problems


def lint_file(path: Path, config: LintConfig,
              rule_ids: Sequence[str]) -> Tuple[List[Finding], int]:
    """Lint one file; returns (findings, suppressed_count)."""
    display = str(path)
    try:
        source = path.read_text(encoding="utf-8")
        tree = ast.parse(source, filename=display)
    except (SyntaxError, UnicodeDecodeError, OSError) as exc:
        line = getattr(exc, "lineno", 0) or 0
        return [Finding(META_RULE, display, line, 0,
                        f"could not parse: {exc}")], 0

    ctx = FileContext(display, package_rel(path), tree, Resolver(tree), config)
    for rid in rule_ids:
        RULES[rid](ctx).run()

    suppressions, problems = parse_suppressions(source, rule_ids)
    kept: List[Finding] = []
    suppressed = 0
    for finding in ctx.findings:
        sup = suppressions.get(finding.line)
        if sup is not None and finding.rule in sup.rules:
            sup.used.add(finding.rule)
            suppressed += 1
        else:
            kept.append(finding)
    for line, msg in problems:
        kept.append(Finding(META_RULE, display, line, 0, msg))
    for sup in suppressions.values():
        for rid in sup.rules:
            # only judge unusedness for rules that actually ran: a narrowed
            # --select must not make every other suppression look stale
            if rid in rule_ids and rid not in sup.used:
                kept.append(Finding(
                    META_RULE, display, sup.line, 0,
                    f"unused suppression of {rid} — nothing on this line "
                    f"triggers it; delete the escape"))
    return kept, suppressed


def run_lint(paths: Sequence[str],
             config: Optional[LintConfig] = None) -> LintResult:
    """Run the active rule pack over ``paths`` (files or directory trees)."""
    config = config or DEFAULT_CONFIG
    rule_ids = tuple(rid for rid in sorted(RULES) if config.runs(rid))
    findings: List[Finding] = []
    files = 0
    suppressed = 0
    for path in iter_python_files(paths):
        files += 1
        got, sup = lint_file(path, config, rule_ids)
        findings.extend(got)
        suppressed += sup
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return LintResult(findings, files, rule_ids, suppressed)
