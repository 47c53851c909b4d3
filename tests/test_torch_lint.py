"""bigset-lint for the port (``repro_torch.analysis``).

The port lints its own package by its own layers, and reads its own
escape directive, ``# bigset-lint-torch:``; the reference's linter
(``repro.analysis``, CI's lint job over all of ``src/``) reads only
``# bigset-lint:``.  Held here:

* parity: every reference golden fixture but the two Pallas
  ``kernel.py``, copied under a ``repro_torch`` directory with the
  directive substituted, gives the reference's ``GOLDEN`` findings;
* the port's own rules, on ``tests/lint_fixtures_torch/repro_torch/``:
  BS006 read for the launcher / ``csrc`` split of a kernel package, and
  BS001 with torch's process-global RNG;
* the self-check: ``src/repro_torch`` is clean, with exactly its three
  BS001 escapes used, and a violation put back fails the run;
* the port's linter on the reference tree finds exactly the BS001 sites
  the reference escapes (their directive is not the port's);
* the command line, in a subprocess, and the package's import boundary.
"""
from __future__ import annotations

import io
import json
import re
import subprocess
import sys
import tokenize
from fnmatch import fnmatch
from pathlib import Path

import pytest

from repro.analysis import run_lint as ref_run_lint
from repro.analysis.engine import _SUPPRESS_RE as REF_SUPPRESS_RE
from repro_torch.analysis import (DEFAULT_CONFIG, META_RULE, RULES,
                                  render_json, run_lint)
from repro_torch.analysis.__main__ import main as lint_main
from repro_torch.analysis.engine import _SUPPRESS_RE, package_rel
from test_lint import GOLDEN

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "lint_fixtures"
FIXTURES_TORCH = REPO / "tests" / "lint_fixtures_torch"
SRC = REPO / "src"
PORT, REF = SRC / "repro_torch", SRC / "repro"
ALL_RULES = ("BS001", "BS002", "BS003", "BS004", "BS005", "BS006", "BS007",
             "BS008", "BS009")

#: the reference's fixtures the port reads alike: all but its two Pallas
#: kernel files, which the port's BS006 reads as launchers
PARITY = sorted(rel for rel in GOLDEN
                if not fnmatch(rel, "repro/kernels/*/kernel.py"))

#: the port's own fixtures -> exact [(rule, line), ...] expected
GOLDEN_TORCH = {
    "repro_torch/kernels/demo/kernel.py": [
        ("BS006", 5), ("BS006", 6), ("BS006", 8), ("BS006", 9),
        ("BS006", 10), ("BS006", 11),
    ],
    "repro_torch/kernels/demo/ref.py": [],
    "repro_torch/kernels/launcher/kernel.py": [],
    "repro_torch/kernels/escaped/kernel.py": [],
    "repro_torch/core/bs001_torch_positive.py": [
        ("BS001", line) for line in (7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
                                     21, 22, 23, 24)
    ],
    "repro_torch/core/bs001_torch_negative.py": [],
    "repro_torch/core/bs001_torch_suppressed.py": [],
    "repro_torch/core/bs001_reference_directive.py": [("BS001", 6)],
    "repro_torch/models/bs001_out_of_scope.py": [],
}


def _to_port_directive(text: str) -> str:
    return re.sub(r"#(\s*)bigset-lint:", r"#\1bigset-lint-torch:", text)


def _copy_fixture(rel: str, root: Path, port_directive: bool = True,
                  package: str = "repro_torch") -> Path:
    """The reference fixture ``rel`` under ``root/<package>/``."""
    dst = root / package / Path(rel).relative_to("repro")
    dst.parent.mkdir(parents=True, exist_ok=True)
    text = (FIXTURES / rel).read_text()
    dst.write_text(_to_port_directive(text) if port_directive else text)
    return dst


def _pairs(result):
    return [(f.rule, f.line) for f in result.findings]


def _escapes(root: Path, pattern):
    """(package-relative path, line, rules) of every escape comment that
    ``pattern`` reads under ``root``."""
    out = []
    for path in sorted(root.rglob("*.py")):
        source = path.read_text()
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            m = (pattern.search(tok.string)
                 if tok.type == tokenize.COMMENT else None)
            if m:
                rules = tuple(r.strip() for r in m.group(1).split(",")
                              if r.strip())
                out.append((package_rel(path), tok.start[0], rules))
    return out


# --------------------------------------------------------------- parity
@pytest.mark.parametrize("rel", PARITY)
def test_reference_fixture_gives_the_reference_findings(rel, tmp_path):
    result = run_lint([str(_copy_fixture(rel, tmp_path))])
    assert _pairs(result) == GOLDEN[rel]
    assert result.rules == ALL_RULES


def test_reference_fixtures_suppress_and_run_as_the_reference(tmp_path):
    for rel in PARITY:
        _copy_fixture(rel, tmp_path)
    result = run_lint([str(tmp_path)])
    assert result.files_checked == len(PARITY) == len(GOLDEN) - 2
    # the six *_suppressed fixtures and the justification-less (still
    # applied) escape in bs000_bad_suppressions, as in the reference
    assert result.suppressed == 7
    assert result.rules == ALL_RULES == tuple(sorted(RULES))
    assert len(result.findings) == sum(len(GOLDEN[r]) for r in PARITY)


def test_each_linter_reads_only_its_own_directive(tmp_path):
    rel = "repro/core/bs001_suppressed.py"
    # under ``repro/``, which both linters scope as the package
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    as_port = _copy_fixture(rel, port_dir, package="repro")
    as_ref = _copy_fixture(rel, ref_dir, port_directive=False,
                           package="repro")
    assert _pairs(run_lint([str(as_port)])) == []
    assert _pairs(ref_run_lint([str(as_ref)])) == []
    # the other linter's escape is a plain comment: the finding stands,
    # and no BS000 calls the escape unused or malformed
    assert _pairs(run_lint([str(as_ref)])) == [("BS001", 6)]
    assert _pairs(ref_run_lint([str(as_port)])) == [("BS001", 6)]


@pytest.mark.parametrize("comment, port, ref", [
    ("# bigset-lint-torch: disable=BS001 -- why", True, False),
    ("#bigset-lint-torch:disable=BS003,BS008 -- why", True, False),
    ("# bigset-lint: disable=BS001 -- why", False, True),
    ("# bigset-lint:disable=BS003", False, True),
])
def test_directive_patterns_are_disjoint(comment, port, ref):
    assert bool(_SUPPRESS_RE.search(comment)) is port
    assert bool(REF_SUPPRESS_RE.search(comment)) is ref


def test_package_rel_scopes_by_either_package():
    assert package_rel(Path("src/repro_torch/core/clock.py")) == "core/clock.py"
    assert package_rel(Path("src/repro/core/clock.py")) == "core/clock.py"
    assert package_rel(Path(
        "tests/lint_fixtures_torch/repro_torch/kernels/demo/kernel.py")
    ) == "kernels/demo/kernel.py"
    # the innermost package wins
    assert package_rel(Path("x/repro/y/repro_torch/query/a.py")) == "query/a.py"
    assert package_rel(Path("elsewhere/mod.py")) == "elsewhere/mod.py"


# ------------------------------------------------------ the port's rules
class TestPortFixtures:
    @pytest.fixture(scope="class")
    def fixture_result(self):
        return run_lint([str(FIXTURES_TORCH)])

    @pytest.mark.parametrize("rel", sorted(GOLDEN_TORCH))
    def test_fixture_matches_golden(self, fixture_result, rel):
        got = [(f.rule, f.line) for f in fixture_result.findings
               if Path(f.path).relative_to(FIXTURES_TORCH).as_posix() == rel]
        assert got == GOLDEN_TORCH[rel]

    def test_inventory_and_suppressions(self, fixture_result):
        on_disk = {p.relative_to(FIXTURES_TORCH).as_posix()
                   for p in FIXTURES_TORCH.rglob("*.py")}
        assert on_disk == set(GOLDEN_TORCH)
        assert fixture_result.files_checked == len(GOLDEN_TORCH)
        # kernels/escaped (BS006) and core/bs001_torch_suppressed (BS001)
        assert fixture_result.suppressed == 2
        assert len(fixture_result.findings) == sum(
            len(v) for v in GOLDEN_TORCH.values())


def test_bs006_passes_the_real_launchers():
    launchers = sorted(PORT.glob("kernels/*/kernel.py"))
    assert len(launchers) == 5
    result = run_lint([str(p) for p in launchers],
                      DEFAULT_CONFIG.with_rules(select=frozenset({"BS006"})))
    assert result.ok, "\n" + "\n".join(f.render() for f in result.findings)
    assert result.files_checked == 5 and result.suppressed == 0


# ------------------------------------------------------------ self-check
class TestSelfCheck:
    def test_src_repro_torch_is_clean(self):
        result = run_lint([str(PORT)])
        assert result.ok, "\n" + "\n".join(f.render() for f in result.findings)
        assert result.files_checked > 100
        assert result.rules == ALL_RULES
        assert result.suppressed == 3

    def test_the_escapes_used_are_the_three_bs001_sites(self):
        assert _escapes(PORT, _SUPPRESS_RE) == [
            ("obs/trace.py", 103, ("BS001",)),
            ("serve/bigset_service.py", 179, ("BS001",)),
            ("serve/bigset_service.py", 282, ("BS001",)),
        ]

    def test_reintroduced_violation_fails(self, tmp_path):
        bad = tmp_path / "repro_torch" / "query" / "regression.py"
        bad.parent.mkdir(parents=True)
        bad.write_text("import time\n\n\ndef now():\n    return time.time()\n")
        result = run_lint([str(tmp_path)])
        assert _pairs(result) == [("BS001", 5)]
        assert lint_main([str(tmp_path)]) == 1


def test_port_linter_on_the_reference_finds_its_escaped_bs001_sites():
    """Same code, same rule: the reference's BS001 escapes are the sites
    the port's linter finds there, since it does not read their
    directive (BS006 reads the Pallas kernels as launchers: left out)."""
    result = run_lint([str(REF)],
                      DEFAULT_CONFIG.with_rules(ignore=frozenset({"BS006"})))
    got = sorted((package_rel(Path(f.path)), f.line, f.rule)
                 for f in result.findings)
    escaped = _escapes(REF, REF_SUPPRESS_RE)
    want = sorted((rel, line, "BS001") for rel, line, rules in escaped
                  if "BS001" in rules)
    assert got == want
    assert [(rel, line) for rel, line, _ in want] == [
        ("obs/trace.py", 97), ("serve/bigset_service.py", 173),
        ("serve/bigset_service.py", 276)]
    assert result.suppressed == 0


# ------------------------------------------------------- command line
def _run(args, cwd=REPO):
    return subprocess.run(
        [sys.executable, *args], capture_output=True, text=True, cwd=cwd,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}, timeout=120)


def test_module_entrypoint_lints_the_port_and_writes_json(tmp_path):
    out = tmp_path / "lint.json"
    proc = _run(["-m", "repro_torch.analysis", "src/repro_torch",
                 "--json-out", str(out)])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "bigset-lint: clean" in proc.stdout
    doc = json.loads(out.read_text())
    assert doc["ok"] is True and doc["findings"] == []
    assert doc["files_checked"] > 100 and doc["suppressed"] == 3
    assert doc["rules"] == list(ALL_RULES)
    # no path: the port's package, from the repo root
    proc = _run(["-m", "repro_torch.analysis", "--format", "json"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert json.loads(proc.stdout)["files_checked"] == doc["files_checked"]


def test_cli_flags(tmp_path, capsys):
    assert lint_main([str(FIXTURES_TORCH)]) == 1
    assert lint_main([str(FIXTURES_TORCH), "--ignore", "BS001,BS006"]) == 0
    out = tmp_path / "bs006.json"
    assert lint_main([str(FIXTURES_TORCH), "--select", "BS006",
                      "--json-out", str(out)]) == 1
    doc = json.loads(out.read_text())
    assert doc["rules"] == ["BS006"]
    assert {f["rule"] for f in doc["findings"]} == {"BS006"}
    # narrowing must not flag the other rule's escape as unused
    assert not any(f["rule"] == META_RULE for f in doc["findings"])
    assert lint_main(["--list-rules"]) == 0
    assert "BS006  kernels/*/kernel.py imports only torch" in \
        capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        lint_main(["--select", "BS999"])
    assert exc.value.code == 2


def test_json_report_roundtrips():
    result = run_lint([str(FIXTURES_TORCH / "repro_torch" / "kernels")])
    doc = json.loads(json.dumps(render_json(result)))
    assert [f["rule"] for f in doc["findings"]] == ["BS006"] * 6


def test_import_loads_no_jax_and_no_repro():
    proc = _run(["-c",
                 "import sys, repro_torch.analysis as a\n"
                 "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
                 "('jax', 'jaxlib', 'repro'))\n"
                 "print(bad, sorted(a.RULES))\n"
                 "sys.exit(1 if bad or len(a.RULES) != 9 else 0)\n"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
