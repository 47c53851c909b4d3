"""The copy guard: every module the port keeps as a copy of the JAX
package's must equal its reference once the header docstring and the
``# bigset-lint:`` comments are stripped from both.

The port copies a module it needs unchanged (it never imports ``repro``),
and adds only a header docstring naming the module it mirrors, plus the
lint suppressions its own paths need (the lint scopes layers by a
``repro`` path part).  This test stands in for porting the reference's
case-by-case tests of the copied layers (``test_bigset.py``,
``test_clock.py``, ``test_orswot.py``, ``test_storage.py``,
``test_streaming.py``, ``test_obs.py``, ``test_props_extra.py``): the code
they test is the same code.  The modules whose code differs keep parity
tests of their own, which run both packages on the same inputs
(``test_torch_query_cases.py``, ``test_torch_serve_bigset.py``,
``test_torch_placement.py`` and the others).
"""
import ast
import re
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"

COPIES = (
    "checkpoint/__init__.py",
    "cluster/__init__.py",
    "cluster/antientropy.py",
    "cluster/membership.py",
    "cluster/placement.py",
    "cluster/sim.py",
    "configs/__init__.py",
    "configs/base.py",
    "configs/falcon_mamba_7b.py",
    "configs/gemma3_27b.py",
    "configs/gemma_7b.py",
    "configs/granite_moe_1b_a400m.py",
    "configs/grok_1_314b.py",
    "configs/jamba_1_5_large_398b.py",
    "configs/minitron_4b.py",
    "configs/mistral_large_123b.py",
    "configs/pixtral_12b.py",
    "configs/registry.py",
    "configs/whisper_tiny.py",
    "core/__init__.py",
    "core/bigset.py",
    "core/clock.py",
    "core/delta_orswot.py",
    "core/dots.py",
    "core/orswot.py",
    "core/streaming.py",
    "index/__init__.py",
    "index/postings.py",
    "index/spec.py",
    "obs/__init__.py",
    "obs/export.py",
    "obs/metrics.py",
    "obs/trace.py",
    "query/__init__.py",
    "query/cursor.py",
    "query/plan.py",
    "query/planner.py",
    "runtime/__init__.py",
    "runtime/elastic.py",
    "serve/__init__.py",
    "serve/bigset_service.py",
    "storage/__init__.py",
    "storage/keycodec.py",
    "storage/lsm.py",
    "storage/wal.py",
    "train/__init__.py",
    "train/data.py",
)

_LINT = re.compile(r"\s*# bigset-lint:.*$")


def code_of(path: Path):
    """The module's lines after its header docstring, with every
    ``# bigset-lint:`` comment cut from the end of its line."""
    text = path.read_text()
    tree = ast.parse(text)
    start = 0
    if (tree.body and isinstance(tree.body[0], ast.Expr)
            and isinstance(tree.body[0].value, ast.Constant)
            and isinstance(tree.body[0].value.value, str)):
        start = tree.body[0].end_lineno
    return [_LINT.sub("", line) for line in text.splitlines()[start:]]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_reference(rel):
    got, want = code_of(PORT / rel), code_of(REF / rel)
    first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 min(len(got), len(want)))
    assert got == want, (
        f"{rel} drifted from its reference after the header docstring: "
        f"first difference at code line {first + 1}")


def test_every_unchanged_module_is_guarded():
    """A port module whose code equals its reference's is a copy, and must
    be listed above (so that a later edit to it is caught)."""
    unlisted = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT).as_posix()
        ref = REF / rel
        if (rel not in COPIES and ref.is_file()
                and code_of(path) == code_of(ref)):
            unlisted.append(rel)
    assert unlisted == []
    assert all((PORT / rel).is_file() and (REF / rel).is_file()
               for rel in COPIES)
