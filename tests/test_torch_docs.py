"""The port's executable docs (``docs_torch/``): its query cookbook runs
green on the CPU, prints what the reference's page prints, and every
relative link on its pages resolves (checked with the reference's own
link checker, ``docs/check_links.py``)."""
import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
DOCS, PORT_DOCS = REPO / "docs", REPO / "docs_torch"
PAGE = "QUERY_COOKBOOK.md"
# the lines the page's blocks print: anti-entropy and the WAL replay
PRINTED = ("converged in ", "replayed ")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _printed(text):
    return [ln for ln in text.splitlines() if ln.startswith(PRINTED)]


@pytest.fixture(scope="module")
def runners():
    return {"port": _load(PORT_DOCS / "run_cookbook.py", "run_cookbook_port"),
            "ref": _load(DOCS / "run_cookbook.py", "run_cookbook_ref")}


def test_port_cookbook_executes_green_on_the_cpu(runners, capsys):
    blocks = runners["port"].run_file(PORT_DOCS / PAGE, "cpu")
    # the reference page's blocks, its lint block on the port's linter:
    # shrinking this page needs a deliberate edit
    assert blocks >= 18
    assert len(_printed(capsys.readouterr().out)) == len(PRINTED)


def test_port_cookbook_prints_the_reference_pages_lines(runners, capsys):
    runners["port"].run_file(PORT_DOCS / PAGE, "cpu")
    port = _printed(capsys.readouterr().out)
    runners["ref"].run_file(DOCS / PAGE)
    assert [ln.split()[0] for ln in port] == ["converged", "replayed"]
    assert port == _printed(capsys.readouterr().out)


def test_port_cookbook_main_takes_a_device(runners, capsys):
    assert runners["port"].main(["--device", "cpu"]) >= 18
    assert "cookbook: 19 blocks executed green" in capsys.readouterr().out


def test_port_docs_links_resolve():
    checker = _load(DOCS / "check_links.py", "check_links")
    files = checker.collect([PORT_DOCS])
    assert [f.name for f in files] == [PAGE]
    text = files[0].read_text()
    assert "../docs/QUERY_COOKBOOK.md#lint-the-invariants-statically" in text
    broken = {str(f): checker.broken_links(f) for f in files}
    assert not {f: b for f, b in broken.items() if b}
