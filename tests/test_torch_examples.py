"""The port's examples (``examples_torch/``) against the JAX package's.

Each example runs in a subprocess, as a user runs it, the port's with
``--device cpu`` (the plain versions of its kernels).  All of them start
together, so the file waits for its slowest pair only.  The two bigset
demos print byte-identical stdout to the reference's; ``serve_batched``
prints the same continuous-batching schedule and ``train_ft`` every line
but its losses (the port's ``init`` and ``jax.random`` draw other
weights).  Also here: the port's quickstart under ``python -O`` (CI's
assert-stripped smoke), the port's Chrome-trace export round trip, the
import boundary of ``examples_torch/`` and ``docs_torch/``, and each
example's refusal to run without a card when none is asked off.
"""
import ast
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
EXAMPLES, PORT_EXAMPLES = REPO / "examples", REPO / "examples_torch"
NAMES = ("quickstart", "bigset_cluster", "serve_batched", "train_ft")
ARGS = {"train_ft": ["--steps", "12"]}
PROMISED = {
    "quickstart": ("semantically equivalent to Riak ORSWOT sets",
                   "anti-entropy convergence"),
    "bigset_cluster": ("converged; concurrent re-add beat the remove",
                       "served scan agrees with every replica"),
    "serve_batched": ("all requests served",),
    "train_ft": ("loss improved across crash/restore/elastic events",),
}
TIMEOUT = 300


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def _start(argv):
    return subprocess.Popen([sys.executable, *argv], cwd=REPO, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run's stdout, by (side, name); all started at once."""
    trace = tmp_path_factory.mktemp("trace") / "trace.json"
    argv = {}
    for name in NAMES:
        extra = ARGS.get(name, [])
        argv["ref", name] = [str(EXAMPLES / f"{name}.py"), *extra]
        argv["port", name] = [str(PORT_EXAMPLES / f"{name}.py"), *extra,
                              "--device", "cpu"]
    argv["port-O", "quickstart"] = ["-O", str(PORT_EXAMPLES / "quickstart.py"),
                                    "--device", "cpu"]
    argv["port-O", "trace"] = [
        "-O", "-m", "repro_torch.launch.serve_bigset", "--device", "cpu",
        "--elements", "1000", "--page-size", "250", "--trace-out", str(trace)]
    procs = {key: _start(a) for key, a in argv.items()}
    out = {}
    try:
        for key, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=TIMEOUT)
            assert proc.returncode == 0, (key, stderr[-3000:])
            out[key] = stdout
    finally:
        for proc in procs.values():
            proc.kill()
    out["trace"] = json.loads(trace.read_text())
    return out


def _schedule(text):
    return [ln for ln in text.splitlines() if ln.startswith("  iter ")]


LOSS = re.compile(r"\d+\.\d{3}")


@pytest.mark.parametrize("name", ["quickstart", "bigset_cluster"])
def test_bigset_examples_print_the_reference_stdout(runs, name):
    assert runs["port", name] == runs["ref", name]
    for line in PROMISED[name]:
        assert line in runs["port", name]


def test_serve_batched_keeps_the_reference_schedule(runs):
    got, want = runs["port", "serve_batched"], runs["ref", "serve_batched"]
    assert len(_schedule(want)) > 1
    assert _schedule(got) == _schedule(want)
    assert got.splitlines()[0] == want.splitlines()[0]
    assert got.splitlines()[-1] == want.splitlines()[-1] \
        == "all requests served ✓"
    # the same requests (prompt lengths), seven streams of eight tokens
    reqs = [[ln.split(" -> ")[0] for ln in t.splitlines()
             if ln.startswith("req ")] for t in (got, want)]
    assert reqs[0] == reqs[1] and len(reqs[0]) == 7
    for ln in got.splitlines():
        if ln.startswith("req "):
            assert len(json.loads(ln.split(" -> ")[1])) == 8


def test_train_ft_prints_every_reference_line_but_its_losses(runs):
    got, want = runs["port", "train_ft"], runs["ref", "train_ft"]
    masked = [[LOSS.sub("L", ln) for ln in t.splitlines()]
              for t in (got, want)]
    assert masked[0] == masked[1]
    assert len(masked[0]) == 10
    assert got.splitlines()[-1] == PROMISED["train_ft"][0] + " ✓"
    # the losses are the port's own, and they fall
    final = next(ln for ln in got.splitlines() if ln.startswith("final: "))
    end, start = (float(x) for x in LOSS.findall(final))
    assert end < start


def test_quickstart_under_python_O_prints_its_promised_lines(runs):
    out = runs["port-O", "quickstart"]
    for line in PROMISED["quickstart"]:
        assert line in out
    assert out == runs["port", "quickstart"]


def test_trace_export_round_trips_into_span_trees(runs):
    """CI's Chrome-trace round trip, for the port's serve launcher."""
    assert "serve_bigset demo ok" in runs["port-O", "trace"]
    events = runs["trace"]["traceEvents"]
    assert events, "trace export is empty"
    ids = {e["args"]["span_id"] for e in events}
    roots = 0
    for e in events:
        assert e["ph"] == "X", e
        parent = e["args"]["parent_id"]
        assert parent is None or parent in ids, e
        roots += parent is None
    assert roots >= 1, "no complete span tree in export"


def _imports(source):
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield "." * node.level + (node.module or "")


def _fences(path):
    return re.findall(r"```python\n(.*?)```", path.read_text(), re.S)


def test_port_drivers_import_no_jax_and_nothing_of_repro():
    files = sorted(PORT_EXAMPLES.glob("*.py")) + \
        sorted((REPO / "docs_torch").glob("*.py"))
    assert {p.stem for p in files} >= set(NAMES) | {"run_cookbook"}
    names = {p: list(_imports(p.read_text())) for p in files}
    for page in sorted((REPO / "docs_torch").glob("*.md")):
        names[page] = [n for block in _fences(page) for n in _imports(block)]
    for path, mods in names.items():
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
    assert any(m.startswith("repro_torch") for m in names[
        PORT_EXAMPLES / "quickstart.py"])


@pytest.mark.parametrize("name", NAMES)
def test_main_without_a_card_raises(name, monkeypatch):
    """The examples default to ``cuda``: with no card they raise, never
    carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", PORT_EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])
