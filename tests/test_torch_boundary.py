"""The port's boundary: it loads neither ``jax`` nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.cluster import BigsetCluster
from repro_torch.core.bigset import BigsetVnode
from repro_torch.core.clock import Clock
from repro_torch.launch import serve_bigset
from repro_torch.query import QueryExecutor
from repro_torch.query.batch import BatchVisibility

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _port_modules():
    return sorted(
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


def test_import_loads_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_absolute_repro_or_jax_import_in_the_port():
    offenders = []
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("repro", "jax", "jaxlib"):
                    offenders.append(f"{path.relative_to(REPO)}: {name}")
    assert offenders == []


def test_port_modules_found():
    mods = _port_modules()
    assert "repro_torch.kernels.dot_seen.ops" in mods
    assert "repro_torch.launch.serve_bigset" in mods
    assert (PORT / "kernels" / "dot_seen" / "csrc" / "dot_seen.cu").is_file()


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BigsetCluster()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QueryExecutor(BigsetVnode("n0"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchVisibility(Clock(base={"a": 3}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_bigset.main(["--elements", "10"])


def test_cpu_is_taken_only_when_asked(no_cuda):
    cluster = BigsetCluster(device="cpu")
    assert cluster.device == torch.device("cpu")
    assert all(ex.device == torch.device("cpu")
               for ex in cluster._executors(cluster.actors))
