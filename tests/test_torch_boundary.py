"""The port's boundary: it loads neither ``jax`` nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.cluster import BigsetCluster
from repro_torch.configs import smoke_config
from repro_torch.core.bigset import BigsetVnode
from repro_torch.core.clock import Clock
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import serve_bigset
from repro_torch.models import build_model
from repro_torch.query import QueryExecutor
from repro_torch.query.batch import BatchVisibility
from repro_torch.serve import ServeEngine

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
        "import torch.distributed as dist\n"
        "group = dist.is_available() and dist.is_initialized()\n"
        "print(len(sys.modules), bad, group)\n"
        "sys.exit(1 if bad or group else 0)\n")
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
    for mod in ("configs", "configs.gemma3_27b", "models.attention",
                "models.transformer", "models.model", "serve.engine",
                "launch.serve", "kernels.flash_attention.ops",
                "kernels.decode_attention.ops", "configs.falcon_mamba_7b",
                "models.mamba", "kernels.mamba_scan.ops",
                "kernels.mamba_scan.kernel", "kernels.mamba_scan.ref",
                "configs.jamba_1_5_large_398b", "models.mlp",
                "kernels.clock_ops", "kernels.clock_ops.ops",
                "kernels.clock_ops.kernel", "kernels.clock_ops.ref",
                "tree", "train.data", "train.optimizer", "train.delta_sync",
                "checkpoint.bigstore", "checkpoint.manager",
                "cluster.membership", "runtime.elastic", "runtime.ft",
                "launch.train", "configs.shapes", "models.sharding",
                "launch.mesh", "launch.dryrun", "launch.hillclimb"):
        assert f"repro_torch.{mod}" in mods
    for name in ("flash_attention", "decode_attention", "mamba_scan",
                 "clock_ops"):
        assert (PORT / "kernels" / name / "csrc" / f"{name}.cu").is_file()
    for name in ("flash_attention_bwd.cu", "hopper_tc.cuh"):
        assert (PORT / "kernels" / "flash_attention" / "csrc"
                / name).is_file()
    assert (PORT / "kernels" / "mamba_scan" / "csrc"
            / "mamba_scan_bwd.cu").is_file()


def test_clock_ops_import_loads_no_jax_and_builds_nothing(tmp_path):
    # no nvcc on PATH or under CUDA_HOME, and an empty build directory: the
    # import must not look for either, and the CPU route must not build
    build = tmp_path / "build"
    code = (
        "import sys, torch\n"
        "import repro_torch.kernels.clock_ops as co\n"
        "from repro_torch.core.vclock import zero\n"
        "c = zero(3, 2, device='cpu')\n"
        "co.join(c, c); co.popcount(c)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "built = co.kernel.library.cache_info().currsize\n"
        "print(bad, built)\n"
        "sys.exit(1 if bad or built else 0)\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "CUDA_HOME": str(tmp_path / "no-cuda"),
             "REPRO_TORCH_BUILD_DIR": str(build)},
        timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert not build.exists()


def test_port_configs_carry_the_ported_shapes():
    import repro_torch.configs as cfgs
    from repro_torch.configs import shapes
    assert cfgs.input_specs is shapes.input_specs
    assert set(cfgs.SHAPES) == {"train_4k", "prefill_32k", "decode_32k",
                                "long_500k"}
    assert len(cfgs.ARCHS) == 10


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
    cfg = smoke_config("gemma3-27b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params={})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_launcher.main(["--arch", "gemma3-27b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(smoke_config("falcon-mamba-7b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_launcher.main(["--arch", "falcon-mamba-7b"])


def test_cpu_is_taken_only_when_asked(no_cuda):
    cluster = BigsetCluster(device="cpu")
    assert cluster.device == torch.device("cpu")
    assert all(ex.device == torch.device("cpu")
               for ex in cluster._executors(cluster.actors))
    cfg = smoke_config("gemma3-27b")
    model = build_model(cfg, "cpu")
    assert model.device == torch.device("cpu")
    params = model.init(0)
    assert params["embed"]["tok"].device == torch.device("cpu")
    eng = ServeEngine(cfg, params, max_len=32, device="cpu")
    assert eng.cache_len.device == torch.device("cpu")
