"""The benchmark loads neither JAX nor the JAX package, and the plain
references load nothing of the program: checked in a fresh process, by
the top-level name of every module loaded (the part before the first dot,
compared whole: the program's name begins with the JAX package's)."""
import json
import subprocess
import sys

from conftest import ROOT

PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import importlib
for m in {mods!r}:
    importlib.import_module(m)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _tops(mods):
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"), mods=mods)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax_and_no_jax_package():
    tops = _tops(["portbench.run", "portbench.serve", "portbench.train",
                  "portbench.calibrate", "portbench.window",
                  "repro_torch.serve.engine", "repro_torch.models.model"])
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_program():
    tops = _tops(["portbench.reference", "portbench.reference.decoder",
                  "portbench.reference.mamba1", "portbench.weights",
                  "portbench.traffic", "portbench.spec"])
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_a_run_without_the_program_fails_and_prints_nothing(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder a run exits with an error and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "pixtral-12b.docs_serve", "--seed", "2147483999",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
