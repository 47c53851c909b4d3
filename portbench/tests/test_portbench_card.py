"""One run of a cell on the card, end to end, as the benchmark's command
makes it (skips where there is no card)."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.gpu
def test_a_cell_runs_on_the_card_and_is_correct():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the port's kernels run only on one")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    workload = bench["workloads"][0]["name"]
    # 12 s: past the first serving wave (about 6 s on an H100), so the
    # check has finished requests to compare
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        workload, "--seed", "2147484001", "--seconds", "12",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu"
    assert line["correct"], r.stderr[-4000:]
    assert "setup_s" in line["metrics"]
