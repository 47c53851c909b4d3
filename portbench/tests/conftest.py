"""Small configurations for the benchmark's tests on the CPU: the
harness drives the program's CPU path (its kernels' plain versions) at a
tiny width."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench.spec import Cell, ModelSpec  # noqa: E402

TRAFFIC = ROOT / "portbench" / "traffic"


def tiny_spec(kind: str, dtype: str = "bfloat16") -> ModelSpec:
    if kind == "decoder":
        port = dict(name="tiny-decoder", family="dense", n_layers=2,
                    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                    d_ff=128, vocab_size=256, rope_theta=1e6,
                    tie_embeddings=False, dtype=dtype, norm_eps=1e-6,
                    remat=True, optimizer_moments="fp32")
        return ModelSpec("tiny-decoder", "decoder", 2, 64, 256, n_heads=4,
                         n_kv_heads=2, head_dim=16, d_ff=128,
                         rope_theta=1e6, dtype=dtype, port=port)
    port = dict(name="tiny-mamba", family="ssm", n_layers=2, d_model=64,
                n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0, vocab_size=256,
                ssm_state=4, ssm_conv=4, ssm_expand=2, pos_embedding="none",
                tie_embeddings=False, dtype=dtype, norm_eps=1e-6, remat=True,
                optimizer_moments="fp32")
    return ModelSpec("tiny-mamba", "mamba1", 2, 64, 256, ssm_state=4,
                     ssm_conv=4, d_inner=128, dt_rank=4, dtype=dtype,
                     port=port)


def tiny_cell(kind: str, mode: str, limits=None, dtype="bfloat16") -> Cell:
    spec = tiny_spec(kind, dtype)
    if mode == "train":
        t = json.loads((TRAFFIC / "train_4k.json").read_text())
        t.update(rows=2, seq=33)
        names = ["loss_gap", "first_grad_gap", "change_gap"]
    else:
        t = json.loads((TRAFFIC / "docs_serve.json").read_text())
        t.update(clients=3, max_batch=3, max_len=96, new_tokens=4,
                 check_requests=2,
                 prompt_len={"dist": "log_uniform", "lo": 8, "hi": 64,
                             "stratified_per": 3})
        names = ["widest_gap"]
    limits = limits or {n: 0.05 for n in names}
    return Cell(f"tiny-{kind}.{mode}", spec, t,
                {"kernels": [], "compare": {n: {"limit": limits[n]}
                                            for n in names}}, {"chips": 1})


@pytest.fixture
def cpu():
    import torch
    return torch.device("cpu")
