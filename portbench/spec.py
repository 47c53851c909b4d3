"""What a cell is made of, read from ``BENCHMARK.json`` and the data files
it names: the configuration (``configs/<config>.json``), the traffic mix
(``traffic/<traffic>.json``), the comparison's limits
(``checks/<workload>.json``), the kernel classes (``kernels/*.json``) and
the table of peaks (``peaks.json``).  Nothing here imports the program."""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclass(frozen=True)
class ModelSpec:
    """The sizes of one configuration as the benchmark runs it.  ``kind``
    names the plain reference (``reference/<kind>.py``)."""

    name: str
    kind: str                 # "decoder" (GQA attention + gated FFN) | "mamba1"
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    rope_theta: float = 10_000.0
    ssm_state: int = 0
    ssm_conv: int = 4
    d_inner: int = 0
    dt_rank: int = 0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    port: Dict = field(default_factory=dict, compare=False, hash=False)

    @property
    def attn_layers(self) -> int:
        return self.n_layers if self.kind == "decoder" else 0

    @property
    def mamba_layers(self) -> int:
        return self.n_layers if self.kind == "mamba1" else 0

    def layer_params(self) -> int:
        """Parameters of one layer that a token's products reach."""
        d = self.d_model
        if self.kind == "decoder":
            attn = d * self.head_dim * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * self.head_dim * d
            return attn + 3 * d * self.d_ff
        di, n, r = self.d_inner, self.ssm_state, self.dt_rank
        return d * 2 * di + di * (r + 2 * n) + r * di + di * d

    def head_params(self) -> int:
        return self.d_model * self.vocab


def model_spec(name: str) -> ModelSpec:
    """``configs/<name>.json`` as a :class:`ModelSpec`."""
    raw = load_json(HERE / "configs" / f"{name}.json")
    kind = raw["reference"]
    common = dict(name=name, kind=kind, n_layers=raw["num_hidden_layers"],
                  d_model=raw["hidden_size"], vocab=raw["vocab_size"],
                  norm_eps=raw["rms_norm_eps"],
                  tie_embeddings=raw["tie_word_embeddings"],
                  dtype=raw["torch_dtype"], port=raw["port"])
    if kind == "decoder":
        return ModelSpec(n_heads=raw["num_attention_heads"],
                         n_kv_heads=raw["num_key_value_heads"],
                         head_dim=raw["head_dim"],
                         d_ff=raw["intermediate_size"],
                         rope_theta=raw["rope_theta"], **common)
    if kind == "mamba1":
        return ModelSpec(ssm_state=raw["state_size"],
                         ssm_conv=raw["conv_kernel"],
                         d_inner=raw["intermediate_size"],
                         dt_rank=raw["time_step_rank"]
                         or math.ceil(raw["hidden_size"] / 16), **common)
    raise ValueError(f"{name}: no reference of kind {kind!r}")


def port_config(spec: ModelSpec):
    """The program's ``ModelConfig`` of ``spec`` (its ``port`` block)."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**spec.port)


@dataclass(frozen=True)
class Cell:
    name: str
    spec: ModelSpec
    traffic: dict
    limits: dict
    entry: dict

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def cell(workload: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(have: {', '.join(sorted(entries))})")
    w = entries[workload]
    return Cell(workload, model_spec(w["config"]),
                load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                load_json(HERE / "checks" / f"{workload}.json"), w)


def metrics_of(workload: str, trace: bool, bench: Optional[dict] = None
               ) -> List[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    bench = bench or benchmark()
    out = []
    for m in bench["per_layer" if trace else "end_to_end"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        out.append(m)
    return out


def kernel_classes() -> List[dict]:
    """``kernels/*.json``: each a class of device kernels by name, tried
    in ``order``; a kernel no class claims is ``other``."""
    out = []
    for path in sorted((HERE / "kernels").glob("*.json")):
        c = load_json(path)
        c["name"] = path.stem
        out.append(c)
    return sorted(out, key=lambda c: (c["order"], c["name"]))


def classify(name: str, classes: List[dict]) -> str:
    low = name.lower()
    for c in classes:
        if any(s in (low if c.get("ignore_case") else name)
               for s in c["match"]):
            return c["name"]
    return "other"


def peaks() -> dict:
    return load_json(HERE / "peaks.json")
