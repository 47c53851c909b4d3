"""One reader per metric, ``metrics/<name>.py``, with ``read(run)``: the
metric's value from the run's figures (``run["out"]``), the fed work
(``run["fed"]``) and, in a traced run, the reduced trace
(``run["trace"]``), or None where it finds nothing to read.  The helpers
below are shared by the readers."""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Optional

from .. import work
from ..work import causal_pairs

HERE = Path(__file__).resolve().parent


def reader(name: str):
    path = HERE / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{__name__}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def roofline(run, kernel: str) -> Optional[float]:
    """The least time the calls of ``kernel`` in the traced window could
    take on the chip (each call's operations at the peak its work runs at,
    or its bytes at the memory's peak, whichever is longer), as a % of
    the device time its class took in the trace."""
    trace = run.get("trace")
    if not trace:
        return None
    dev_s = trace["by_class"].get(kernel, 0.0)
    mod = work.module(kernel)
    calls = mod.calls(run["spec"], run["fed"])
    if dev_s <= 0 or not calls:
        return None
    pk = run["peaks"]
    bound = 0.0
    for c in calls:
        flops, nbytes = mod.work(c)
        bound += max(flops / pk[mod.PEAK], nbytes / pk["hbm_bytes_per_s"])
    return 100.0 * bound / dev_s


def serve_flops(spec, fed) -> float:
    """Model operations of the window's prefill and decode tokens: two a
    weight that a token's products reach in each layer, the head's once
    per delivered token, and attention's 4 x head dim a visible key and
    query head."""
    per_layer = 2 * spec.layer_params() * spec.n_layers
    head = 2 * spec.head_params()
    attn = 4 * spec.attn_layers * spec.n_heads * spec.head_dim
    flops = 0.0
    for T in fed["prefill_lens"]:
        flops += per_layer * T + head + attn * causal_pairs(T)
    flops += (per_layer + head) * fed["decode_tokens"]
    flops += attn * sum(fed["decode_ctx"])
    return flops


def train_flops(spec, fed) -> float:
    """6 x parameters a token reaches x tokens + 12 x layers x heads x
    head dim x visible causal pairs, over the window's steps."""
    n = spec.layer_params() * spec.n_layers + spec.head_params()
    T = fed["seq"] - 1
    tokens = fed["steps"] * fed["rows"] * T
    pairs = fed["steps"] * fed["rows"] * causal_pairs(T)
    return 6 * n * tokens + 12 * spec.attn_layers * spec.n_heads \
        * spec.head_dim * pairs
