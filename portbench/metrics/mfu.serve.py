"""Model operations of the window's prefill and decode tokens, over the
window's seconds, as a % of the bf16 dense peak."""
from portbench.metrics import serve_flops


def read(run):
    out = run["out"]
    if out["window_s"] <= 0:
        return None
    return 100.0 * serve_flops(run["spec"], run["fed"]) / out["window_s"] \
        / run["peaks"]["bf16_dense_flops"]
