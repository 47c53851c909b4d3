"""Model operations of the window's training steps (6 x parameters a
token reaches x tokens + 12 x layers x heads x head dim x causal pairs),
over the window's seconds, as a % of the bf16 dense peak."""
from portbench.metrics import train_flops


def read(run):
    out = run["out"]
    if out["window_s"] <= 0:
        return None
    return 100.0 * train_flops(run["spec"], run["fed"]) / out["window_s"] \
        / run["peaks"]["bf16_dense_flops"]
