"""The share of the traced window in which no operation ran on the
device (the union of the device's intervals against the window)."""


def read(run):
    trace = run.get("trace")
    if not trace or run["out"]["window_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - trace["busy_s"] / run["out"]["window_s"])
