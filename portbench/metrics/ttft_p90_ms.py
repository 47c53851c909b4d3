"""The 90th percentile, over every request of the window that got its
first token, of the time from submission to the end of the engine step
that delivered it."""
import statistics


def read(run):
    xs = run["out"]["ttft_ms"]
    if len(xs) < 10:
        return None
    return statistics.quantiles(xs, n=10, method="inclusive")[8]
