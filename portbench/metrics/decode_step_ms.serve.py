"""The mean wall ms of the window's ``Model.decode_step`` calls, each
synchronised before and after by the benchmark (traced run)."""


def read(run):
    xs = run["out"]["decode_ms"]
    return sum(xs) / len(xs) if xs else None
