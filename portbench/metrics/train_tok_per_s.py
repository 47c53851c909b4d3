"""Trained positions of the window's steps over its seconds."""


def read(run):
    out = run["out"]
    return out["tokens"] / out["window_s"] if out["window_s"] > 0 else None
