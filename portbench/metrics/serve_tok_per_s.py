"""Prompt and generated tokens the window delivered, over its seconds:
each prompt counted when its prefill delivers the first token."""


def read(run):
    out = run["out"]
    return out["tokens"] / out["window_s"] if out["window_s"] > 0 else None
