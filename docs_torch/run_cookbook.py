#!/usr/bin/env python
"""Doctest-style runner for the PyTorch port's docs: execute every
```python fence in a page.

The cookbook's blocks run top to bottom in ONE shared namespace — later
blocks may use names earlier blocks defined, exactly as a reader pasting
them into a REPL would experience.  The namespace starts with ``DEVICE``,
the ``--device`` the page's clusters are built on: ``cuda`` (the default;
raises without a card) or ``cpu``.  Any failing assert or exception fails
the run (``tests/test_torch_docs.py`` calls this), so the documentation
cannot rot away from the code it documents.

The port's copy of ``docs/run_cookbook.py``, with ``--device``.

Usage:
  python docs_torch/run_cookbook.py [--device cpu] [page.md ...]
      # default page: docs_torch/QUERY_COOKBOOK.md
"""
from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FENCE = re.compile(r"```python\n(.*?)```", re.S)

if str(REPO / "src") not in sys.path:
    sys.path.insert(0, str(REPO / "src"))


def run_file(path, device="cuda") -> int:
    """Execute a page's python blocks on ``device``; returns how many ran."""
    from repro_torch.device import resolve_device

    text = Path(path).read_text()
    blocks = FENCE.findall(text)
    if not blocks:
        raise SystemExit(f"{path}: no ```python blocks found")
    namespace: dict = {"__name__": "__cookbook__",
                       "DEVICE": resolve_device(device)}
    for i, block in enumerate(blocks, 1):
        # compile with a per-block filename so tracebacks point at the page
        code = compile(block, f"{path}#block{i}", "exec")
        exec(code, namespace)
        print(f"  ok: {Path(path).name} block {i} "
              f"({len(block.strip().splitlines())} lines)")
    return len(blocks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the page's clusters run: cuda or cpu")
    ap.add_argument("pages", nargs="*")
    args = ap.parse_args(argv)
    paths = args.pages or [str(REPO / "docs_torch" / "QUERY_COOKBOOK.md")]
    total = sum(run_file(p, args.device) for p in paths)
    print(f"cookbook: {total} blocks executed green")
    return total


if __name__ == "__main__":
    main(sys.argv[1:])
