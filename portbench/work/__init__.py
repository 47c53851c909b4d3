"""Work counts, one file per kernel: ``LEDGER`` (the program's counter of
the kernel's calls), ``PEAK`` (the key of ``peaks.json`` its operations
run at), ``calls(spec, fed)`` (the shape of every call the window's work
makes: prefills, decode steps or training steps, as the benchmark fed
them) and ``work(call)`` (its operations and bytes: each input byte read
once and each output byte written once).  Counted from shapes, so they
read the same work whatever implements the kernel."""
from __future__ import annotations

import importlib


def module(kernel: str):
    return importlib.import_module(f"{__name__}.{kernel}")


def causal_pairs(T: int) -> int:
    """(query, key) pairs a causal pass over T tokens computes."""
    return T * (T + 1) // 2
