"""The measured window: the program's kernel ledgers read around it, and
in a traced run ``torch.profiler`` over it, reduced to device intervals,
device time by kernel class, the busy share and where the device idled.
"""
from __future__ import annotations

import bisect
import importlib
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

from . import spec as specs
from . import work

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def ledger(kernel: str):
    mod_name, attr = work.module(kernel).LEDGER
    return getattr(importlib.import_module(mod_name), attr)


class Window:
    """``with Window(...)`` around the window: the named kernels' ledger
    deltas land in :attr:`counts`, and with ``on`` a profile of the
    window in :attr:`events`."""

    def __init__(self, on: bool, kernels: List[str]):
        self.on = on
        self.kernels = kernels
        self.counts: Dict[str, Dict[str, int]] = {}
        self.prof = None

    def __enter__(self):
        self._before = {k: ledger(k).snapshot() for k in self.kernels}
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        for k in self.kernels:
            d = ledger(k).delta(self._before[k])
            self.counts[k] = {"calls": d.launches,
                              "kernel_calls": d.kernel_launches}
        return False

    # ------------------------------------------------------------ reading
    def events(self) -> Tuple[List[Tuple[str, int, int]],
                              List[Tuple[str, int, int]]]:
        """(device operations, benchmark spans), each ``(name, start_ns,
        end_ns)`` on the profiler's clock."""
        dev, spans = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            start = e.start_ns()
            end = start + e.duration_ns()
            on_device = e.device_type() == cuda
            if hasattr(e, "activity_type"):
                on_device = on_device and e.activity_type() in DEVICE_ACTIVITIES
            # a span's copy on the device's timeline is not an operation
            if on_device and not e.is_user_annotation():
                dev.append((e.name(), start, end))
            elif not on_device and e.is_user_annotation():
                spans.append((e.name(), start, end))
        names = {n for n, _, _ in spans}
        dev = sorted((d for d in dev if d[0] not in names), key=lambda x: x[1])
        spans.sort(key=lambda x: x[1])
        return dev, spans


def reduce_trace(dev, spans, classes=None, top: int = 10) -> Dict:
    """Busy seconds (the union of the device intervals), device seconds
    by kernel class and by name, and idle seconds by the innermost
    benchmark span open when each idle gap began."""
    classes = classes if classes is not None else specs.kernel_classes()
    by_name: Dict[str, float] = defaultdict(float)
    by_class: Dict[str, float] = defaultdict(float)
    for name, s, e in dev:
        by_name[name] += (e - s) * 1e-9
    for name, sec in by_name.items():
        by_class[specs.classify(name, classes)] += sec
    merged: List[List[int]] = []
    for _, s, e in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) * 1e-9
    starts = [s for _, s, _ in spans]
    idle: Dict[str, float] = defaultdict(float)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        where = "outside the benchmark's spans"
        i = bisect.bisect_right(starts, a) - 1
        for j in range(i, max(-1, i - 64), -1):
            name, s, e = spans[j]
            if s <= a < e:
                where = name
                break
        idle[where] += (b - a) * 1e-9
    return {
        "busy_s": busy,
        "by_class": dict(by_class),
        "device_ops": sorted(([n[:120], v] for n, v in by_name.items()),
                             key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(([n, v] for n, v in idle.items()),
                            key=lambda x: -x[1])[:top],
    }
