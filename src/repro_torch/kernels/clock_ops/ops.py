"""Public interval clock-lattice ops, dispatching on the device.

Join / subtract / intersect are boundary-sweep run merges over the dense
``(lo, hi)`` run arrays of :class:`repro_torch.core.vclock.DenseClock`.  A
CPU tensor runs the plain version (:mod:`.ref`); a CUDA tensor launches the
CUDA kernel (:mod:`.kernel`) and raises if the build or the launch fails —
there is no fallback, and no switch: the JAX package's ``use_pallas`` and
``interpret`` have no counterpart.  Both routes return canonical rows
(sorted maximal runs, empty ``(1, 0)`` slots last), which are a function
of the two sets alone: the kernel writes them as they are; the plain
version's unsorted slots become them after
:func:`~repro_torch.core.vclock.sort_runs`.  The two agree bit for bit.
Subtract is origin-free: there is no precondition beyond a shared actor
universe.

:data:`DISPATCHES` keeps two ledgers, ``DISPATCHES.merge`` (the three
merges) and ``DISPATCHES.popcount``: each call adds one launch and its A
rows; ``kernel_launches`` counts the calls that launched a CUDA kernel.
The port's ``core.vclock`` ops stay plain PyTorch and dispatch to nothing.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...core.vclock import DenseClock, sort_runs
from ..ledger import DispatchStats
from .kernel import clock_merge_cuda, clock_popcount_cuda
from .ref import intersect_ref, join_ref, popcount_ref, subtract_ref


class ClockOpsDispatches(NamedTuple):
    merge: DispatchStats     # join, subtract, intersect
    popcount: DispatchStats


DISPATCHES = ClockOpsDispatches(DispatchStats(), DispatchStats())


def _check(op: str, *clocks: DenseClock) -> torch.device:
    """Both run arrays of each clock: int32, contiguous, one ``[A, R]``
    shape, on one device, which is returned."""
    named = [(name, t) for c in clocks
             for name, t in (("starts", c.starts), ("ends", c.ends))]
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{op}: {name} must be a torch.Tensor")
    device = clocks[0].starts.device
    for c in clocks:
        for name, t in (("starts", c.starts), ("ends", c.ends)):
            if t.dtype != torch.int32:
                raise TypeError(f"{op}: {name} must be int32, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{op}: {name} must be contiguous")
            if t.device != device:
                raise ValueError(f"{op}: {name} is on {t.device}, not {device}")
            if t.numel() >= 2**31:
                raise ValueError(f"{op}: sizes must fit int32 indexing")
        if c.starts.dim() != 2 or c.starts.shape != c.ends.shape:
            raise ValueError(f"{op}: starts/ends must share one [A, R] shape")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: no kernel for device {device}")
    return device


def _merged(mode: str, op: str, ref_fn, a: DenseClock,
            b: DenseClock) -> DenseClock:
    device = _check(op, a, b)
    if a.starts.shape[0] != b.starts.shape[0]:
        raise ValueError("dense clocks must share the actor universe")
    DISPATCHES.merge.launches += 1
    DISPATCHES.merge.rows += int(a.starts.shape[0])
    if device.type == "cpu":
        return DenseClock(*sort_runs(*ref_fn(a.starts, a.ends,
                                             b.starts, b.ends)))
    out = DenseClock(*clock_merge_cuda(mode, a.starts, a.ends,
                                       b.starts, b.ends))
    DISPATCHES.merge.kernel_launches += 1
    return out


def join(a: DenseClock, b: DenseClock) -> DenseClock:
    """⊔ of two dense clocks (run union)."""
    return _merged("or", "join", join_ref, a, b)


def subtract(a: DenseClock, b: DenseClock) -> DenseClock:
    """Remove b's events from a (tombstone shrink, §4.3.3), origin-free."""
    return _merged("andnot", "subtract", subtract_ref, a, b)


def intersect(a: DenseClock, b: DenseClock) -> DenseClock:
    """Events seen by both clocks (run intersection)."""
    return _merged("and", "intersect", intersect_ref, a, b)


def popcount(a: DenseClock) -> torch.Tensor:
    """Events per actor, ``int32[A]``, with int32 wrap."""
    device = _check("popcount", a)
    DISPATCHES.popcount.launches += 1
    DISPATCHES.popcount.rows += int(a.starts.shape[0])
    if device.type == "cpu":
        return popcount_ref(a.starts, a.ends)
    out = clock_popcount_cuda(a.starts, a.ends)
    DISPATCHES.popcount.kernel_launches += 1
    return out
