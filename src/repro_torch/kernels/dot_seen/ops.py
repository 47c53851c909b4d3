"""Public wrapper for the dot-seen kernel, dispatching on the device.

A CPU tensor runs the plain version (:mod:`.ref`); a CUDA tensor launches
the CUDA kernel (:mod:`.kernel`) and raises if the build or the launch
fails — there is no fallback.  The bigset read fold calls this with the
set-tombstone in dense *interval* form (``DenseClock.starts`` / ``.ends``).

Every call is tallied in the process-wide :data:`DISPATCHES` ledger
(launch count + rows dispatched, padding included), counted as the JAX
package counts them; ``kernel_launches`` counts the calls that launched the
CUDA kernel.  The metrics registry lifts it via
:func:`repro_torch.obs.metrics.lift_dispatch_stats`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ...core.vclock import DenseClock
from .kernel import dot_seen_cuda
from .ref import dot_seen_ref


@dataclass
class DispatchStats:
    """Kernel-launch ledger: device calls and rows (dots) they covered."""

    launches: int = 0         # dot_seen invocations (one device dispatch each)
    rows: int = 0             # total rows dispatched, padding included
    kernel_launches: int = 0  # subset of launches that ran the CUDA kernel

    def snapshot(self) -> "DispatchStats":
        return DispatchStats(**vars(self))

    def delta(self, since: "DispatchStats") -> "DispatchStats":
        return DispatchStats(
            **{k: getattr(self, k) - getattr(since, k) for k in vars(self)})

    def reset(self) -> None:
        for k in vars(self):
            setattr(self, k, 0)


DISPATCHES = DispatchStats()


def _check(clock: DenseClock, actors: torch.Tensor,
           counters: torch.Tensor) -> None:
    tensors = {"starts": clock.starts, "ends": clock.ends,
               "actors": actors, "counters": counters}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"dot_seen: {name} must be a torch.Tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"dot_seen: {name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"dot_seen: {name} must be contiguous")
        if t.device != actors.device:
            raise ValueError(
                f"dot_seen: {name} is on {t.device}, actors on {actors.device}")
    if clock.starts.dim() != 2 or clock.starts.shape != clock.ends.shape:
        raise ValueError("dot_seen: starts/ends must share one [A, R] shape")
    if actors.dim() != 1 or actors.shape != counters.shape:
        raise ValueError("dot_seen: actors/counters must share one [N] shape")
    if max(clock.starts.numel(), actors.numel()) >= 2**31:
        raise ValueError("dot_seen: sizes must fit int32 indexing")


def dot_seen(clock: DenseClock, actors: torch.Tensor,
             counters: torch.Tensor) -> torch.Tensor:
    """bool[N] — which dots has ``clock`` seen?"""
    _check(clock, actors, counters)
    DISPATCHES.launches += 1
    DISPATCHES.rows += int(actors.shape[0])
    if actors.device.type == "cpu":
        return dot_seen_ref(clock.starts, clock.ends, actors, counters)
    if actors.device.type != "cuda":
        raise ValueError(f"dot_seen: no kernel for device {actors.device}")
    out = dot_seen_cuda(clock.starts, clock.ends, actors, counters)
    DISPATCHES.kernel_launches += 1
    return out
