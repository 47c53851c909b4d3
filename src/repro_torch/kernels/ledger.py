"""The launch ledger every kernel wrapper of the port keeps.

Each wrapper owns one process-wide :class:`DispatchStats` (its
``DISPATCHES``): ``launches`` counts its calls, ``rows`` the rows they
covered, and ``kernel_launches`` the calls that launched the CUDA kernel
(the rest ran the plain version on the CPU).  A run that zeroes the ledger
before the main path and reads it after shows that the path went through
the kernel.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class DispatchStats:
    """Kernel-launch ledger: device calls and rows they covered."""

    launches: int = 0         # wrapper invocations (one device dispatch each)
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


@dataclass
class WorkTally:
    """The work the wrappers were handed on ``meta`` tensors (the dry run,
    :mod:`repro_torch.launch.dryrun`): a meta tensor launches nothing and
    no FLOP counter sees a ctypes launch, so each wrapper adds its
    kernel's FLOPs and bytes here (its ``*_work`` function, the same one
    ``chip_smoke.py`` bounds the kernel with)."""

    calls: int = 0
    flops: int = 0
    bytes: int = 0

    def add(self, flops: int, nbytes: int) -> None:
        self.calls += 1
        self.flops += int(flops)
        self.bytes += int(nbytes)

    def reset(self) -> None:
        for k in vars(self):
            setattr(self, k, 0)


# one tally for every wrapper: the dry run resets it before a step
DRYRUN = WorkTally()
