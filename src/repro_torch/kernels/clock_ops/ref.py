"""Plain PyTorch versions of the interval clock-lattice kernels.

Each merge is the boundary-sweep run merge of
:func:`repro_torch.core.vclock._interval_merge` over ``(lo, hi)`` run
arrays — union (join), difference (tombstone shrink, §4.3.3) and
intersection (tombstone ∩ raw trim) — and popcount is
:func:`repro_torch.core.vclock.popcount`.  Merge outputs are the *unsorted*
``int32[A, Ra+Rb]`` run arrays; after
:func:`~repro_torch.core.vclock.sort_runs` they are canonical (sorted
maximal runs, empty ``(1, 0)`` slots last), which is what the CUDA merge
writes directly.  The wrapper runs these for tensors on the CPU, and the
CUDA kernels are held against them (merges after the sort) on the card.

Candidates are computed in int64, where the JAX reference computes them in
int32 and wraps at ``INT32_MIN`` (ROADMAP C8); for counters in
``[0, 2**31 - 1]`` the two agree bit for bit.
"""
from __future__ import annotations

import torch

from ...core.vclock import DenseClock, _interval_merge, popcount


def join_ref(a_s: torch.Tensor, a_e: torch.Tensor,
             b_s: torch.Tensor, b_e: torch.Tensor):
    """Run union: set-clock ⊔ delta-clock (int32[A, Ra+Rb] pair)."""
    return _interval_merge(a_s, a_e, b_s, b_e, "or")


def subtract_ref(a_s: torch.Tensor, a_e: torch.Tensor,
                 b_s: torch.Tensor, b_e: torch.Tensor):
    """Tombstone shrink (§4.3.3): a minus b, origin-free run difference."""
    return _interval_merge(a_s, a_e, b_s, b_e, "andnot")


def intersect_ref(a_s: torch.Tensor, a_e: torch.Tensor,
                  b_s: torch.Tensor, b_e: torch.Tensor):
    """Run intersection: events seen by both clocks."""
    return _interval_merge(a_s, a_e, b_s, b_e, "and")


def popcount_ref(starts: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Events per actor — Σ max(hi - lo + 1, 0) in int32 that wraps (int32[A])."""
    return popcount(DenseClock(starts, ends))
