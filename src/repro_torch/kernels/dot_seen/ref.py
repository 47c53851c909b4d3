"""Plain PyTorch version of the dot-seen kernel.

Semantics are exactly :func:`repro_torch.core.vclock.dots_seen`: for each
dot ``(actor, counter)``, whether the dense interval clock (per-actor
``(lo, hi)`` run arrays) has observed it; an actor outside ``[0, A)`` is
unseen.  This is the per-element-key filter of the bigset read fold.  The
wrapper runs it for tensors on the CPU, and the CUDA kernel is held
against it on the card.
"""
from __future__ import annotations

import torch

from ...core.vclock import DenseClock, dots_seen as _dots_seen


def dot_seen_ref(
    starts: torch.Tensor,    # int32[A, R]
    ends: torch.Tensor,      # int32[A, R]
    actors: torch.Tensor,    # int32[N]
    counters: torch.Tensor,  # int32[N]
) -> torch.Tensor:           # bool[N]
    return _dots_seen(DenseClock(starts, ends), actors, counters)
