"""Vectorised dot-visibility filtering for element-key streams.

The port of :mod:`repro.query.batch`.  The hot loop of every bigset read
is "has the set-tombstone seen this dot?" — executed once per element-key.
The scalar path does a Python dict probe per dot; this module batches a
whole scan chunk into dense ``(actors, counters)`` ``int32`` arrays and
dispatches the ``kernels/dot_seen`` wrapper on the filter's device (the
CUDA kernel on the card, the plain version on the CPU), so visibility for
thousands of keys resolves in one device call.

The tombstone is converted once per query into the dense
:class:`~repro_torch.core.vclock.DenseClock` *interval* form (per-actor
``(lo, hi)`` run arrays), built on the device; every chunk then reuses it.
The build is O(interval runs) — causal metadata — with no window cap.
Dots by actors the tombstone has never heard of are unseen by definition
and route to the sentinel counter ``0``, which no 1-based run can contain.
Batch shapes are padded to a fixed bucket, as the JAX package pads them,
so both count the same rows.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..core.clock import Clock
from ..core.dots import Dot
from ..core.vclock import from_clock
from ..device import DeviceLike, resolve_device

# Chunks smaller than this aren't worth a device dispatch.
MIN_BATCH = 32
# Pad batches up to a multiple of this so the device sees few distinct shapes.
PAD_BUCKET = 512


class BatchVisibility:
    """Batched ``tombstone.seen(dot)`` over chunks of a scan stream."""

    def __init__(
        self,
        tombstone: Clock,
        *,
        device: DeviceLike = None,
        min_batch: int = MIN_BATCH,
        stats=None,
    ):
        self.tombstone = tombstone
        self.device = resolve_device(device)
        self.min_batch = min_batch
        # per-query launch accounting (QueryStats.kernel_launches/_rows):
        # the cross-query micro-batcher's per-query baseline
        self.stats = stats
        self._dense = None
        self._actor_index: Dict[object, int] = {}
        # counters are 1-based, so 0 is unseen by every run — the routing
        # target for padding and for actors the tombstone never heard of
        self._sentinel = 0

        if tombstone.is_zero():
            self._mode = "empty"
            return
        self._mode = "dense"
        actors = sorted(tombstone.actors(), key=repr)
        self._actor_index = {a: i for i, a in enumerate(actors)}
        self._dense = from_clock(tombstone, self._actor_index, len(actors),
                                 device=self.device)

    # ------------------------------------------------------------------ api
    def seen_mask(self, dots: Sequence[Dot]) -> np.ndarray:
        """bool[N] — which of ``dots`` has the tombstone seen (i.e. are dead)?"""
        n = len(dots)
        if n == 0:
            return np.zeros((0,), bool)
        if self._mode == "empty":
            return np.zeros((n,), bool)
        if n < self.min_batch:
            ts = self.tombstone
            return np.fromiter((ts.seen(d) for d in dots), bool, count=n)
        idx = self._actor_index
        actors = np.empty((n,), np.int32)
        counters = np.empty((n,), np.int32)
        for i, d in enumerate(dots):
            j = idx.get(d.actor, -1)
            if j < 0:
                # unknown actor: route to slot 0 with the sentinel counter,
                # which the kernel reports unseen
                actors[i] = 0
                counters[i] = self._sentinel
            else:
                actors[i] = j
                counters[i] = d.counter
        pad = (-n) % PAD_BUCKET
        if pad:
            actors = np.pad(actors, (0, pad))
            counters = np.pad(
                counters, (0, pad), constant_values=self._sentinel)
        if self.stats is not None:
            self.stats.kernel_launches += 1
            self.stats.kernel_rows += n
        from ..kernels.dot_seen import dot_seen

        mask = dot_seen(
            self._dense,
            torch.from_numpy(actors).to(self.device),
            torch.from_numpy(counters).to(self.device),
        )
        return mask.cpu().numpy()[:n]

    def seen_scalar(self, dots: Sequence[Dot]) -> np.ndarray:
        """Scalar oracle (for tests / tiny batches)."""
        ts = self.tombstone
        return np.fromiter(
            (ts.seen(d) for d in dots), bool, count=len(dots))
