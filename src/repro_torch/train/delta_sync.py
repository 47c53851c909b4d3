"""Dot-tracked gradient delta synchronisation (async / straggler-tolerant DP).

The paper's delta-replication idea applied to gradient exchange: each
host's per-step gradient contribution is a *dot* ``(host, step)``.  An
aggregator (or every peer, symmetrically) folds contributions into a sum
keyed by its logical clock:

* duplicate delivery is a no-op (dot already seen — Algorithm 2's test);
* a straggler past the deadline is simply a *missing dot*: the step closes
  with a quorum of contributions and rescales by the count (partial
  all-reduce), and the late delta is discarded on arrival because its step
  has been sealed (its dot is added to the tombstone clock);
* the clocks make the protocol idempotent and order-free, so the transport
  may drop/duplicate/reorder — anti-entropy (re-request by missing dot) is
  exact, not heuristic.

This is the control-plane logic; on a real fleet the payload movement is a
reduce-scatter and this plane only tracks *which* contributions are in.

PyTorch port of :mod:`repro.train.delta_sync`.  The gradient trees are the
port's nests of dicts and lists of tensors.  The sum keeps JAX's dtype
semantics (bf16 sums in bf16; the mean is ``s / max(n, 1)`` in the
gradients' dtype) and is taken **in place**: the first contribution of a
step becomes the running sum, later ones are added into it, and the seal
divides it.  An offered contribution therefore belongs to the aggregator,
and only one gradient tree per step stays in flight.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

import torch

from ..core.clock import Clock
from ..core.dots import Dot
from ..tree import leaves


@dataclass
class GradDelta:
    host: str
    step: int
    n_samples: int
    grads: Any  # nest of dicts and lists of tensors

    @property
    def dot(self) -> Dot:
        return Dot(self.host, self.step + 1)  # dots are 1-based events


class DeltaAggregator:
    """Per-step gradient folding with causal dedup + straggler sealing."""

    def __init__(self, hosts: List[str], quorum: Optional[int] = None):
        self.hosts = list(hosts)
        self.quorum = quorum or len(hosts)
        self.seen = Clock.zero()      # contributions folded
        self.sealed = Clock.zero()    # steps closed per host (tombstone role)
        self.acc: Dict[int, Tuple[Any, int, int]] = {}  # step -> (sum, n, cnt)

    def offer(self, d: GradDelta) -> bool:
        """Fold a contribution.  False => duplicate or late (discarded)."""
        if self.seen.seen(d.dot) or self.sealed.seen(d.dot):
            return False
        self.seen = self.seen.add(d.dot)
        if d.step in self.acc:
            s, n, c = self.acc[d.step]
            with torch.no_grad():
                for a, b in zip(leaves(s), leaves(d.grads)):
                    a.add_(b)
            self.acc[d.step] = (s, n + d.n_samples, c + 1)
        else:
            self.acc[d.step] = (d.grads, d.n_samples, 1)
        return True

    def ready(self, step: int) -> bool:
        return step in self.acc and self.acc[step][2] >= self.quorum

    def missing(self, step: int) -> List[str]:
        d = step + 1
        return [h for h in self.hosts if not (
            self.seen.seen(Dot(h, d)) or self.sealed.seen(Dot(h, d)))]

    def seal(self, step: int) -> Tuple[Any, int]:
        """Close the step (deadline or quorum): returns (mean grads, count).

        Hosts that have not contributed are tombstoned for this step, so a
        late delta can never double-apply (same mechanism as §4.3.2's
        "if the adds were unseen they never get added").
        """
        if step not in self.acc:
            raise KeyError(f"no contributions for step {step}")
        for h in self.missing(step):
            self.sealed = self.sealed.add(Dot(h, step + 1))
        s, n, c = self.acc.pop(step)
        with torch.no_grad():
            for a in leaves(s):
                a.div_(max(n, 1))
        return s, c
