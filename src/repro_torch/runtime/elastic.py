"""Elastic scaling: membership-CRDT-driven data-parallel reconfiguration.

A simulated fleet of DP hosts whose roster is the converged ORSWOT
membership view.  On joins/leaves the batch partition is recomputed from
the *sorted alive set* (pure function of the view — every host derives the
same assignment with no coordinator), the seekable data pipeline re-shards,
and training resumes from the BigStore checkpoint.  This is the control
loop a 1000-node fleet runs on every membership epoch.

PyTorch port: a copy of :mod:`repro.runtime.elastic`; everything below
this docstring is unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..cluster.membership import GossipCluster


@dataclass
class Assignment:
    epoch: int
    hosts: Tuple[str, ...]          # sorted alive hosts
    batch_slices: Dict[str, Tuple[int, int]]  # host -> [lo, hi) of global batch

    @property
    def dp_size(self) -> int:
        return len(self.hosts)


def derive_assignment(members: frozenset, global_batch: int, epoch: int
                      ) -> Assignment:
    """Deterministic assignment from a membership view (no coordination)."""
    hosts = tuple(sorted(members))
    n = len(hosts)
    if n == 0:
        return Assignment(epoch, (), {})
    per = global_batch // n
    extra = global_batch - per * n
    slices = {}
    lo = 0
    for i, h in enumerate(hosts):
        hi = lo + per + (1 if i < extra else 0)
        slices[h] = (lo, hi)
        lo = hi
    return Assignment(epoch, hosts, slices)


class ElasticController:
    """Wraps a gossip cluster and emits assignments on membership change."""

    def __init__(self, n_nodes: int, global_batch: int):
        self.cluster = GossipCluster(n_nodes)
        self.cluster.settle()
        self.global_batch = global_batch
        self.epoch = 0
        self._last_members: Optional[frozenset] = None

    def current_assignment(self) -> Assignment:
        views = self.cluster.views()
        members = views[0]
        if not self.cluster.converged():
            # conservative: intersect views until gossip converges
            for v in views[1:]:
                members &= v
        if members != self._last_members:
            self.epoch += 1
            self._last_members = members
        return derive_assignment(members, self.global_batch, self.epoch)

    # -------------------------------------------------------------- events
    def scale_up(self, node_id: str) -> Assignment:
        self.cluster.node_joins(node_id)
        self.cluster.settle()
        return self.current_assignment()

    def scale_down(self, node_id: str) -> Assignment:
        self.cluster.node_leaves(node_id)
        self.cluster.settle()
        return self.current_assignment()

    def fail(self, node_id: str, detected_by: str) -> Assignment:
        """Crash: no goodbye message; a peer ejects via observed-remove."""
        self.cluster.eject(detected_by, node_id)
        self.cluster.settle()
        return self.current_assignment()
