"""Elastic cluster membership as a delta-replicated ORSWOT.

The control plane of a 1000+-node training fleet has exactly the Riak-set
problem: every node needs a convergent view of *who is in the cluster*
under joins, leaves, crashes and partitions, without a coordinator on the
critical path.  We use the paper's machinery directly:

* the member set is an ORSWOT of node ids (observed-remove: ejecting a
  straggler only removes the *observed* incarnation — a concurrently
  re-joining node wins, add-wins semantics being precisely what you want
  for "the node restarted");
* joins/leaves generate **deltas** gossiped peer-to-peer (bounded by causal
  metadata, not fleet size);
* each node tracks its *incarnation* via the dots of its own entry, so a
  node that was ejected and rejoined is distinguishable from a stale view.

``MembershipView.data_parallel_groups`` derives the elastic mesh
assignment (data-axis size = |alive|), and
:meth:`repro.cluster.placement.Ring.from_members` builds the placement
ring from the same converged alive-set.

PyTorch port: a copy of :mod:`repro.cluster.membership`; everything below
this docstring is unchanged.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple

from ..core.delta_orswot import delta_add, delta_remove
from ..core.orswot import Orswot
from .sim import Network


class MembershipView:
    """One node's convergent view of cluster membership."""

    def __init__(self, node_id: str):
        self.node_id = node_id
        self.state = Orswot.new()

    # ------------------------------------------------------------- mutators
    def join(self, node: Optional[str] = None) -> Orswot:
        node = node or self.node_id
        self.state, delta = delta_add(self.state, self.node_id, node)
        return delta

    def leave(self, node: Optional[str] = None) -> Orswot:
        """Observed-remove of a node (self-leave or straggler ejection)."""
        node = node or self.node_id
        ctx = self.state.context_of(node)
        self.state, delta = delta_remove(self.state, node, ctx)
        return delta

    # ---------------------------------------------------------------- merge
    def apply(self, delta: Orswot) -> None:
        self.state = self.state.merge(delta)

    def merge_view(self, other: "MembershipView") -> None:
        self.state = self.state.merge(other.state)

    # ---------------------------------------------------------------- reads
    def members(self) -> FrozenSet[str]:
        return frozenset(str(m) for m in self.state.value())

    def is_member(self, node: str) -> bool:
        return node in self.state.value()

    def incarnation(self, node: str) -> Tuple:
        return self.state.context_of(node)

    def data_parallel_groups(self, group_size: int = 1
                             ) -> Tuple[Tuple[str, ...], ...]:
        """Deterministic data-parallel mesh assignment over the alive-set.

        Sorted members chunk into groups of ``group_size`` (the final
        partial chunk is kept, so every alive node has a slot).  A pure
        function of :meth:`members`: any two converged views compute
        identical groups, and a join/leave perturbs only groups at and
        after the changed node's sorted position — the stability the
        elastic runtime (and :meth:`repro.cluster.placement.Ring.
        from_members`, which consumes the same alive-set) relies on.
        """
        if group_size < 1:
            raise ValueError("group_size must be >= 1")
        ms = sorted(self.members())
        return tuple(tuple(ms[i:i + group_size])
                     for i in range(0, len(ms), group_size))


class GossipCluster:
    """N nodes gossiping membership deltas over the simulated network."""

    def __init__(self, n_nodes: int, net: Optional[Network] = None):
        self.net = net or Network()
        self.nodes: Dict[str, MembershipView] = {}
        for i in range(n_nodes):
            nid = f"node{i}"
            self.nodes[nid] = MembershipView(nid)
        # bootstrap: every node joins and gossips
        for nid, view in self.nodes.items():
            self.broadcast(nid, view.join())

    def broadcast(self, src: str, delta: Orswot) -> None:
        for dst in self.nodes:
            if dst != src:
                self.net.send(src, dst, delta, delta.size_bytes())

    def settle(self) -> None:
        self.net.deliver_all(
            lambda m: self.nodes[m.dst].apply(m.payload))

    def anti_entropy_round(self) -> None:
        """Full-state pairwise repair (for partitions that dropped deltas)."""
        ids = sorted(self.nodes)
        for a, b in zip(ids, ids[1:] + ids[:1]):
            self.nodes[a].merge_view(self.nodes[b])
            self.nodes[b].merge_view(self.nodes[a])

    # --------------------------------------------------------------- events
    def node_joins(self, node_id: str) -> None:
        view = MembershipView(node_id)
        # bootstrap: a joining node seeds its view from an existing peer
        # (anti-entropy on join), then announces itself
        seeds = [v for v in self.nodes.values()]
        if seeds:
            view.merge_view(seeds[0])
        self.nodes[node_id] = view
        self.broadcast(node_id, view.join())

    def node_leaves(self, node_id: str) -> None:
        view = self.nodes[node_id]
        self.broadcast(node_id, view.leave())

    def eject(self, by: str, victim: str) -> None:
        """Straggler ejection by a peer (observed-remove)."""
        self.broadcast(by, self.nodes[by].leave(victim))

    def views(self) -> List[FrozenSet[str]]:
        return [v.members() for v in self.nodes.values()]

    def converged(self) -> bool:
        vs = self.views()
        return all(v == vs[0] for v in vs)
