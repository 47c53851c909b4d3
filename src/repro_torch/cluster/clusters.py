"""Three replicated-set clusters: Riak full-state, delta-replication, bigset.

These are the paper's three contenders (Figure 1).  All share the same
topology (N replicas per set, coordinator-forwarding, downstream
replication) and the same storage substrate, so the only variable is the
representation + replication strategy — exactly the comparison the paper
makes.

* :class:`RiakSetCluster` — §2: the ORSWOT serialized as one blob in a
  riak-object; every write reads + rewrites the blob; replication ships the
  full state; downstream merge on version-vector conflict.
* :class:`DeltaCluster` — §3: delta mutators ship small deltas, but the
  downstream replica still read-merge-writes the full blob.
* :class:`BigsetCluster` — §4: decomposed keys, clock-only writes,
  element-key deltas, dot-seen downstream apply.

PyTorch port of :mod:`repro.cluster.clusters`: :class:`BigsetCluster`
takes a ``device`` (default ``"cuda"``), and every query executor it builds
runs its visibility filters there.
"""
from __future__ import annotations

import msgpack
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ..core.bigset import BigsetVnode, InsertDelta, RemoveDelta
from ..core.clock import Clock
from ..core.delta_orswot import delta_add, delta_remove, join_delta
from ..core.dots import Dot
from ..core.orswot import Orswot
from ..core.streaming import merge_entry, quorum_is_member, quorum_read
from ..device import DeviceLike, resolve_device
from ..index.spec import IndexSpec
from ..obs.trace import NULL_TRACER, TraceContext, Tracer
from ..query import cursor as query_cursor
from ..query import plan as query_plan
from ..query.executor import (QueryExecutor, QueryResult, QueryStats,
                              account_emitted, collect_index_page,
                              collect_page, gallop_join, index_resume_point,
                              stream_entries, zipper_join)
from ..query.planner import (GALLOP, SideStats, choose_join, side_stats,
                             quorum_side_stats)
from ..storage.lsm import LsmStore
from ..storage.wal import DurableMedia, RecoveryResult
from .antientropy import (AntiEntropyScheduler, AntiEntropyStats,
                          HandoffTask, RetireTask, SyncRequest,
                          apply_digest_reply, build_digest_reply,
                          handoff_complete, survivors_digest)
from .placement import (CoveragePlan, PreferenceList, Ring, RingDelta,
                        VnodeDown, plan_coverage)
from .sim import Message, Network

__all__ = [
    "BigsetCluster", "ClusterSession", "DeltaCluster", "RiakSetCluster",
    "Ring", "VnodeDown",
]


# ------------------------------------------------------------ serve sessions
class ClusterSession:
    """Hook surface the serve layer attaches to cluster entry points.

    A session observes — never alters — what its requests cost: the service
    (:mod:`repro.serve.bigset_service`) feeds its byte-budget admission
    control from ``observe_query`` (per-page :class:`~repro.query.executor.
    QueryStats`, themselves fed from storage IoStats) and its write
    accounting from ``observe_mutation`` (delta sizes).  The default
    implementation is a no-op so library callers pay nothing.
    """

    def observe_query(self, plan, result: "QueryResult") -> None:
        pass

    def observe_mutation(self, delta) -> None:
        pass


# ------------------------------------------------------------ traced payloads
@dataclass(frozen=True)
class TracedPayload:
    """A network payload carrying its sender's :class:`TraceContext`.

    Only minted when tracing is **enabled** — disabled clusters ship the
    raw payload object, byte-identical to untraced operation (asserted in
    ``tests/test_obs.py``).  The context names a span that was finished
    *before* the message entered the network, so however delivery goes
    (dropped, duplicated, reordered), a delivered message's ``net.deliver``
    span always parents under a span that exists: drops lose leaves,
    never tree integrity.
    """

    ctx: TraceContext
    payload: Any


# --------------------------------------------------------------- orswot codec
def orswot_to_bytes(s: Orswot) -> bytes:
    """Run-length orswot codec: the clock ships as interval runs."""
    obj = s.clock.to_obj()
    obj["e"] = sorted(
        (e, sorted((d.actor, d.counter) for d in ds))
        for e, ds in s.entries.items()
    )
    return msgpack.packb(obj)


def orswot_from_bytes(b: Optional[bytes]) -> Orswot:
    """Decode an orswot blob — run-length or legacy per-dot clock form."""
    if b is None:
        return Orswot.new()
    o = msgpack.unpackb(b, strict_map_key=False)
    clock = Clock.from_obj(o)
    entries = {
        e: frozenset(Dot(a, c) for a, c in ds) for e, ds in o["e"]
    }
    return Orswot(clock, entries)


class _ClusterBase:
    """Shared topology: ``n_replicas`` vnodes all replicating every set."""

    def __init__(self, n_replicas: int = 3, net: Optional[Network] = None,
                 sync: bool = True):
        self.n = n_replicas
        self.net = net or Network()
        self.sync = sync  # deliver replication traffic immediately
        self.actors = [f"vnode{i}" for i in range(n_replicas)]

    def _replicate(self, src: str, payload, size: int) -> None:
        for a in self.actors:
            if a != src:
                self.net.send(src, a, payload, size)
        if self.sync:
            self.net.deliver_all(self._handle)

    def settle(self) -> None:
        self.net.deliver_all(self._handle)

    def _handle(self, msg: Message) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def io_stats(self):
        raise NotImplementedError


class RiakSetCluster(_ClusterBase):
    """Full-state ORSWOT-in-a-blob (Riak Sets, §2)."""

    def __init__(self, n_replicas: int = 3, net: Optional[Network] = None,
                 sync: bool = True):
        super().__init__(n_replicas, net, sync)
        self.stores: Dict[str, LsmStore] = {a: LsmStore() for a in self.actors}

    def _key(self, set_name: bytes) -> bytes:
        return b"riak_set/" + set_name

    def _load(self, actor: str, set_name: bytes) -> Orswot:
        return orswot_from_bytes(self.stores[actor].get(self._key(set_name)))

    def _save(self, actor: str, set_name: bytes, s: Orswot) -> bytes:
        blob = orswot_to_bytes(s)
        self.stores[actor].put(self._key(set_name), blob)
        return blob

    def add(self, set_name: bytes, element: bytes, coordinator: int = 0) -> None:
        actor = self.actors[coordinator]
        s = self._load(actor, set_name)           # read whole set — O(n)
        s = s.add(actor, element)
        blob = self._save(actor, set_name, s)     # write whole set — O(n)
        self._replicate(actor, ("state", set_name, blob), len(blob))

    def remove(self, set_name: bytes, element: bytes, coordinator: int = 0) -> None:
        actor = self.actors[coordinator]
        s = self._load(actor, set_name)
        ctx = s.context_of(element)
        s = s.remove(element, ctx)
        blob = self._save(actor, set_name, s)
        self._replicate(actor, ("state", set_name, blob), len(blob))

    def _handle(self, msg: Message) -> None:
        _, set_name, blob = msg.payload
        local = self._load(msg.dst, set_name)      # read whole set
        incoming = orswot_from_bytes(blob)
        if incoming.clock.descends(local.clock):
            merged = incoming                      # supersedes: store directly
        else:
            merged = local.merge(incoming)         # conflict: full merge
        self._save(msg.dst, set_name, merged)      # write whole set

    def read(self, set_name: bytes, r: int = 1) -> Orswot:
        acc = Orswot.new()
        for a in self.actors[:max(r, 1)]:
            acc = acc.merge(self._load(a, set_name))
        return acc

    def value(self, set_name: bytes, r: int = 1):
        return self.read(set_name, r).value()

    def io_stats(self):
        from ..storage.lsm import IoStats
        agg = IoStats()
        for st in self.stores.values():
            for k in vars(agg):
                setattr(agg, k, getattr(agg, k) + getattr(st.stats, k))
        return agg


class DeltaCluster(RiakSetCluster):
    """Delta-replication ORSWOT (§3): small wire deltas, full-state disk IO."""

    def add(self, set_name: bytes, element: bytes, coordinator: int = 0) -> None:
        actor = self.actors[coordinator]
        s = self._load(actor, set_name)            # still reads whole set
        s, delta = delta_add(s, actor, element)
        self._save(actor, set_name, s)             # still writes whole set
        dblob = orswot_to_bytes(delta)
        self._replicate(actor, ("delta", set_name, dblob), len(dblob))

    def remove(self, set_name: bytes, element: bytes, coordinator: int = 0) -> None:
        actor = self.actors[coordinator]
        s = self._load(actor, set_name)
        ctx = s.context_of(element)
        s, delta = delta_remove(s, element, ctx)
        self._save(actor, set_name, s)
        dblob = orswot_to_bytes(delta)
        self._replicate(actor, ("delta", set_name, dblob), len(dblob))

    def _handle(self, msg: Message) -> None:
        _, set_name, dblob = msg.payload
        local = self._load(msg.dst, set_name)      # read whole set
        delta = orswot_from_bytes(dblob)
        merged = join_delta(local, delta)          # merge ALWAYS (§3)
        self._save(msg.dst, set_name, merged)      # write whole set


class BigsetCluster(_ClusterBase):
    """Decomposed bigset cluster (§4).

    ``durable=True`` gives every vnode a :class:`DurableMedia`-backed
    store (WAL + group commit at ``group_depth``); :meth:`crash` /
    :meth:`restart` then model the ROADMAP's "node restarts under
    traffic" fault: a crash drops the vnode's in-memory state and its
    unsynced WAL tail, a restart replays the durable prefix and scheduled
    anti-entropy (:meth:`tick`) heals the rest from peers.

    ``device`` is where queries filter visibility: ``"cuda"`` (the
    default) launches the ``dot_seen`` CUDA kernel and raises when there is
    no card; ``"cpu"`` runs the plain PyTorch version.
    """

    def __init__(self, n_replicas: int = 3, net: Optional[Network] = None,
                 sync: bool = True,
                 scheduler: Optional[AntiEntropyScheduler] = None,
                 tracer: Optional[Tracer] = None,
                 durable: bool = False, group_depth: int = 8,
                 media: Optional[Dict[str, DurableMedia]] = None,
                 ring: Optional[Ring] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        super().__init__(n_replicas, net, sync)
        if ring is not None:
            # the ring names the cluster: its actors become the vnodes
            self.actors = list(ring.actors)
            self.n = len(self.actors)
        # degenerate default: one partition owned by everyone, storage
        # passthrough — byte-identical to the pre-partitioning cluster
        self.ring = ring if ring is not None else Ring.full(self.actors)
        self._rings: Dict[int, Ring] = {self.ring.epoch: self.ring}
        self._retired_epochs: Set[int] = set()
        # logical sets the write path has touched (handoff planning input)
        self._known_sets: Set[bytes] = set()
        # sloppy placement bookkeeping: (pset, fallback, owner) -> hint
        self._hints: Dict[Tuple[bytes, str, str],
                          Tuple[bytes, bytes, int, str, str]] = {}
        self._handoffs: List[HandoffTask] = []
        self._retires: List[RetireTask] = []
        # (old_epoch, handoff tasks, retire tasks): the old ring stays
        # serveable for pinned cursors until its transition fully retires
        self._transitions: List[Tuple[int, List[HandoffTask],
                                      List[RetireTask]]] = []
        self.durable = durable or media is not None
        self.group_depth = group_depth
        if self.durable:
            self.media: Optional[Dict[str, DurableMedia]] = (
                media or {a: DurableMedia() for a in self.actors})
            self.vnodes: Dict[str, BigsetVnode] = {
                a: BigsetVnode(a, store=LsmStore(
                    media=self.media[a], group_depth=group_depth))
                for a in self.actors
            }
        else:
            self.media = None
            self.vnodes = {a: BigsetVnode(a) for a in self.actors}
        self.crashed: Set[str] = set()
        # index specs by (set, index name): a restarted vnode re-registers
        # them so downstream extractors keep running identically everywhere
        self._index_specs: Dict[bytes, Dict[bytes, IndexSpec]] = {}
        # read repair feeds this; tick() drains it (see antientropy module)
        self.scheduler = scheduler or AntiEntropyScheduler(self.actors)
        # observability: NULL_TRACER by default — disabled tracing wraps no
        # payloads and records no spans (zero behavior change, invariant 10)
        self.tracer = tracer or NULL_TRACER

    # ---------------------------------------------------------- ring access
    def ring_for(self, epoch: Optional[int]) -> Ring:
        """The ring at ``epoch``, or the current ring when ``epoch`` is
        None, unknown, or already retired (handoff moved its data away).

        Cursor leases pin the epoch their plan ran under; falling forward
        to the current ring is safe because cursors are element
        boundaries — placement-agnostic — so a resumed page re-plans
        coverage under the live ring and continues from the same element.
        """
        if epoch is None or epoch in self._retired_epochs:
            return self.ring
        return self._rings.get(epoch, self.ring)

    def ring_state(self) -> Dict[str, object]:
        """Ring observability snapshot (the serve layer's ``stats`` op)."""
        return {
            "epoch": self.ring.epoch,
            "factor": self.ring.factor,
            "n_partitions": self.ring.n_partitions,
            "actors": list(self.ring.actors),
            "full_replication": self.ring.full_replication,
            "serveable_epochs": sorted(
                e for e in self._rings if e not in self._retired_epochs),
            "handoffs_pending": sum(1 for t in self._handoffs if not t.done),
            "retires_pending": sum(1 for t in self._retires if not t.done),
            "hints_pending": len(self._hints),
        }

    def _note_set(self, set_name: bytes, pref: PreferenceList,
                  pset: bytes) -> None:
        self._known_sets.add(set_name)
        if self.ring.full_replication:
            self.scheduler.note_set(pset)
        else:
            self.scheduler.note_set(pset, owners=pref.owners)

    def _route_write(self, entry: str, set_name: bytes,
                     pref: PreferenceList) -> Tuple[str, List[str]]:
        """Owner-routed write placement for one partition.

        Returns ``(coordinator, replication targets)``.  The coordinator
        is the client's entry vnode when it owns the partition, else the
        first live owner (clients route by the shared ring, so this hop
        is placement math, not a billed message).  Targets are every
        owner — crashed ones included, their messages drop in the
        blackholed network exactly as before partitioning — plus one
        *sloppy* fallback per crashed owner, with a hint recorded so the
        fallback's copy is handed to the owner when it returns.
        """
        live = [a for a in pref.owners if a not in self.crashed]
        down = [a for a in pref.owners if a in self.crashed]
        targets = list(pref.owners)
        fallbacks = iter(
            a for a in pref.fallbacks
            if a not in self.crashed and a not in targets)
        sloppy: List[str] = []
        hinted: List[Tuple[str, str]] = []
        for owner in down:
            fb = next(fallbacks, None)
            if fb is None:
                break
            targets.append(fb)
            sloppy.append(fb)
            hinted.append((fb, owner))
        if (not self.ring.full_replication
                and len(live) + len(sloppy) < self.ring.write_quorum()):
            # invariant 13: acknowledged ⇒ durable on a write-quorum of
            # the preference list.  Too few live owners and no fallbacks
            # left to park hints on — refuse loudly rather than ack a
            # write that a single further failure could erase.
            raise VnodeDown(
                f"write quorum unreachable for partition {pref.pid} of "
                f"{set_name!r}: {len(live)} live of {pref.owners}, "
                f"{len(sloppy)} fallbacks", vnode=down[0], set_name=set_name)
        for fb, owner in hinted:
            self._record_hint(set_name, pref, fb, owner)
        if entry in live:
            coordinator = entry
        elif live:
            coordinator = live[0]
        elif sloppy:
            coordinator = sloppy[0]
        else:
            raise VnodeDown(
                f"no live owner or fallback for partition {pref.pid} of "
                f"{set_name!r} ({pref.owners} crashed)",
                vnode=pref.owners[0], set_name=set_name)
        return coordinator, targets

    def _record_hint(self, set_name: bytes, pref: PreferenceList,
                     fallback: str, owner: str) -> None:
        pset = self.ring.storage_set(set_name, pref.pid)
        key = (pset, fallback, owner)
        if key not in self._hints:
            self._hints[key] = (set_name, pset, pref.pid, fallback, owner)
            self.scheduler.stats.hints_recorded += 1

    def _replicate_to(self, src: str, targets: Iterable[str], payload,
                      size: int) -> None:
        for a in targets:
            if a != src:
                self.net.send(src, a, payload, size)
        if self.sync:
            self.net.deliver_all(self._handle)

    # ------------------------------------------------------- crash / restart
    def _actor(self, vnode) -> str:
        return self.actors[vnode] if isinstance(vnode, int) else vnode

    def _coordinator(self, coordinator: int,
                     set_name: Optional[bytes] = None) -> str:
        actor = self._actor(coordinator)
        if actor in self.crashed:
            raise VnodeDown(f"{actor} is crashed", vnode=actor,
                            set_name=set_name)
        return actor

    def crash(self, vnode) -> None:
        """Kill a vnode: memtable, digests, and the unsynced WAL tail are
        gone; the durable media survives for :meth:`restart`.  In-flight
        and future traffic to the vnode is dropped by the network."""
        if not self.durable:
            raise RuntimeError("crash() requires a durable cluster")
        actor = self._actor(vnode)
        if actor in self.crashed:
            return
        self.crashed.add(actor)
        self.vnodes.pop(actor, None)
        self.media[actor].crash()
        self.net.blackhole(actor)

    def restart(self, vnode) -> RecoveryResult:
        """Bring a crashed vnode back from its durable media.

        A fresh store replays manifested segments + the WAL's acknowledged
        prefix (``storage.recover`` span); the new vnode adopts it — its
        per-set digests rebuild from one background fold on first touch —
        and re-registers every known index spec without backfill (postings
        were durable alongside their element-keys).  The unacknowledged
        tail is *not* back: scheduled anti-entropy heals it from peers,
        dot-bounded.  Returns the replay's :class:`RecoveryResult`.
        """
        actor = self._actor(vnode)
        if actor not in self.crashed:
            raise RuntimeError(f"{actor} is not crashed")
        store = LsmStore(media=self.media[actor],
                         group_depth=self.group_depth)
        with self.tracer.span("storage.recover", actor=actor) as sp:
            rec = store.recover()
            sp.set(segments=rec.segments,
                   batches_replayed=rec.batches_replayed,
                   batches_skipped=rec.batches_skipped,
                   bytes_replayed=rec.bytes_replayed,
                   torn_bytes=rec.torn_bytes)
        vn = BigsetVnode(actor, store=store)
        for set_name, specs in self._index_specs.items():
            for pset in self.ring.storage_sets(set_name):
                for spec in specs.values():
                    vn.register_index(pset, spec, backfill=False)
        self.vnodes[actor] = vn
        self.net.heal(actor)
        self.crashed.discard(actor)
        return rec

    def sync_all(self) -> None:
        """Force the pending group commit on every live vnode — the write
        path's explicit acknowledgement barrier."""
        for vn in self.vnodes.values():
            vn.store.sync()

    def _traced(self, ctx_span, payload):
        """Wrap a payload with the span's context iff tracing is enabled."""
        if not self.tracer.enabled:
            return payload
        return TracedPayload(ctx_span.context(), payload)

    def add(self, set_name: bytes, element: bytes, coordinator: int = 0,
            ctx: Iterable[Dot] = (), value: bytes = b"",
            session: Optional[ClusterSession] = None) -> InsertDelta:
        """Coordinate an insert; returns the minted delta.

        The delta's ``dot`` is the insert's causal identity — the serve
        layer round-trips it to clients as the context for a later remove
        or replacing add.

        Routing: the element's partition names its preference list; the
        write coordinates at an owner (the requested vnode when it owns
        the partition) and replicates to the other owners — plus sloppy
        fallbacks, hint recorded, for any crashed owner.
        """
        entry = self._coordinator(coordinator, set_name)
        pref = self.ring.preference_list(set_name, element)
        pset = self.ring.storage_set(set_name, pref.pid)
        self._note_set(set_name, pref, pset)
        actor, targets = self._route_write(entry, set_name, pref)
        with self.tracer.span("cluster.insert", set_name=set_name,
                              actor=actor) as sp:
            delta = self.vnodes[actor].coordinate_insert(
                pset, element, ctx, value=value)
            self._replicate_to(actor, targets, self._traced(sp, delta),
                               delta.size_bytes())
        if session is not None:
            session.observe_mutation(delta)
        return delta

    def register_index(self, set_name: bytes, spec: IndexSpec,
                       backfill: bool = True) -> int:
        """Register a secondary index on every replica (extractors must run
        identically downstream — including on vnodes that only ever see a
        partition via sloppy placement or a later ring change, so the spec
        lands on every vnode for every partition of the set).  Returns
        total backfill postings written.  The spec is remembered so a
        restarted or newly joined vnode re-registers it."""
        self._index_specs.setdefault(set_name, {})[spec.name] = spec
        return sum(
            vn.register_index(pset, spec, backfill=backfill)
            for pset in self.ring.storage_sets(set_name)
            for vn in self.vnodes.values())

    def remove(self, set_name: bytes, element: bytes, coordinator: int = 0,
               ctx: Optional[Iterable[Dot]] = None,
               session: Optional[ClusterSession] = None
               ) -> Optional[RemoveDelta]:
        """Observed-remove: ctx defaults to a local membership probe (§4.3.2
        — "the client **must** provide a context for a remove").  Returns
        the shipped delta, or None when there was nothing to remove.

        Routed like :meth:`add`: the probe and the clock-only write both
        happen at an owner of the element's partition, so the context dots
        and the tombstone live in the same partition clock domain.
        """
        entry = self._coordinator(coordinator, set_name)
        pref = self.ring.preference_list(set_name, element)
        pset = self.ring.storage_set(set_name, pref.pid)
        self._note_set(set_name, pref, pset)
        actor, targets = self._route_write(entry, set_name, pref)
        vn = self.vnodes[actor]
        if ctx is None:
            _, ctx = vn.is_member(pset, element)
        ctx = tuple(ctx)
        if not ctx:
            return None
        with self.tracer.span("cluster.remove", set_name=set_name,
                              actor=actor) as sp:
            delta = vn.coordinate_remove(pset, ctx)
            self._replicate_to(actor, targets, self._traced(sp, delta),
                               delta.size_bytes())
        if session is not None:
            session.observe_mutation(delta)
        return delta

    def mutate(self, set_name: bytes, ops: Sequence[Tuple], coordinator: int = 0,
               session: Optional[ClusterSession] = None) -> List:
        """Batch mutation entry point (the serve layer's write path).

        ``ops`` is a sequence of ``("add", element[, value[, ctx]])`` and
        ``("remove", element[, ctx])`` tuples, applied in order through one
        coordinator so a remove can observe an earlier add in the same
        batch.  Returns the per-op deltas (None for no-op removes).
        """
        out: List = []
        for op in ops:
            kind, element = op[0], op[1]
            if kind == "add":
                value = op[2] if len(op) > 2 else b""
                ctx = op[3] if len(op) > 3 else ()
                out.append(self.add(set_name, element, coordinator, ctx=ctx,
                                    value=value, session=session))
            elif kind == "remove":
                ctx = op[2] if len(op) > 2 else None
                out.append(self.remove(set_name, element, coordinator,
                                       ctx=ctx, session=session))
            else:
                raise ValueError(f"unknown mutation op {kind!r}")
        return out

    def _handle(self, msg: Message) -> None:
        payload = msg.payload
        if isinstance(payload, TracedPayload):
            # the delivery span parents on the *sender's* span via the
            # carried context — correct under drop/dup/reorder, where the
            # call stack at delivery time says nothing about causality
            with self.tracer.span("net.deliver", parent=payload.ctx,
                                  src=msg.src, dst=msg.dst,
                                  size_bytes=msg.size_bytes):
                self._deliver(msg.dst, payload.payload)
        else:
            self._deliver(msg.dst, payload)

    def _deliver(self, dst: str, payload) -> None:
        vn = self.vnodes[dst]
        if isinstance(payload, InsertDelta):
            vn.replica_insert(payload)
        elif isinstance(payload, RemoveDelta):
            vn.replica_remove(payload)
        else:  # anti-entropy and membership traffic uses callables
            payload(vn)

    def read(self, set_name: bytes, r: int = 1) -> Orswot:
        if self.ring.full_replication:
            streams = []
            for a in self.actors[:r]:
                rs = self.vnodes[a].read(set_name)
                streams.append((rs.clock, rs.entries()))
            return quorum_read(streams)
        live = [a for a in self.actors if a not in self.crashed]
        cover = plan_coverage(self.ring, set_name, live, r)
        clock = Clock.zero()
        entries: Dict[bytes, frozenset] = {}
        for _pid, pset, actors in cover.assignments:
            streams = []
            for a in actors:
                rs = self.vnodes[a].read(pset)
                streams.append((rs.clock, rs.entries()))
            part = quorum_read(streams)
            # partitions have disjoint elements and independent clock
            # domains; the joined clock is a membership-only view, never a
            # causal context (each entry's dots stay partition-scoped)
            clock = clock.join(part.clock)
            entries.update(part.entries)
        return Orswot(clock, entries)

    def value(self, set_name: bytes, r: int = 1):
        return self.read(set_name, r).value()

    # -------------------------------------------------------------- queries
    def _covers(self, plan, ring: Ring, r: int) -> List[CoveragePlan]:
        """Coverage plans the query needs: one per logical set touched.

        Membership covers only the element's own partition; range-shaped
        plans cover every partition of the set; joins cover both sides.
        """
        live = [a for a in self.actors if a not in self.crashed]
        if isinstance(plan, query_plan.Membership):
            pid = ring.partition(plan.set_name, plan.element)
            return [plan_coverage(ring, plan.set_name, live, r, pids=[pid])]
        if isinstance(plan, query_plan.Join):
            return [plan_coverage(ring, plan.left, live, r),
                    plan_coverage(ring, plan.right, live, r)]
        return [plan_coverage(ring, plan.set_name, live, r)]

    @staticmethod
    def _cover_vnodes(covers: Sequence[CoveragePlan]) -> List[str]:
        """Union of covered vnodes, first-appearance order (meter order)."""
        seen: List[str] = []
        for cover in covers:
            for _pid, _pset, actors in cover.assignments:
                for a in actors:
                    if a not in seen:
                        seen.append(a)
        return seen

    def query(self, plan, r: Optional[int] = None, repair: bool = True,
              session: Optional[ClusterSession] = None,
              ring_epoch: Optional[int] = None) -> QueryResult:
        """Coverage-query path: plan a minimal covering set over the ring's
        partition owners, stream each partition through an ``r``-replica
        quorum merge, and read-repair stragglers.

        Each covered replica contributes a lazy visible-entry stream (a
        storage seek + bounded scan, §4.4) for each partition it owns; the
        per-partition merge is the streaming ORSWOT join of
        :mod:`repro.core.streaming` with per-replica dot attribution so any
        replica missing a surviving dot gets the element-key delta replayed
        to it (read repair) — anti-entropy rides on the query workload.
        Partition streams fan in by element order, so results are
        byte-identical to an unpartitioned cluster.  ``r`` defaults to a
        majority of the replication factor.  ``ring_epoch`` pins the ring a
        cursor's plan ran under (cursor leases); a retired epoch falls
        forward to the current ring — cursors are element boundaries, so
        they resume under any ring.  A ``session``
        (:class:`ClusterSession`) observes the result post-accounting — the
        serve layer's backpressure budget hangs off this hook.
        """
        query_plan.validate(plan)
        ring = self.ring_for(ring_epoch)
        if r is None:
            r = ring.write_quorum()
        # coverage planning routes around crashed replicas: a non-quorum
        # crash leaves reads fully available (restart-under-traffic)
        covers = self._covers(plan, ring, r)
        vnode_order = self._cover_vnodes(covers)
        tr = self.tracer
        with tr.span("cluster.query", plan=type(plan).__name__,
                     set_name=getattr(plan, "set_name", b""), r=r) as qspan:
            meters = [self.vnodes[a].store.meter() for a in vnode_order]
            # coverage sub-spans opened per covered replica BEFORE execution
            # (their storage children get the replica's IoStats delta after)
            rspans = ([tr.start("replica.coverage", parent=qspan.context(),
                                actor=a) for a in vnode_order]
                      if tr.enabled else None)
            if isinstance(plan, query_plan.Membership):
                res = self._q_membership(plan, covers[0], repair)
            elif isinstance(plan, query_plan.Range):
                res = self._q_range(
                    plan.start, plan.end, plan.limit,
                    plan.cursor, query_plan.cursor_scope(plan), covers[0],
                    repair)
            elif isinstance(plan, query_plan.Scan):
                res = self._q_range(
                    None, None, plan.page_size,
                    plan.cursor, query_plan.cursor_scope(plan), covers[0],
                    repair)
            elif isinstance(plan, query_plan.Count):
                res = self._q_count(plan, covers[0], repair)
            elif isinstance(plan, query_plan.Join):
                res = self._q_join(plan, ring, covers, repair)
            elif isinstance(plan,
                            (query_plan.IndexLookup, query_plan.IndexRange)):
                res = self._q_index(plan, covers[0], repair)
            else:  # pragma: no cover - validate() rejects
                raise query_plan.PlanError(type(plan).__name__)
            res.stats.coverage = (
                f"epoch={ring.epoch};"
                f"partitions={sum(len(c.assignments) for c in covers)};"
                f"vnodes={len(vnode_order)};r={r}")
            for i, m in enumerate(meters):
                io = m.delta()
                res.stats.bytes_read += io.bytes_read
                res.stats.num_seeks += io.num_seeks
                if rspans is not None:
                    rspan = rspans[i]
                    tr.finish(tr.start(
                        "storage.scan", parent=rspan.context(),
                        bytes_read=io.bytes_read, num_seeks=io.num_seeks))
                    tr.finish(rspan.set(bytes_read=io.bytes_read,
                                        num_seeks=io.num_seeks))
            account_emitted(res)
            if tr.enabled:
                # one summary span for the query's batched-visibility work:
                # the per-query half of the kernel-launch baseline
                tr.finish(tr.start(
                    "kernel.dot_seen", parent=qspan.context(),
                    launches=res.stats.kernel_launches,
                    rows=res.stats.kernel_rows))
                qspan.set(elements=res.stats.elements_emitted,
                          bytes_read=res.stats.bytes_read)
        if session is not None:
            session.observe_query(plan, res)
        return res

    def _executors(self, actors) -> List[QueryExecutor]:
        return [QueryExecutor(self.vnodes[a], device=self.device)
                for a in actors]

    def _repair(self, set_name: bytes, element: bytes, dots, per_stream,
                clocks, actors) -> None:
        """Replay surviving element-keys to quorum replicas missing them.

        The replayed delta carries the stored value, fetched from a replica
        that holds the key (element-keys are immutable payload under CRDT
        liveness, so any holder's copy is authoritative).
        """
        from ..core.bigset import element_key

        tr = self.tracer
        rspan = None  # opened lazily: only an actual replay deserves a span
        sent = False
        replayed = 0
        for dot in dots:
            targets = [
                a for i, a in enumerate(actors)
                if dot not in (per_stream[i] or frozenset())
                and not clocks[i].seen(dot)
            ]
            if not targets:
                # everyone already has it: the common case is free
                self.scheduler.record_repair_miss(set_name)
                continue
            donors = [
                a for i, a in enumerate(actors)
                if per_stream[i] is not None and dot in per_stream[i]
            ]
            value: Optional[bytes] = None
            src = None
            for donor in donors:
                v = self.vnodes[donor].store.get(
                    element_key(set_name, element, dot))
                if v is not None:
                    value, src = v, donor
                    break
            if value is None:
                # no replica can supply the payload (the stream head
                # outlived its key, or the donor raced a compaction):
                # shipping a fabricated b"" would poison downstream index
                # postings, so skip the dot and let scheduled anti-entropy
                # replay it with its real value
                self.scheduler.record_no_donor(set_name)
                continue
            if rspan is None and tr.enabled:
                rspan = tr.start("query.read_repair", set_name=set_name,
                                 element=element)
            for a in targets:
                delta = InsertDelta(set_name, element, dot, value=value)
                payload = (TracedPayload(rspan.context(), delta)
                           if rspan is not None else delta)
                self.net.send(src, a, payload, delta.size_bytes())
                self.scheduler.record_repair_hit(set_name, a, src)
                sent = True
                replayed += 1
        if rspan is not None:
            tr.finish(rspan.set(replayed=replayed))
        if sent and self.sync:
            self.net.deliver_all(self._handle)

    def _q_membership(self, plan, cover: CoveragePlan, repair) -> QueryResult:
        # membership touches exactly one partition: the element's own
        _pid, pset, actors = cover.assignments[0]
        probe_plan = (plan if pset == plan.set_name else
                      query_plan.Membership(pset, plan.element))
        probes = [ex.execute(probe_plan) for ex in self._executors(actors)]
        clocks = [p.clock for p in probes]
        res_stats = QueryStats(
            keys_scanned=sum(p.stats.keys_scanned for p in probes),
            batches=sum(p.stats.batches for p in probes),
            keys_probed=sum(p.stats.keys_probed for p in probes))
        per_stream = [
            frozenset(p.entries[0][1]) if p.present else None for p in probes
        ]
        present, dots = quorum_is_member(list(zip(clocks, per_stream)))
        res = QueryResult(clock=Clock.zero(), stats=res_stats)
        for c in clocks:
            res.clock = res.clock.join(c)
        res.present = present
        if present:
            res.entries = [(plan.element, dots)]
            if repair:
                self._repair(pset, plan.element, dots, per_stream,
                             clocks, actors)
        return res

    def _fan_stream(self, cover: CoveragePlan, start, end, after, repair,
                    stats: QueryStats):
        """One element-ordered stream over every covered partition.

        A single partition (the full-replication ring) returns the
        partition's quorum stream directly — the exact pre-partitioning
        object graph.  Multiple partitions fan in by head element;
        partitions split elements disjointly, so the k-way merge needs no
        cross-stream dedup and each element's quorum merge still happens
        entirely inside its own partition clock domain.
        """
        streams = [
            self._quorum_stream(pset, actors, start, end, after, repair,
                                stats=stats)
            for _pid, pset, actors in cover.assignments
        ]
        if len(streams) == 1:
            return streams[0]
        return _FanInStream(streams)

    def _quorum_stream(self, set_name, actors, start, end, after, repair,
                       stats: Optional[QueryStats] = None) -> "_QuorumStream":
        streams = [
            ex.entry_stream(set_name, start=start, end=end, after=after,
                            stats=stats)
            for ex in self._executors(actors)
        ]
        clocks = [self.vnodes[a].read_clock(set_name) for a in actors]
        repair_fn = (
            (lambda el, dots, per: self._repair(
                set_name, el, dots, per, clocks, actors))
            if repair else None)
        return _QuorumStream(streams, clocks, repair_fn)

    def _q_range(self, start, end, limit, cursor, scope, cover, repair
                 ) -> QueryResult:
        resume_start, after = query_cursor.resume_point(cursor, scope)
        if resume_start is not None:
            start = resume_start
        res = QueryResult()
        merged = self._fan_stream(cover, start, end, after, repair,
                                  stats=res.stats)
        res.clock = merged.clock
        collect_page(stream_entries(merged), limit, scope, res)
        return res

    def _q_count(self, plan, cover, repair) -> QueryResult:
        res = QueryResult()
        merged = self._fan_stream(cover, plan.start, plan.end, None, repair,
                                  stats=res.stats)
        res.clock = merged.clock
        n = 0
        while merged.advance() is not None:
            n += 1
        res.count = n
        return res

    def _index_quorum_stream(self, plan, pset, actors, at, after, repair,
                             res: QueryResult) -> "_QuorumStream":
        start, end = query_plan.index_span(plan)
        streams = [
            ex.index_stream(pset, plan.index, start=start, end=end,
                            at=at, after=after, stats=res.stats)
            for ex in self._executors(actors)
        ]
        clocks = [self.vnodes[a].read_clock(pset) for a in actors]
        repair_fn = (
            (lambda pos, dots, per: self._repair(
                pset, pos[1], dots, per, clocks, actors))
            if repair else None)

        def absent_fn(i, pos):
            ds = self.vnodes[actors[i]].is_member(pset, pos[1])[1]
            return frozenset(ds) if ds else None

        return _QuorumStream(streams, clocks, repair_fn, absent_fn)

    def _q_index(self, plan, cover, repair) -> QueryResult:
        """Quorum-merged index query.

        Each covered replica contributes its partition's visible
        posting-group stream; the per-partition merge is the same
        streaming ORSWOT rule as element ranges, keyed by
        ``(index_key, element)``, and partitions fan in by that same key
        (postings scatter across partitions with their elements, so every
        partition must be covered — the index key says nothing about the
        element hash).  A replica missing a surviving element gets the
        element-key delta replayed (read repair) — downstream
        ``replica_insert`` re-derives the postings from the delta, so index
        repair is the ordinary write path, not a second protocol.
        """
        scope = query_plan.cursor_scope(plan)
        at, after = index_resume_point(plan.cursor, scope)
        res = QueryResult(index_entries=[])
        if isinstance(plan, query_plan.IndexLookup):
            # one probe per covered replica stream, matching the quorum
            # membership path
            res.stats.keys_probed += sum(
                len(actors) for _pid, _pset, actors in cover.assignments)
        streams = [
            self._index_quorum_stream(plan, pset, actors, at, after, repair,
                                      res)
            for _pid, pset, actors in cover.assignments
        ]
        merged = streams[0] if len(streams) == 1 else _FanInStream(streams)
        res.clock = merged.clock
        collect_index_page(merged, plan.limit, scope, res)
        return res

    def _cover_side_stats(self, cover: CoveragePlan) -> SideStats:
        """One join side's size across its covered partition replicas.

        Sums preserve the left:right skew ratio the cost model compares,
        exactly as :func:`~repro.query.planner.quorum_side_stats` did for
        full replication (of which this is the one-partition special
        case)."""
        keys = nbytes = 0
        for _pid, pset, actors in cover.assignments:
            for a in actors:
                s = side_stats(self.vnodes[a].store, pset)
                keys += s.keys
                nbytes += s.bytes
        return SideStats(keys=keys, bytes=nbytes)

    def _fan_probe(self, set_name: bytes, ring: Ring, cover: CoveragePlan,
                   repair, stats: QueryStats):
        """Partition-routed point probe for gallop joins.

        Builds one quorum probe per covered partition; ``probe(element)``
        routes to the element's partition, so each probe is the same
        bounded-seek quorum merge it was under full replication.  Returns
        ``(probe, joined clock)``.
        """
        by_pid = {}
        clock = Clock.zero()
        for pid, pset, actors in cover.assignments:
            fn, pclock = self._quorum_probe(pset, actors, repair, stats)
            by_pid[pid] = fn
            clock = clock.join(pclock)

        def probe(element):
            return by_pid[ring.partition(set_name, element)](element)

        return probe, clock

    def _q_join(self, plan, ring: Ring, covers, repair) -> QueryResult:
        """Quorum-merged cross-set join, strategy chosen by the planner.

        Statistics aggregate each side's element range across its covered
        partition replicas (the skew ratio is what the cost model
        compares).  A gallop drives the smaller side's fan-in stream and
        probes the larger side partition-by-partition through the same
        ORSWOT merge rule — probed elements still get read repair, so
        galloping trades only the *incidental* repair of skipped
        non-matches, never correctness.
        """
        cover_l, cover_r = covers
        scope = query_plan.cursor_scope(plan)
        start, after = query_cursor.resume_point(plan.cursor, scope)
        res = QueryResult()
        choice = choose_join(
            plan.kind,
            self._cover_side_stats(cover_l),
            self._cover_side_stats(cover_r),
            forced=plan.strategy)
        res.stats.strategy = choice.strategy
        if choice.strategy == GALLOP:
            drive_name, drive_cover, probe_name, probe_cover = (
                (plan.left, cover_l, plan.right, cover_r)
                if choice.drive == "left"
                else (plan.right, cover_r, plan.left, cover_l))
            drive = self._fan_stream(drive_cover, start, None, after, repair,
                                     stats=res.stats)
            if len(probe_cover.assignments) == 1:
                _pid, pset, actors = probe_cover.assignments[0]
                probe, probe_clock = self._quorum_probe(
                    pset, actors, repair, res.stats)
            else:
                probe, probe_clock = self._fan_probe(
                    probe_name, ring, probe_cover, repair, res.stats)
            res.clock = drive.clock.join(probe_clock)
            entries = gallop_join(plan.kind, drive, probe, choice.drive)
        else:
            left = self._fan_stream(cover_l, start, None, after, repair,
                                    stats=res.stats)
            right = self._fan_stream(cover_r, start, None, after, repair,
                                     stats=res.stats)
            res.clock = left.clock.join(right.clock)
            entries = zipper_join(plan.kind, left, right)
        collect_page(entries, plan.limit, scope, res)
        return res

    def _quorum_probe(self, set_name, actors, repair, stats: QueryStats):
        """Quorum point probe for gallop joins: (probe_fn, joined clock).

        Probes every quorum replica for one element (a bounded seek each),
        merges the surviving dots with the same optimized-OR-set rule the
        streaming merge uses, and read-repairs replicas missing a
        surviving dot — the membership path's semantics, packaged as the
        gallop join's larger-side primitive.
        """
        clocks = [self.vnodes[a].read_clock(set_name) for a in actors]
        probes = [
            ex.element_probe(set_name, stats) for ex in self._executors(actors)
        ]
        clock = Clock.zero()
        for c in clocks:
            clock = clock.join(c)

        def probe(element):
            per_stream = [
                frozenset(ds) if ds else None
                for ds in (p(element) for p in probes)
            ]
            dots = merge_entry(per_stream, clocks)
            if not dots:
                return None
            if repair:
                self._repair(set_name, element, dots, per_stream, clocks,
                             actors)
            return tuple(sorted(dots))

        return probe, clock

    # ------------------------------------------------------------- handoff
    def add_vnode(self, name: Optional[str] = None) -> RingDelta:
        """Join a vnode: mint the next ring epoch and schedule digest
        handoff.

        The returned :class:`RingDelta` names exactly the partitions whose
        ownership moved; each gets a :class:`HandoffTask` per gaining
        owner (digest-ladder pulls pumped by :meth:`tick`) and a
        :class:`RetireTask` per leaving owner (its copy deleted only after
        every gaining owner's clock dominates — invariant 13).  Unmoved
        partitions are untouched: no tasks, no folds, no wire bytes.  The
        old epoch stays serveable for pinned cursors until its transition
        fully retires.
        """
        name = name or f"vnode{len(self.actors)}"
        if name in self.actors:
            raise ValueError(f"{name} already in the ring")
        if self.durable:
            self.media[name] = DurableMedia()
            vn = BigsetVnode(name, store=LsmStore(
                media=self.media[name], group_depth=self.group_depth))
        else:
            vn = BigsetVnode(name)
        self.vnodes[name] = vn
        self.actors.append(name)
        self.n = len(self.actors)
        self.scheduler.actors.append(name)
        old = self.ring
        new = old.with_actors(self.actors)
        self.ring = new
        self._rings[new.epoch] = new
        delta = old.delta_to(new)
        # the newcomer runs every known extractor before any data arrives,
        # so handed-off element deltas derive postings identically
        for set_name, specs in self._index_specs.items():
            for pset in new.storage_sets(set_name):
                for spec in specs.values():
                    vn.register_index(pset, spec, backfill=False)
        handoffs: List[HandoffTask] = []
        retires: List[RetireTask] = []
        for move in delta.moves:
            donors = move.survivors() or move.old_owners
            for set_name in sorted(self._known_sets):
                pset = new.storage_set(set_name, move.pid)
                for dst in move.joined:
                    handoffs.append(HandoffTask(
                        set_name, pset, move.pid, dst=dst, src=donors[0]))
                for leaver in move.left:
                    retires.append(RetireTask(
                        set_name, pset, move.pid, leaver=leaver,
                        waits_on=move.joined or move.new_owners))
                if not new.full_replication:
                    # re-scope the sync baseline to the new preference list
                    self.scheduler.note_set(pset, owners=move.new_owners)
        self._handoffs.extend(handoffs)
        self._retires.extend(retires)
        self._transitions.append((old.epoch, handoffs, retires))
        return delta

    def _promote_hints(self) -> None:
        """Hinted handoff: when a crashed owner returns, its sloppy
        fallback becomes a handoff donor and its copy a retire candidate."""
        for key in list(self._hints):
            pset, fallback, owner = key
            if owner in self.crashed or fallback in self.crashed:
                continue
            set_name, _pset, pid, _fb, _ow = self._hints.pop(key)
            self._handoffs.append(HandoffTask(
                set_name, pset, pid, dst=owner, src=fallback))
            self.scheduler.stats.hints_resolved += 1
            self._add_fallback_retire(set_name, pset, pid, fallback, owner)

    def _add_fallback_retire(self, set_name: bytes, pset: bytes, pid: int,
                             fallback: str, owner: str) -> None:
        if fallback in self.ring.owners(pid):
            return  # became a real owner meanwhile: its copy is not surplus
        for rt in self._retires:
            if rt.pset == pset and rt.leaver == fallback and not rt.done:
                if owner not in rt.waits_on:
                    rt.waits_on = rt.waits_on + (owner,)
                return
        self._retires.append(RetireTask(
            set_name, pset, pid, leaver=fallback, waits_on=(owner,)))

    def _tick_handoff(self) -> int:
        """Pump ring-change handoff: promote resolved hints, drive pending
        digest pulls, retire dominated copies, close finished transitions.

        Each pending task costs one digest pull per tick until the
        destination's clock descends the source's — dropped messages delay
        completion but can never fake it (:func:`handoff_complete`).
        """
        self._promote_hints()
        tr = self.tracer
        started = 0
        pumped: List[HandoffTask] = []
        for t in self._handoffs:
            if t.done:
                continue
            if t.src in self.crashed or t.dst in self.crashed:
                continue
            if handoff_complete(self.vnodes[t.src], self.vnodes[t.dst],
                                t.pset):
                t.done = True
                continue
            with tr.span("handoff.round", set_name=t.set_name, pset=t.pset,
                         pid=t.pid, src=t.src, dst=t.dst):
                self._ae_pull(t.dst, t.src, t.pset)
            self.scheduler.stats.handoff_rounds += 1
            pumped.append(t)
            started += 1
        if self.sync:
            self.settle()
            for t in pumped:
                if handoff_complete(self.vnodes[t.src], self.vnodes[t.dst],
                                    t.pset):
                    t.done = True
        self._tick_retire()
        return started

    def _tick_retire(self) -> None:
        for rt in self._retires:
            if rt.done or rt.leaver in self.crashed:
                continue
            if any(w in self.crashed for w in rt.waits_on):
                continue
            leaver_vn = self.vnodes[rt.leaver]
            if not all(
                    handoff_complete(leaver_vn, self.vnodes[w], rt.pset)
                    for w in rt.waits_on):
                continue
            if self.durable:
                # acknowledged⇒durable across the move: the gaining owners'
                # copies hit the WAL before the leaver's copy disappears
                for w in rt.waits_on:
                    self.vnodes[w].store.sync()
            leaver_vn.drop_set(rt.pset)
            # drop_set only writes storage tombstones; compact so the moved
            # partition's bytes physically leave the retiring replica
            leaver_vn.compact()
            if self.durable:
                leaver_vn.store.sync()
            self.scheduler.stats.handoff_retired += 1
            rt.done = True
        # an old epoch retires once its transition's tasks all completed;
        # pinned cursors then fall forward to the current ring
        still_open = []
        for old_epoch, hts, rts in self._transitions:
            if all(t.done for t in hts) and all(t.done for t in rts):
                self._retired_epochs.add(old_epoch)
            else:
                still_open.append((old_epoch, hts, rts))
        self._transitions = still_open

    # -------------------------------------------------------- anti-entropy
    def tick(self, budget: Optional[int] = None) -> int:
        """Run one scheduler beat: pump scheduled sync rounds through the
        network, then the ring-handoff engine.

        Each round is a bidirectional pull for one (set, replica pair) —
        hottest repair-fed pairs first, then the round-robin baseline.
        Every message (request, reply) rides ``self.net``, so drop/dup/
        reorder semantics apply to anti-entropy exactly as to replication;
        a lost reply simply leaves the pair divergent for a later tick.
        Returns the number of rounds started (scheduled + handoff).
        """
        rounds = self.scheduler.next_rounds(budget)
        tr = self.tracer
        started = 0
        for set_name, a, b in rounds:
            if a in self.crashed or b in self.crashed:
                # a dead member can neither pull nor answer; the scheduler
                # keeps the pair queued for a post-restart tick
                self.scheduler.stats.rounds_crashed += 1
                continue
            with tr.span("ae.round", set_name=set_name, pair=[a, b]):
                self._ae_pull(a, b, set_name)
                self._ae_pull(b, a, set_name)
            self.scheduler.stats.rounds += 1
            started += 1
        if self.sync:
            self.settle()
        started += self._tick_handoff()
        return started

    def _ae_pull(self, dst: str, src: str, set_name: bytes) -> None:
        """``dst`` pulls ``set_name`` from ``src``: request and reply are
        separate network messages (each can drop, duplicate, reorder).

        The request snapshots ``dst``'s digest at send time; the reply is
        built against ``src``'s state at *delivery* time — the same
        at-least-once world replication lives in, which is why
        ``apply_digest_reply`` is idempotent.
        """
        stats = self.scheduler.stats
        tr = self.tracer
        pull_span = (tr.start("ae.pull", set_name=set_name, dst=dst, src=src)
                     if tr.enabled else None)
        vn = self.vnodes[dst]
        req = SyncRequest(set_name, vn.read_clock(set_name),
                          survivors_digest(vn, set_name))
        stats.pulls += 1
        stats.digest_bytes += req.size_bytes()

        def handle_request(src_vn: BigsetVnode) -> None:
            reply = build_digest_reply(
                src_vn, req.set_name, req.clock, req.survivors)
            stats.keys_scanned += reply.keys_scanned
            stats.digest_bytes += reply.digest_bytes()
            stats.payload_bytes += reply.payload_bytes()
            if reply.skipped:
                stats.rounds_skipped += 1
            else:
                stats.rounds_synced += 1
                stats.keys_shipped += len(reply.missing)

            def handle_reply(dst_vn: BigsetVnode) -> None:
                apply_digest_reply(dst_vn, reply)

            reply_payload = (
                TracedPayload(pull_span.context(), handle_reply)
                if pull_span is not None else handle_reply)
            self.net.send(src, dst, reply_payload, reply.size_bytes())

        req_payload = (TracedPayload(pull_span.context(), handle_request)
                       if pull_span is not None else handle_request)
        self.net.send(dst, src, req_payload, req.size_bytes())
        if pull_span is not None:
            # the pull itself is async: the span closes at send time and
            # the request/reply deliveries attach to it by carried context
            tr.finish(pull_span)

    def ae_stats(self) -> AntiEntropyStats:
        """Scheduled anti-entropy cost ledger (sits next to io_stats())."""
        return self.scheduler.stats

    def compact_all(self) -> None:
        for vn in self.vnodes.values():
            vn.compact()

    def io_stats(self):
        from ..storage.lsm import IoStats
        agg = IoStats()
        for vn in self.vnodes.values():
            for k in vars(agg):
                setattr(agg, k, getattr(agg, k) + getattr(vn.store.stats, k))
        return agg


class _QuorumStream:
    """Streaming quorum merge of per-replica visible entry streams.

    Presents the same head/advance/seek_to surface as the executor's
    per-vnode entry stream, so joins compose over quorum-merged sides.
    Memory is bounded: one head entry per replica.  Surviving dots follow
    the optimized-OR-set rule of :func:`repro.core.streaming.merge_entry`;
    per-element per-replica attribution is handed to ``repair_fn`` so the
    cluster can replay missing element-keys (read repair).
    """

    def __init__(self, streams, clocks, repair_fn=None, absent_fn=None):
        self._streams = streams
        self.clocks = clocks
        self._repair = repair_fn
        self._absent = absent_fn
        self.clock = Clock.zero()
        for c in clocks:
            self.clock = self.clock.join(c)
        self.head: Optional[Tuple[bytes, Tuple[Dot, ...]]] = None
        self._pump()

    def advance(self) -> Optional[Tuple[bytes, Tuple[Dot, ...]]]:
        h = self.head
        self._pump()
        return h

    def seek_to(self, element: bytes) -> None:
        if self.head is not None and self.head[0] >= element:
            return
        for s in self._streams:
            s.seek_to(element)
        self._pump()

    def _pump(self) -> None:
        """Advance to the next element that survives the quorum merge."""
        while True:
            heads = [s.head for s in self._streams]
            live = [h[0] for h in heads if h is not None]
            if not live:
                self.head = None
                return
            el = min(live)
            per_stream: List[Optional[frozenset]] = [None] * len(heads)
            for i, s in enumerate(self._streams):
                if s.head is not None and s.head[0] == el:
                    per_stream[i] = frozenset(s.advance()[1])
                elif self._absent is not None:
                    # index streams are ordered by (index_key, element): a
                    # replica absent from THIS posting group may still hold
                    # the element under another index key, so its surviving
                    # dots must join the merge or concurrent dots it has
                    # seen would be wrongly killed (element streams never
                    # need this — absence there means no surviving dots)
                    per_stream[i] = self._absent(i, el)
            dots = merge_entry(per_stream, self.clocks)
            if dots and self._repair is not None:
                self._repair(el, dots, per_stream)
            if dots:
                self.head = (el, tuple(sorted(dots)))
                return


class _FanInStream:
    """Key-ordered fan-in over per-partition quorum streams.

    Partitions split elements disjointly, so this is a pure k-way
    min-by-head interleave: no cross-stream dedup, and no cross-partition
    dot merging — each head was already quorum-merged (and read-repaired)
    inside its own partition's clock domain by its :class:`_QuorumStream`.
    Works for element streams (keys are elements) and index streams (keys
    are ``(index_key, element)`` pairs) alike.  The joined ``clock`` is a
    membership-only view, never a causal context (see
    :meth:`BigsetCluster.read`).
    """

    def __init__(self, streams):
        self._streams = streams
        self.clock = Clock.zero()
        for s in streams:
            self.clock = self.clock.join(s.clock)
        self.head = None
        self._pump()

    def advance(self):
        h = self.head
        self._pump()
        return h

    def seek_to(self, element) -> None:
        if self.head is not None and self.head[0] >= element:
            return
        for s in self._streams:
            s.seek_to(element)
        self._pump()

    def _pump(self) -> None:
        best = None
        for s in self._streams:
            if s.head is not None and (best is None
                                       or s.head[0] < best.head[0]):
                best = s
        self.head = None if best is None else best.advance()
