"""Anti-entropy, handoff, and repair-hit-fed sync scheduling for bigsets.

The paper (§6) defers its anti-entropy design to future work ("key processes
we have developed including anti-entropy and hand-off").  We implement a
correct protocol here, built from the paper's own primitives, and make it
**digest-first and divergence-bounded** in the spirit of join-decomposition
digest sync (Enes et al., "Efficient Synchronization of State-based CRDTs")
applied to the decomposed ORSWOT (Bieniusa et al.).

The digest ladder — a pull of set S by replica A from replica B:

1. A sends ``SyncRequest(SC_A, D_A)``: its set-clock plus its **survivors
   digest** (a clock over the dots of its visible element-keys, maintained
   incrementally by the vnode — see :class:`repro.core.bigset.SetDigest` —
   so reading it never folds).
2. B compares.  ``SC_A == SC_B and D_A == D_B`` means converged: B answers
   with a digest-only skip.  Cost of the whole round: O(causal metadata)
   bytes, **zero element-key folds**.
3. Otherwise B computes ``need = D_B.diff_dots(SC_A)`` — the dots of its
   surviving keys A has never seen — by pure clock subtraction, then folds
   **only** the fenced element subranges whose digest buckets contain a
   needed dot (``vnode.digest_ranges``).  The reply carries those
   (element, dot, value) keys plus ``(SC_B, D_B)``; scan cost tracks the
   diverged subranges, not set cardinality.
4. A applies: each missing key via Algorithm 2 (dot-seen check + append);
   **removal inference** by clock math — every dot in
   ``D_A.diff_dots(D_B)`` that ``SC_B`` has seen was removed at B (B may
   have long since *compacted* the removal away; no tombstone exchange is
   needed, which is what makes subtraction-after-compaction safe) — then
   ``SC_A := SC_A ⊔ SC_B`` and a tombstone trim (also digest-backed,
   O(tombstone), no scan).

Run in both directions (:func:`sync`), the protocol makes both replicas'
read values equal under drop/dup/reorder (tests/test_antientropy.py).
:func:`full_sync` keeps the original full-fold exchange as a baseline, and
:func:`handoff` is that machinery with the ``missing`` filter removed.

**Scheduling.**  Nothing converges unless something *runs* sync.  The
:class:`AntiEntropyScheduler` closes ROADMAP's loop: the query path's read
repair (``BigsetCluster._repair``) reports per-(set, pair) repair hits —
direct evidence two replicas diverge — and the scheduler prioritises those
pairs, decaying scores so quiescent sets cool off, while a round-robin
baseline guarantees replicas *outside* every read quorum still converge.
``BigsetCluster.tick()`` pumps scheduled rounds through the simulated
:class:`~repro.cluster.sim.Network`, so the same drop/dup/reorder property
tests that cover replication cover scheduled anti-entropy.

PyTorch port: a copy of :mod:`repro.cluster.antientropy`; everything below
this docstring is unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..core.bigset import BigsetVnode, InsertDelta
from ..core.clock import Clock
from ..core.dots import Dot


# ------------------------------------------------------------ wire messages
@dataclass
class SyncRequest:
    """Pull opener: the requester's causal state, digest-sized."""

    set_name: bytes
    clock: Clock
    survivors: Clock

    def size_bytes(self) -> int:
        return (len(self.set_name) + self.clock.size_bytes()
                + self.survivors.size_bytes())


@dataclass
class DigestReply:
    """Answer to a :class:`SyncRequest`.

    ``skipped`` means the responder proved convergence from digests alone.
    Otherwise ``missing`` carries exactly the (element, dot, value) keys
    the requester's set-clock has never seen — located by folding only the
    responder's diverged digest subranges (``keys_scanned`` counts that
    fold work).
    """

    set_name: bytes
    clock: Clock
    survivors: Clock
    missing: List[Tuple[bytes, Dot, bytes]] = field(default_factory=list)
    skipped: bool = False
    keys_scanned: int = 0

    def digest_bytes(self) -> int:
        return (len(self.set_name) + self.clock.size_bytes()
                + self.survivors.size_bytes())

    def payload_bytes(self) -> int:
        return sum(len(e) + 16 + len(v) for e, _, v in self.missing)

    def size_bytes(self) -> int:
        return self.digest_bytes() + self.payload_bytes()


@dataclass
class SyncReply:
    """Legacy full-fold reply (:func:`full_sync`, :func:`handoff`)."""

    set_name: bytes
    clock: Clock
    survivors: Clock
    # (element, dot, value): the value rides along so the receiver's
    # replica_insert can re-derive index postings (posting liveness == dot
    # liveness requires the posting's extractor input, not just the key)
    missing: List[Tuple[bytes, Dot, bytes]]

    def size_bytes(self) -> int:
        return (
            self.clock.size_bytes()
            + self.survivors.size_bytes()
            + sum(len(e) + 16 + len(v) for e, _, v in self.missing)
        )


def survivors_digest(vnode: BigsetVnode, set_name: bytes) -> Clock:
    """Clock digest of the dots of all surviving element-keys.

    Delegates to the vnode's maintained :class:`~repro.core.bigset.
    SetDigest` — O(causal metadata), never a fold.  Every protocol below
    uses this one definition, so the digest the scheduler's skip decision
    depends on cannot drift from the digest replies are built from.
    """
    return vnode.survivors_digest(set_name)


# ------------------------------------------------------- digest-first sync
def build_digest_reply(
    vnode: BigsetVnode,
    set_name: bytes,
    remote_clock: Clock,
    remote_survivors: Clock,
) -> DigestReply:
    """Answer a pull: skip when converged, else ship the diverged keys."""
    sc = vnode.read_clock(set_name)
    dig = survivors_digest(vnode, set_name)
    if sc == remote_clock and dig == remote_survivors:
        return DigestReply(set_name, sc, dig, skipped=True)
    need = dig.diff_dots(remote_clock)
    missing: List[Tuple[bytes, Dot, bytes]] = []
    scanned = 0
    if need:
        need_set = set(need)
        for lo, hi in vnode.digest_ranges(set_name, need):
            for element, dot, value in vnode.fold_raw(
                    set_name, start=lo, end=hi):
                scanned += 1
                if dot in need_set:
                    missing.append((element, dot, value))
    return DigestReply(set_name, sc, dig, missing, False, scanned)


def apply_digest_reply(vnode: BigsetVnode, reply: DigestReply) -> int:
    """Apply a pull's reply.  Returns #element-keys written.

    Idempotent under duplicate delivery: inserts dedup on the dot-seen
    check, removal inference re-derives an empty set once the tombstone
    covers the removed dots, and clock joins are joins.
    """
    if reply.skipped:
        return 0
    set_name = reply.set_name
    written = 0
    for element, dot, value in reply.missing:
        if vnode.replica_insert(InsertDelta(set_name, element, dot,
                                            value=value)):
            written += 1
    # removal inference by digest subtraction: surviving here, seen but not
    # surviving at the peer -> the peer removed it (no fold, no tombstone
    # exchange; safe even after the peer compacted the removal away).
    # Pure run merges: (mine \ peer-survivors) ∩ peer-clock, O(runs).
    mine = survivors_digest(vnode, set_name)
    removed = mine.subtract_clock(reply.survivors).intersect(reply.clock)
    sc0 = vnode.read_clock(set_name)
    sc = sc0.join(reply.clock)
    ts0 = vnode.read_tombstone(set_name)
    ts = ts0.add_runs(removed.iter_runs())
    if sc != sc0 or ts is not ts0:
        from ..core.bigset import clock_key, tombstone_key, _clock_to_bytes

        vnode.store.put_batch(
            [
                (clock_key(set_name), _clock_to_bytes(sc)),
                (tombstone_key(set_name), _clock_to_bytes(ts)),
            ]
        )
    if ts is not ts0:
        trim_tombstone(vnode, set_name)
    return written


def sync_pull(dst: BigsetVnode, src: BigsetVnode, set_name: bytes
              ) -> DigestReply:
    """One direction of the digest ladder: ``dst`` pulls from ``src``."""
    reply = build_digest_reply(
        src, set_name, dst.read_clock(set_name),
        survivors_digest(dst, set_name))
    apply_digest_reply(dst, reply)
    return reply


def sync(a: BigsetVnode, b: BigsetVnode, set_name: bytes) -> None:
    """Bidirectional digest-first sync of one set between two replicas.

    Converged pairs cost O(causal metadata) — digest bytes only, zero
    element-key folds; diverged pairs fold only the diverged subranges.
    """
    sync_pull(a, b, set_name)
    sync_pull(b, a, set_name)


# ------------------------------------------------------- legacy full sync
def build_reply(
    vnode: BigsetVnode, set_name: bytes, remote_clock: Clock
) -> SyncReply:
    """Full-fold reply: every surviving key unseen by ``remote_clock``."""
    missing = [
        (element, dot, value)
        for element, dot, value in vnode.fold_values(set_name)
        if not remote_clock.seen(dot)
    ]
    return SyncReply(set_name, vnode.read_clock(set_name),
                     survivors_digest(vnode, set_name), missing)


def apply_reply(vnode: BigsetVnode, reply: SyncReply) -> int:
    """Apply a sync reply at the requesting replica.  Returns #keys written.

    One raw fold computes *both* removal inference and the tombstone
    backing trim needs (it used to take two more full scans), and the trim
    is skipped outright when the tombstone did not change.
    """
    set_name = reply.set_name
    written = 0
    for element, dot, value in reply.missing:
        if vnode.replica_insert(InsertDelta(set_name, element, dot,
                                            value=value)):
            written += 1
    ts0 = vnode.read_tombstone(set_name)
    removed: List[Dot] = []
    backed: Set[Dot] = set()
    for _element, dot, _v in vnode.fold_raw(set_name):
        if ts0.seen(dot):
            backed.add(dot)      # covered key still on disk backs its dot
        elif reply.clock.seen(dot) and not reply.survivors.seen(dot):
            removed.append(dot)  # surviving here, removed at the peer
            backed.add(dot)      # the key we are tombstoning backs it
    sc = vnode.read_clock(set_name).join(reply.clock)
    ts = ts0.add_dots(removed)
    from ..core.bigset import clock_key, tombstone_key, _clock_to_bytes

    vnode.store.put_batch(
        [
            (clock_key(set_name), _clock_to_bytes(sc)),
            (tombstone_key(set_name), _clock_to_bytes(ts)),
        ]
    )
    if ts is not ts0:
        trim_tombstone(vnode, set_name, backed=backed)
    return written


def trim_tombstone(vnode: BigsetVnode, set_name: bytes,
                   backed: Optional[Set[Dot]] = None) -> int:
    """Subtract tombstone dots that no longer shadow any element-key.

    ``backed`` (the dots known to have physical keys) can be handed in by
    a caller that just folded; otherwise backing comes from the vnode's
    maintained raw digest.  Either way the trim is a run intersection —
    O(tombstone runs), no scan, no per-dot enumeration.

    Returns the number of tombstone *events* trimmed.
    """
    ts = vnode.read_tombstone(set_name)
    if ts.is_zero():
        return 0
    if backed is None:
        backing = vnode._digest(set_name).raw_total()
    else:
        backing = Clock.zero().add_dots(backed)
    trimmed = ts.intersect(backing)
    if trimmed == ts:
        return 0
    from ..core.bigset import tombstone_key, _clock_to_bytes

    vnode.store.put(tombstone_key(set_name), _clock_to_bytes(trimmed))
    return ts.n_events() - trimmed.n_events()


def full_sync(a: BigsetVnode, b: BigsetVnode, set_name: bytes) -> None:
    """Bidirectional *full-fold* sync — the pre-digest baseline.

    Semantically identical to :func:`sync`; costs two O(n) element folds
    per direction regardless of divergence (it used to be three before
    ``apply_reply`` fused inference and trim backing).  Kept for
    benchmarks and as the simplest statement of the protocol.
    """
    apply_reply(a, build_reply(b, set_name, a.read_clock(set_name)))
    apply_reply(b, build_reply(a, set_name, b.read_clock(set_name)))


def handoff(src: BigsetVnode, dst: BigsetVnode, set_name: bytes) -> int:
    """Transfer a set to a new owner (ring change): sync with empty clock.

    The full-fold baseline.  Scheduled ring-change handoff uses the
    digest ladder instead (:class:`HandoffTask` pulls pumped by
    ``BigsetCluster.tick``), which ships only what the new owner's clock
    has not seen — for a fresh owner that is everything, but for a
    crash-restarted or partially-caught-up owner it is the diverged tail.
    """
    reply = build_reply(src, set_name, Clock.zero())
    return apply_reply(dst, reply)


# ----------------------------------------------------------- ring handoff
@dataclass
class HandoffTask:
    """One digest-ladder pull a ring change requires: ``dst`` (a gaining
    owner) pulls partition-set ``pset`` from ``src`` (a surviving old
    owner, or the leaver itself when nobody else holds the partition).

    ``done`` flips once :func:`handoff_complete` proves domination — the
    pull is re-scheduled every tick until then, so dropped request or
    reply messages only delay completion, never lose it.
    """

    set_name: bytes   # logical set (for spans / stats attribution)
    pset: bytes       # partition storage set being moved
    pid: int
    dst: str
    src: str
    done: bool = False


@dataclass
class RetireTask:
    """Retire ``leaver``'s copy of ``pset`` once every vnode in
    ``waits_on`` (the partition's gaining owners — or, when nobody
    joined, its surviving owners) causally dominates the leaver.

    Domination means the waiter's set-clock descends the leaver's: every
    dot the leaver acknowledged is either a surviving key at the waiter
    or was legitimately removed there — deleting the leaver's copy can
    lose nothing (invariant 13).
    """

    set_name: bytes
    pset: bytes
    pid: int
    leaver: str
    waits_on: Tuple[str, ...]
    done: bool = False


def handoff_complete(src: BigsetVnode, dst: BigsetVnode,
                     set_name: bytes) -> bool:
    """Has ``dst`` causally caught up with ``src`` for ``set_name``?

    Clock descent is the whole check: the digest ladder joins ``src``'s
    set-clock into ``dst``'s with the reply, so descent certifies every
    dot ``src`` ever acknowledged is accounted for at ``dst`` (present,
    or removed by an observed remove).  O(causal metadata), no fold.
    """
    return dst.read_clock(set_name).descends(src.read_clock(set_name))


# ------------------------------------------------------------- scheduling
@dataclass
class AntiEntropyStats:
    """Cost ledger of scheduled anti-entropy, surfaced by
    ``BigsetCluster.ae_stats()`` next to ``io_stats()``.

    Counters are message-level events, so at-least-once delivery (dup
    networks) can count a pull's reply twice — the ledger reflects work
    actually performed, which is what the cost claims are about.
    """

    rounds: int = 0           # pair rounds scheduled (two pulls each)
    pulls: int = 0            # pull requests sent
    rounds_skipped: int = 0   # pulls answered "already converged"
    rounds_synced: int = 0    # pulls whose reply shipped keys / clocks
    digest_bytes: int = 0     # clock + survivors-digest wire volume
    payload_bytes: int = 0    # (element, dot, value) wire volume
    keys_shipped: int = 0     # element-keys replayed by anti-entropy
    keys_scanned: int = 0     # raw keys folded locating diverged subranges
    repair_hits: int = 0      # read-repair replays observed by the query path
    repair_misses: int = 0    # quorum checks where every replica had the dot
    repair_no_donor: int = 0  # repairs skipped: no replica could supply a value
    rounds_crashed: int = 0   # rounds not attempted: a member was crashed
    handoff_rounds: int = 0   # ring-change digest pulls pumped by tick()
    handoff_retired: int = 0  # partition copies retired after domination
    hints_recorded: int = 0   # sloppy writes parked on a fallback vnode
    hints_resolved: int = 0   # hints promoted to handoff pulls (owner back)


class AntiEntropyScheduler:
    """Repair-hit-fed prioritisation of (set, replica-pair) sync rounds.

    The query path's read repair is a free divergence detector: every
    element-key it replays names a set and a replica pair that demonstrably
    disagree.  ``record_repair_hit`` bumps that pair's score;
    ``next_rounds`` drains the hottest pairs first and *decays* all scores,
    so sets that stop missing data stop being synced.  A round-robin
    baseline over every known (set, pair) — ``baseline`` rounds per tick —
    guarantees replicas outside every read quorum converge too.
    """

    def __init__(self, actors: Iterable[str], decay: float = 0.5,
                 baseline: int = 1, hot_threshold: float = 0.5):
        self.actors = list(actors)
        self.decay = decay
        self.baseline = baseline
        self.hot_threshold = hot_threshold
        self.stats = AntiEntropyStats()
        self._scores: Dict[Tuple[bytes, Tuple[str, str]], float] = {}
        self._sets: List[bytes] = []
        self._known: Set[bytes] = set()
        # per-set owner lists (partitioned placement): a partition set only
        # syncs among its preference list, never across the whole cluster
        self._owners: Dict[bytes, Tuple[str, ...]] = {}
        self._rr = 0

    # ------------------------------------------------------------- signals
    def note_set(self, set_name: bytes,
                 owners: Optional[Iterable[str]] = None) -> None:
        """Register a set for the round-robin baseline (cluster write path).

        ``owners`` scopes the set's sync pairs to its preference list;
        omitted (the full-replication default), every actor pair gossips
        the set.  Re-noting with new owners (a ring change) re-scopes the
        pairs, so retired owners stop being synced against.
        """
        if set_name not in self._known:
            self._known.add(set_name)
            self._sets.append(set_name)
        if owners is not None:
            self._owners[set_name] = tuple(owners)

    def record_repair_hit(self, set_name: bytes, target: str,
                          donor: str) -> None:
        """A read repair replayed a key from ``donor`` to ``target``."""
        self.note_set(set_name)
        self.stats.repair_hits += 1
        key = (set_name, self._pair(target, donor))
        self._scores[key] = self._scores.get(key, 0.0) + 1.0

    def record_repair_miss(self, set_name: bytes) -> None:
        self.stats.repair_misses += 1

    def record_no_donor(self, set_name: bytes) -> None:
        self.stats.repair_no_donor += 1

    # ----------------------------------------------------------- schedule
    @staticmethod
    def _pair(a: str, b: str) -> Tuple[str, str]:
        return (a, b) if a <= b else (b, a)

    def _all_pairs(self) -> List[Tuple[str, str]]:
        return [
            (a, b)
            for i, a in enumerate(self.actors)
            for b in self.actors[i + 1:]
        ]

    def _pairs_for(self, set_name: bytes) -> List[Tuple[str, str]]:
        owners = self._owners.get(set_name)
        if owners is None:
            return self._all_pairs()
        owners = sorted(owners)
        return [
            (a, b)
            for i, a in enumerate(owners)
            for b in owners[i + 1:]
        ]

    def hot_pairs(self) -> List[Tuple[bytes, Tuple[str, str], float]]:
        """(set, pair, score) above threshold, hottest first."""
        hot = [(k[0], k[1], s) for k, s in self._scores.items()
               if s >= self.hot_threshold]
        hot.sort(key=lambda t: (-t[2], t[0], t[1]))
        return hot

    def next_rounds(self, budget: Optional[int] = None
                    ) -> List[Tuple[bytes, str, str]]:
        """Drain up to ``budget`` (set, a, b) rounds; decay all scores.

        Default budget: every hot pair plus ``baseline`` round-robin
        rounds, so a quiescent cluster still gossips slowly and a hot one
        is serviced fully.
        """
        hot = self.hot_pairs()
        if budget is None:
            budget = len(hot) + self.baseline
        rounds: List[Tuple[bytes, str, str]] = []
        chosen: Set[Tuple[bytes, Tuple[str, str]]] = set()
        for set_name, pair, _score in hot:
            if len(rounds) >= budget:
                break
            rounds.append((set_name, pair[0], pair[1]))
            chosen.add((set_name, pair))
        universe = [(s, p) for s in self._sets for p in self._pairs_for(s)]
        for _ in range(len(universe)):
            if len(rounds) >= budget:
                break
            s, p = universe[self._rr % len(universe)]
            self._rr += 1
            if (s, p) in chosen:
                continue
            rounds.append((s, p[0], p[1]))
            chosen.add((s, p))
        self._scores = {
            k: v * self.decay
            for k, v in self._scores.items()
            if v * self.decay >= 0.05
        }
        return rounds
