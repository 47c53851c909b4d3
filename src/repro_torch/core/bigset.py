"""Bigset — the paper's decomposed delta CRDT Set (§4, Algorithms 1 & 2).

A bigset vnode stores, per set, in one ordered KV store:

* ``(set, KIND_CLOCK)``      -> serialized set-clock (BaseVV + DotCloud)
* ``(set, KIND_TOMBSTONE)``  -> serialized set-tombstone
* ``(set, KIND_ELEMENT, element, actor, counter)`` -> b""   (one per insert)
* ``(set, KIND_INDEX, index_name, index_key, element, actor, counter)``
  -> b""  (secondary-index postings; see :mod:`repro.index`)

Writes read **only the clocks** (O(causal metadata)), append element keys —
plus one posting per registered-index key, derived deterministically from
(element, value) so replicas rebuild them from the delta — and ship the
element-key as the replication delta.  Removes are clock-only (no element
or index writes).  Compaction (storage hook) discards element-keys *and*
postings covered by the tombstone in the same pass and then subtracts the
discarded element dots so the tombstone shrinks (§4.3.3).  Reads are a
streaming fold over the element-key range in lexicographic element order,
which also enables membership/range queries and the §4.4 streaming join.

PyTorch port: a copy of :mod:`repro.core.bigset`; everything below
this docstring is unchanged except its ``# bigset-lint: disable=BS003``
escapes.  They serve the reference's linter (``python -m repro.analysis
src``, CI's lint job), which finds no layer under ``src/repro_torch/`` and
so takes this ``core/`` for another layer.  The port's linter
(``python -m repro_torch.analysis``) scopes it as ``core/``, BS003's home,
and reads only ``# bigset-lint-torch:`` escapes.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, Iterator, List, Optional, Tuple

import msgpack

from ..index.postings import (decode_posting_key, index_bounds, index_range,
                              posting_key)
from ..index.spec import IndexSpec
from ..storage.keycodec import (KIND_CLOCK, KIND_ELEMENT, KIND_INDEX,
                                KIND_TOMBSTONE, decode_key, encode_key)
from ..storage.lsm import TOMBSTONE as STORE_TOMBSTONE
from ..storage.lsm import LsmIterator, LsmStore
from .clock import Clock
from .dots import ActorId, Dot, dot_from_key
from .orswot import Orswot


# ------------------------------------------------------------------ codecs
def _clock_to_bytes(c: Clock) -> bytes:
    """Run-length clock codec: ``{"b": base VV, "r": interval runs}``.

    O(runs) on the wire regardless of how many events each run spans.
    """
    return msgpack.packb(c.to_obj())


def _clock_from_bytes(b: Optional[bytes]) -> Clock:
    """Decode a ``KIND_CLOCK``/``KIND_TOMBSTONE`` payload.

    Accepts both the run-length codec and the legacy per-dot ``{"b", "c"}``
    cloud form, so records written before the interval refactor (including
    WAL-replayed state) still decode and round-trip through recovery.
    """
    if b is None:
        return Clock.zero()
    o = msgpack.unpackb(b, strict_map_key=False)
    return Clock.from_obj(o)


def clock_key(set_name: bytes) -> bytes:
    return encode_key((set_name, KIND_CLOCK))

def tombstone_key(set_name: bytes) -> bytes:
    return encode_key((set_name, KIND_TOMBSTONE))

def element_key(set_name: bytes, element: bytes, dot: Dot) -> bytes:
    return encode_key((set_name, KIND_ELEMENT, element, dot.actor, dot.counter))

def element_range(set_name: bytes) -> Tuple[bytes, bytes]:
    lo = encode_key((set_name, KIND_ELEMENT))
    hi = encode_key((set_name, KIND_ELEMENT + 1))
    return lo, hi

def decode_element_key(key: bytes) -> Tuple[bytes, bytes, Dot]:
    parts = decode_key(key)
    if len(parts) != 5 or parts[1] != KIND_ELEMENT:
        # a real exception, not an assert: under ``python -O`` an assert
        # vanishes and a clock/tombstone/posting key would silently decode
        # into a garbage Dot
        raise ValueError(f"not an element key: {parts!r}")
    set_name, _kind, element, _actor, _counter = parts
    return set_name, element, _dot_from_parts(parts)


def _dot_from_parts(parts: Tuple) -> Dot:
    """The trailing ``(actor, counter)`` of an element or posting key."""
    return dot_from_key(parts[-2], parts[-1])


def element_bounds(
    set_name: bytes,
    start: Optional[bytes] = None,
    end: Optional[bytes] = None,
    after: Optional[bytes] = None,
) -> Tuple[bytes, bytes]:
    """Encoded key bounds for the element range ``[start, end)`` of a set.

    ``after`` seeks *strictly past* every key of that element (cursor
    resumption): in the order-preserving codec ``element + b"\\x00"`` is the
    immediate successor element, so its encoded prefix upper-bounds all of
    ``after``'s keys.  ``after`` wins over ``start`` when both are given.
    """
    if after is not None:
        lo = encode_key((set_name, KIND_ELEMENT, after + b"\x00"))
    elif start is not None:
        lo = encode_key((set_name, KIND_ELEMENT, start))
    else:
        lo = encode_key((set_name, KIND_ELEMENT))
    if end is not None:
        hi = encode_key((set_name, KIND_ELEMENT, end))
    else:
        hi = encode_key((set_name, KIND_ELEMENT + 1))
    return lo, hi


# ------------------------------------------------------------------ deltas
@dataclass(frozen=True)
class InsertDelta:
    """The replicated delta for an insert: the new element-key + op context.

    ``value`` rides along with the key (empty for plain sets; checkpoint
    shards store their tensor bytes here — the CRDT governs key liveness,
    the value is immutable payload under that key).
    """

    set_name: bytes
    element: bytes
    dot: Dot
    ctx: Tuple[Dot, ...] = ()
    value: bytes = b""

    def size_bytes(self) -> int:
        return (len(self.set_name) + len(self.element) + 16
                + 16 * len(self.ctx) + len(self.value))


@dataclass(frozen=True)
class RemoveDelta:
    """The replicated delta for a remove: context dots only (clock-sized)."""

    set_name: bytes
    ctx: Tuple[Dot, ...]

    def size_bytes(self) -> int:
        return len(self.set_name) + 16 * len(self.ctx)


Delta = InsertDelta  # union alias for typing docs; removes use RemoveDelta


# ------------------------------------------------------------ element cursor
class ElementCursor:
    """Positional ``(element, dot, value)`` cursor over one set's element
    range.

    Wraps a :class:`~repro.storage.lsm.LsmIterator`: iterating streams
    decoded element-keys in order; :meth:`seek` repositions at the first
    key of ``element`` in O(log n) per level.  Keys skipped by a seek are
    never touched — no ``bytes_read``, no scan work — which is what makes
    a gallop join's probes cost O(probe), not O(gap).
    """

    __slots__ = ("_set", "_it")

    def __init__(
        self,
        store: LsmStore,
        set_name: bytes,
        start: Optional[bytes] = None,
        end: Optional[bytes] = None,
        after: Optional[bytes] = None,
    ):
        self._set = set_name
        lo, hi = element_bounds(set_name, start, end, after)
        self._it = LsmIterator(store, lo, hi)

    def seek(self, element: bytes) -> None:
        """Reposition at the first key of ``element`` (or the next one)."""
        self._it.seek(encode_key((self._set, KIND_ELEMENT, element)))

    def __iter__(self) -> "ElementCursor":
        return self

    def __next__(self) -> Tuple[bytes, Dot, bytes]:
        k, v = next(self._it)
        _s, element, dot = decode_element_key(k)
        return element, dot, v


# ------------------------------------------------------------- set digests
class SetDigest:
    """Incrementally maintained digest of one set's *physical* element-keys.

    Two structures, both fed by the write path (never by folds):

    * a **total** raw digest — a :class:`~repro.core.clock.Clock` over the
      dots of every element-key physically in storage (tombstone-covered or
      not).  Updates are buffered and applied lazily, so a write costs one
      list append and a digest read after ``w`` writes costs one batched
      ``add_dots``/``subtract`` — O(w + causal metadata), never a fold.
    * **subrange buckets** — the element keyspace fenced into contiguous
      subranges, each holding the mutable dot-set of its keys.  A bucket
      that outgrows ``bucket_limit`` is split at its median element
      (B-tree style, amortised O(log) per key), so locating the element
      range that holds any given dot set stays bounded: anti-entropy folds
      only the subranges whose buckets intersect the diverged dots.

    The **survivors digest** (dots of keys *visible* under the tombstone —
    the anti-entropy currency) is derived on demand: ``raw − (ts ∩ raw)``,
    O(tombstone) clock math.  Compaction keeps the tombstone small
    (invariant 3), so this is causal-metadata-sized in steady state.

    Memory: the total digest compresses contiguous runs into the base VV;
    buckets cannot (a bucket sees an element-ordered, hence dot-scattered,
    slice) and cost O(keys) ints overall — the in-memory analogue of
    Riak's on-disk AAE hashtree.
    """

    __slots__ = ("bucket_limit", "fences", "buckets", "counts", "limits",
                 "_total", "_pend_add", "_pend_sub", "_surv")

    def __init__(self, bucket_limit: int = 2048):
        self.bucket_limit = bucket_limit  # bigset-lint: disable=BS003 -- this is the port's own core/ layer
        self.fences: List[bytes] = []        # element boundaries, sorted  # bigset-lint: disable=BS003 -- this is the port's own core/ layer
        self.buckets: List[Dict[ActorId, set]] = [{}]  # bigset-lint: disable=BS003 -- this is the port's own core/ layer
        self.counts: List[int] = [0]  # bigset-lint: disable=BS003 -- this is the port's own core/ layer
        # per-bucket split thresholds: raised (backoff) when a bucket turns
        # out to be un-splittable — all keys one element — so it is not
        # re-folded on every subsequent write
        self.limits: List[int] = [bucket_limit]  # bigset-lint: disable=BS003 -- this is the port's own core/ layer
        self._total: Clock = Clock.zero()  # bigset-lint: disable=BS003 -- this is the port's own core/ layer
        self._pend_add: List[Dot] = []  # bigset-lint: disable=BS003 -- this is the port's own core/ layer
        self._pend_sub: List[Dot] = []  # bigset-lint: disable=BS003 -- this is the port's own core/ layer
        # (raw, tombstone, survivors) of the last survivors() computation
        self._surv: Optional[Tuple[Clock, Clock, Clock]] = None  # bigset-lint: disable=BS003 -- this is the port's own core/ layer

    # ------------------------------------------------------------- updates
    def _bucket_of(self, element: bytes) -> int:
        return bisect.bisect_right(self.fences, element)

    def add(self, element: bytes, dot: Dot) -> Optional[int]:
        """Record a written element-key.  Returns a bucket index to split
        (caller folds that subrange and calls :meth:`split`) or None.

        Idempotent: re-adding a dot already in its bucket (store adoption
        racing a split's disk fold) never double-counts.
        """
        i = self._bucket_of(element)
        s = self.buckets[i].setdefault(dot.actor, set())
        if dot.counter in s:
            # a split's disk fold placed it in the bucket already, but the
            # total may not have it yet (adoption reaches keys the fold ran
            # ahead of) — add_dots is idempotent, so always feed the total
            self._pend_add.append(dot)
            return None
        s.add(dot.counter)
        self.counts[i] += 1  # bigset-lint: disable=BS003 -- this is the port's own core/ layer
        self._pend_add.append(dot)
        return i if self.counts[i] > self.limits[i] else None

    def discard(self, element: bytes, dot: Dot) -> None:
        """Record a compaction-discarded element-key."""
        i = self._bucket_of(element)
        s = self.buckets[i].get(dot.actor)
        if s is not None and dot.counter in s:
            s.remove(dot.counter)
            if not s:
                del self.buckets[i][dot.actor]
            self.counts[i] -= 1  # bigset-lint: disable=BS003 -- this is the port's own core/ layer
            self._pend_sub.append(dot)

    def bucket_bounds(self, i: int) -> Tuple[Optional[bytes], Optional[bytes]]:
        """Element-range ``[lo, hi)`` of bucket ``i`` (None = unbounded)."""
        lo = self.fences[i - 1] if i > 0 else None
        hi = self.fences[i] if i < len(self.fences) else None
        return lo, hi

    def split(self, i: int, items: List[Tuple[bytes, Dot]]) -> bool:
        """Split bucket ``i`` at the median element of its folded ``items``.

        ``items`` is the (element, dot) list of every physical key in the
        bucket's range, in element order.  When every key shares one
        element there is nothing to fence on: the bucket's split threshold
        doubles instead (backoff), so hot single-element buckets — e.g. a
        shard re-saved thousands of times between compactions — are not
        re-folded on every write.  Returns whether a fence was added.
        """
        if not items:
            return False
        mid = items[len(items) // 2][0]
        if mid == items[0][0]:
            # median equals the low edge: fence at the next element change
            for el, _d in items:
                if el > mid:
                    mid = el
                    break
            else:
                self.limits[i] = max(self.counts[i], self.limits[i]) * 2  # bigset-lint: disable=BS003 -- this is the port's own core/ layer
                return False
        left: Dict[ActorId, set] = {}
        right: Dict[ActorId, set] = {}
        n_left = 0
        for el, d in items:
            tgt = left if el < mid else right
            tgt.setdefault(d.actor, set()).add(d.counter)
            if el < mid:
                n_left += 1
        self.fences.insert(i, mid)
        self.buckets[i: i + 1] = [left, right]  # bigset-lint: disable=BS003 -- this is the port's own core/ layer
        self.counts[i: i + 1] = [n_left, len(items) - n_left]  # bigset-lint: disable=BS003 -- this is the port's own core/ layer
        self.limits[i: i + 1] = [self.bucket_limit, self.bucket_limit]  # bigset-lint: disable=BS003 -- this is the port's own core/ layer
        return True

    # --------------------------------------------------------------- reads
    def raw_total(self) -> Clock:
        """Digest of every physical element-key's dot (pending applied)."""
        if self._pend_add:
            self._total = self._total.add_dots(self._pend_add)  # bigset-lint: disable=BS003 -- this is the port's own core/ layer
            self._pend_add = []  # bigset-lint: disable=BS003 -- this is the port's own core/ layer
        if self._pend_sub:
            self._total = self._total.subtract(self._pend_sub)  # bigset-lint: disable=BS003 -- this is the port's own core/ layer
            self._pend_sub = []  # bigset-lint: disable=BS003 -- this is the port's own core/ layer
        return self._total

    def survivors(self, tombstone: Clock) -> Clock:
        """Digest of *visible* element-key dots: raw minus ts-covered.

        An O(runs) run-difference (:meth:`Clock.subtract_clock`) — never a
        per-dot enumeration.  Computed only when the state actually
        changed: the result is cached against (raw identity, tombstone
        equality), and anti-entropy reads this several times per round per
        set, all between state changes.
        """
        raw = self.raw_total()
        if tombstone.is_zero():
            return raw
        cached = self._surv
        if cached is not None and cached[0] is raw and cached[1] == tombstone:
            return cached[2]
        out = raw.subtract_clock(tombstone)
        self._surv = (raw, tombstone, out)  # bigset-lint: disable=BS003 -- this is the port's own core/ layer
        return out

    def ranges_containing(
        self, dots: Iterable[Dot]
    ) -> List[Tuple[Optional[bytes], Optional[bytes]]]:
        """Coalesced element ranges of the buckets holding any of ``dots``.

        This is the location half of divergence-bounded sync: the caller
        folds only these subranges instead of the whole set.
        """
        want = list(dots)
        hit: List[int] = []
        for i, bucket in enumerate(self.buckets):
            for d in want:
                s = bucket.get(d.actor)
                if s is not None and d.counter in s:
                    hit.append(i)
                    break
        out: List[Tuple[Optional[bytes], Optional[bytes]]] = []
        for i in hit:
            lo, hi = self.bucket_bounds(i)
            if out and out[-1][1] is not None and out[-1][1] == lo:
                out[-1] = (out[-1][0], hi)  # adjacent buckets: one fold
            else:
                out.append((lo, hi))
        return out

    def key_count(self) -> int:
        return sum(self.counts)


# ---------------------------------------------------------------- the vnode
class BigsetVnode:
    """One replica (vnode) hosting many bigsets in a single ordered store."""

    def __init__(self, actor: ActorId, store: Optional[LsmStore] = None,
                 digest_bucket_limit: int = 2048):
        self.actor = actor
        # `store or LsmStore()` would silently discard an injected *empty*
        # store (LsmStore defines __len__, and a fresh store is falsy) —
        # fatal for durable stores injected before their first write
        self.store = store if store is not None else LsmStore()
        self.store.compaction_filter = self._compaction_filter
        self.store.on_discard = self._on_discard
        self._discarded: Dict[bytes, List[Dot]] = {}
        self._ts_cache: Dict[bytes, Clock] = {}  # valid only within one compaction
        self._indexes: Dict[bytes, Dict[bytes, IndexSpec]] = {}
        # per-set maintained digests of physical element-keys (anti-entropy
        # reads these instead of folding; see SetDigest)
        self._digests: Dict[bytes, SetDigest] = {}
        self._digest_bucket_limit = digest_bucket_limit

    # -------------------------------------------------------------- digests
    def _fold_background(
        self, lo: bytes, hi: bytes
    ) -> List[Tuple[bytes, bytes]]:
        """Raw scan metered as *background* volume (``bytes_compacted``).

        Digest maintenance (adoption of a pre-populated store, bucket
        splits) reads element-keys the way compaction does — as background
        upkeep, not foreground query IO — so it must not pollute the
        foreground ``bytes_read``/``num_seeks`` the paper's cost claims are
        asserted against.
        """
        st = self.store.stats
        seeks0, read0 = st.num_seeks, st.bytes_read
        items = list(self.store.seek(lo, hi))
        st.num_seeks = seeks0
        st.bytes_compacted += st.bytes_read - read0
        st.bytes_read = read0
        return items

    def _digest(self, set_name: bytes) -> SetDigest:
        """The set's maintained digest, adopting pre-existing keys once.

        All write paths in this repo create keys through this vnode, so in
        practice adoption sees an empty range and the digest is maintained
        incrementally from the set's first insert — zero folds ever.  A
        vnode handed an already-populated store pays one background fold
        here and is exact from then on.
        """
        dig = self._digests.get(set_name)
        if dig is None:
            dig = SetDigest(self._digest_bucket_limit)
            self._digests[set_name] = dig
            lo, hi = element_range(set_name)
            for k, _v in self._fold_background(lo, hi):
                _s, element, dot = decode_element_key(k)
                self._digest_add(dig, set_name, element, dot)
        return dig

    def _digest_add(self, dig: SetDigest, set_name: bytes, element: bytes,
                    dot: Dot) -> None:
        overflow = dig.add(element, dot)
        if overflow is not None:
            b_lo, b_hi = dig.bucket_bounds(overflow)
            lo, hi = element_bounds(set_name, start=b_lo, end=b_hi)
            items = []
            for k, _v in self._fold_background(lo, hi):
                _s, el, d = decode_element_key(k)
                items.append((el, d))
            dig.split(overflow, items)

    def survivors_digest(self, set_name: bytes) -> Clock:
        """Clock digest of the dots of all surviving element-keys.

        O(causal metadata): derived from the maintained digest, never a
        fold.  This is the anti-entropy currency — two replicas whose
        set-clocks and survivors digests match are converged.
        """
        return self._digest(set_name).survivors(self.read_tombstone(set_name))

    def digest_ranges(
        self, set_name: bytes, dots: Iterable[Dot]
    ) -> List[Tuple[Optional[bytes], Optional[bytes]]]:
        """Element subranges whose keys could carry any of ``dots``.

        The divergence-bounded sync primitive: a peer that needs specific
        dots folds only these fenced subranges, so sync scan cost tracks
        the diverged subranges, not set cardinality.
        """
        return self._digest(set_name).ranges_containing(dots)

    # ------------------------------------------------------------ sec. indexes
    def register_index(
        self, set_name: bytes, spec: IndexSpec, backfill: bool = True
    ) -> int:
        """Register a secondary index on one set; returns postings written.

        Extractors must be registered identically on every replica (they run
        downstream too).  ``backfill`` reconciles the index's posting range
        against every element-key already in storage — including
        tombstone-covered ones, preserving the invariant that a posting
        exists exactly for the element-keys that physically exist, so both
        compact away in the same pass.  Reconciliation makes re-registration
        "last wins" for real: postings a previous extractor produced that
        the new one does not are storage-deleted (their dots are live, so
        no tombstone would ever discard them), and re-registering the same
        extractor is a no-op.
        """
        self._indexes.setdefault(set_name, {})[spec.name] = spec
        if not backfill:
            return 0
        lo, hi = index_range(set_name, spec.name)
        stale = {k for k, _ in self.store.seek(lo, hi)}
        fresh: List[Tuple[bytes, bytes]] = []
        for element, dot, value in self.fold_raw(set_name):
            for ik in spec.keys(element, value):
                k = posting_key(set_name, spec.name, ik, element, dot)
                if k in stale:
                    stale.discard(k)  # already correct under this extractor
                else:
                    fresh.append((k, b""))
        batch = fresh + [(k, STORE_TOMBSTONE) for k in sorted(stale)]
        if batch:
            self.store.put_batch(batch)
        return len(fresh)

    def indexes(self, set_name: bytes) -> Tuple[IndexSpec, ...]:
        return tuple(self._indexes.get(set_name, {}).values())

    def _posting_writes(
        self, set_name: bytes, element: bytes, dot: Dot, value: bytes
    ) -> List[Tuple[bytes, bytes]]:
        specs = self._indexes.get(set_name)
        if not specs:
            return []
        return [
            (posting_key(set_name, spec.name, ik, element, dot), b"")
            for spec in specs.values()
            for ik in spec.keys(element, value)
        ]

    def fold_postings(
        self,
        set_name: bytes,
        index_name: bytes,
        start: Optional[bytes] = None,
        end: Optional[bytes] = None,
        at: Optional[Tuple[bytes, bytes]] = None,
        after: Optional[Tuple[bytes, bytes]] = None,
    ) -> Iterator[Tuple[bytes, bytes, Dot]]:
        """Unfiltered ``(index_key, element, dot)`` posting stream.

        The index analogue of :meth:`fold_raw`: a storage seek to the first
        relevant posting (or a ``(index_key, element)`` cursor boundary via
        ``at``/``after``) plus a bounded lazy scan.  Tombstone visibility is
        applied by the query executor's batched dot filter, exactly as for
        element-keys.
        """
        lo, hi = index_bounds(set_name, index_name, start, end, at, after)
        for k, _v in self.store.seek(lo, hi):
            _s, _i, ik, element, dot = decode_posting_key(k)
            yield ik, element, dot

    # ------------------------------------------------------------- clock io
    def read_clock(self, set_name: bytes) -> Clock:
        return _clock_from_bytes(self.store.get(clock_key(set_name)))

    def read_tombstone(self, set_name: bytes) -> Clock:
        return _clock_from_bytes(self.store.get(tombstone_key(set_name)))

    # ----------------------------------------------------------- Algorithm 1
    def coordinate_insert(
        self, set_name: bytes, element: bytes, ctx: Iterable[Dot] = (),
        value: bytes = b"",
    ) -> InsertDelta:
        """Coordinator-side insert (paper Algorithm 1).

        Reads clocks only; context dots unseen by the set-clock are added to
        it (so superseded adds can never materialise later), seen ones go to
        the tombstone (so their element-keys compact away).  Mints a fresh
        dot, atomically writes [set-clock, set-tombstone, element-key] and
        returns the delta to send downstream.
        """
        ctx = tuple(ctx)
        sc = self.read_clock(set_name)
        ts = self.read_tombstone(set_name)
        for dot in ctx:
            if not sc.seen(dot):
                sc = sc.add(dot)
            else:
                ts = ts.add(dot)
        sc, dot = sc.increment(self.actor)
        dig = self._digest(set_name)  # adopt pre-state before the key lands
        self.store.put_batch(
            [
                (clock_key(set_name), _clock_to_bytes(sc)),
                (tombstone_key(set_name), _clock_to_bytes(ts)),
                (element_key(set_name, element, dot), value),
            ]
            + self._posting_writes(set_name, element, dot, value)
        )
        self._digest_add(dig, set_name, element, dot)
        return InsertDelta(set_name, element, dot, ctx, value)

    # ----------------------------------------------------------- Algorithm 2
    def replica_insert(self, delta: InsertDelta) -> bool:
        """Downstream delta apply (paper Algorithm 2).

        Never merges full state: a dot-seen check, a clock add and an append.
        Returns True if the element-key was written (False -> duplicate no-op).
        """
        set_name = delta.set_name
        sc0 = sc = self.read_clock(set_name)
        ts0 = ts = self.read_tombstone(set_name)
        for dot in delta.ctx:
            if not sc.seen(dot):
                sc = sc.add(dot)
            else:
                ts = ts.add(dot)
        if not sc.seen(delta.dot):
            sc = sc.add(delta.dot)
            dig = self._digest(set_name)  # adopt pre-state before the write
            self.store.put_batch(
                [
                    (clock_key(set_name), _clock_to_bytes(sc)),
                    (tombstone_key(set_name), _clock_to_bytes(ts)),
                    (element_key(set_name, delta.element, delta.dot), delta.value),
                ]
                + self._posting_writes(
                    set_name, delta.element, delta.dot, delta.value)
            )
            self._digest_add(dig, set_name, delta.element, delta.dot)
            return True
        # seen: write clocks only if the ctx changed them — a redelivered
        # delta whose ctx is already absorbed must be byte-for-byte free
        # under at-least-once delivery (Clock.add returns self on no-ops,
        # so identity is an exact change test)
        if sc is not sc0 or ts is not ts0:
            self.store.put_batch(
                [
                    (clock_key(set_name), _clock_to_bytes(sc)),
                    (tombstone_key(set_name), _clock_to_bytes(ts)),
                ]
            )
        return False

    # -------------------------------------------------------------- removes
    def coordinate_remove(
        self, set_name: bytes, ctx: Iterable[Dot]
    ) -> RemoveDelta:
        """Remove (§4.3.2): clock-only write; the ctx **must** come from a read."""
        ctx = tuple(ctx)
        self._apply_remove(set_name, ctx)
        return RemoveDelta(set_name, ctx)

    def replica_remove(self, delta: RemoveDelta) -> None:
        self._apply_remove(delta.set_name, delta.ctx)

    def _apply_remove(self, set_name: bytes, ctx: Tuple[Dot, ...]) -> None:
        sc0 = sc = self.read_clock(set_name)
        ts0 = ts = self.read_tombstone(set_name)
        for dot in ctx:
            if sc.seen(dot):
                ts = ts.add(dot)  # key exists (or existed): compact it away
            else:
                sc = sc.add(dot)  # unseen add: pre-empt it ever materialising
        if sc is sc0 and ts is ts0:
            return  # redelivered remove already absorbed: zero writes
        self.store.put_batch(
            [
                (clock_key(set_name), _clock_to_bytes(sc)),
                (tombstone_key(set_name), _clock_to_bytes(ts)),
            ]
        )

    # ---------------------------------------------------------------- reads
    def fold(
        self, set_name: bytes
    ) -> Iterator[Tuple[bytes, Dot]]:
        """Stream surviving (element, dot) pairs in lexicographic element order."""
        for element, dot, _v in self.fold_values(set_name):
            yield element, dot

    def fold_values(
        self, set_name: bytes
    ) -> Iterator[Tuple[bytes, Dot, bytes]]:
        """Fold including element values (checkpoint-shard payloads)."""
        ts = self.read_tombstone(set_name)
        for element, dot, v in self.fold_raw(set_name):
            if not ts.seen(dot):
                yield element, dot, v

    def fold_raw(
        self,
        set_name: bytes,
        start: Optional[bytes] = None,
        end: Optional[bytes] = None,
        after: Optional[bytes] = None,
    ) -> Iterator[Tuple[bytes, Dot, bytes]]:
        """Unfiltered element-key stream over a bounded range.

        This is the fold hook the query executor drives: a storage *seek* to
        the range start (or strictly past the cursor element via ``after``)
        followed by a bounded lazy scan, so a range query touches
        O(result + causal metadata) bytes instead of the whole set.
        Tombstone visibility is **not** applied here — the executor filters
        dots in batches (see :mod:`repro.query.batch`).
        """
        lo, hi = element_bounds(set_name, start, end, after)
        for k, v in self.store.seek(lo, hi):
            _s, element, dot = decode_element_key(k)
            yield element, dot, v

    def element_cursor(
        self,
        set_name: bytes,
        start: Optional[bytes] = None,
        end: Optional[bytes] = None,
        after: Optional[bytes] = None,
    ) -> ElementCursor:
        """Like :meth:`fold_raw`, but positional: the returned cursor can
        :meth:`~ElementCursor.seek` to any element without paying for the
        keys in between (the storage half of gallop joins and cursor
        resumption)."""
        return ElementCursor(self.store, set_name, start, end, after)

    def read(self, set_name: bytes, batch_size: int = 10_000) -> "ReadStream":
        """Streaming read (§4.4): batches of a partial ORSWOT, default 10k."""
        return ReadStream(self, set_name, batch_size)

    def read_full(self, set_name: bytes) -> Orswot:
        """Materialise the whole set as a traditional ORSWOT (for tests/merge)."""
        sc = self.read_clock(set_name)
        entries: Dict[bytes, set] = {}
        for element, dot in self.fold(set_name):
            entries.setdefault(element, set()).add(dot)
        return Orswot(sc, {e: frozenset(s) for e, s in entries.items()})

    def value(self, set_name: bytes) -> FrozenSet[bytes]:
        return frozenset(e for e, _ in self.fold(set_name))

    def is_member(self, set_name: bytes, element: bytes) -> Tuple[bool, Tuple[Dot, ...]]:
        """Membership query without reading the whole set (a seek, §4.4).

        Returns (present, surviving dots) — the dots double as the causal
        context for a subsequent remove or replacing add.
        """
        ts = self.read_tombstone(set_name)
        dots = [
            dot
            for el, dot, _v in self.fold_raw(
                set_name, start=element, end=element + b"\x00")
            if el == element and not ts.seen(dot)
        ]
        return (len(dots) > 0), tuple(sorted(dots))

    def range_query(
        self, set_name: bytes, start: bytes, limit: int
    ) -> List[bytes]:
        """Seek to ``start`` and stream up to ``limit`` members (pagination)."""
        ts = self.read_tombstone(set_name)
        out: List[bytes] = []
        last = None
        for el, dot, _v in self.fold_raw(set_name, start=start):
            if ts.seen(dot):
                continue
            if el != last:
                if len(out) == limit:
                    break
                out.append(el)
                last = el
        return out

    def context_of(self, set_name: bytes, element: bytes) -> Tuple[Dot, ...]:
        return self.is_member(set_name, element)[1]

    # ----------------------------------------------------------- retirement
    def drop_set(self, set_name: bytes) -> int:
        """Delete every key of one set — clock, tombstone, elements,
        postings — and drop its maintained digest.  Returns keys deleted.

        The ring-handoff retirement primitive: after a new owner's clock
        provably dominates this replica's, the moved partition's local
        copy is dead weight.  Deletion is storage-tombstone writes (the
        keys physically leave on the next compaction); the set reads as
        empty immediately.  Index specs stay registered, so a straggler
        replication delta delivered after retirement still derives its
        postings — it becomes a harmless orphan the next ring change or
        anti-entropy round will not resurrect into queries, because
        queries only ever cover owner vnodes.
        """
        lo = encode_key((set_name, KIND_CLOCK))
        hi = encode_key((set_name, KIND_INDEX + 1))
        batch = [(k, STORE_TOMBSTONE) for k, _v in self.store.seek(lo, hi)]
        if batch:
            self.store.put_batch(batch)
        self._digests.pop(set_name, None)
        return len(batch)

    # ----------------------------------------------------------- compaction
    def _compaction_filter(self, key: bytes, value: bytes) -> bool:
        """The modified-leveldb hook: drop element-keys **and** index
        postings seen by the tombstone.

        Both kinds carry their dot in the trailing ``(actor, counter)``
        components and both are tested against the same tombstone snapshot
        in the same pass, so a dead element-key and its postings always
        leave storage together — no separate index GC.
        """
        parts = decode_key(key)
        if len(parts) < 3 or parts[1] not in (KIND_ELEMENT, KIND_INDEX):
            return False
        set_name = parts[0]
        ts = self._ts_cache.get(set_name)
        if ts is None:
            ts = _clock_from_bytes(self._peek(tombstone_key(set_name)))
            self._ts_cache[set_name] = ts
        return ts.seen(_dot_from_parts(parts))

    def _peek(self, key: bytes) -> Optional[bytes]:
        # un-metered read used inside compaction (compaction volume is metered
        # separately by the store)
        v = self.store.memtable.get(key)
        if v is None:
            for run in self.store.runs:
                v = run.get(key)
                if v is not None:
                    break
        from ..storage.lsm import TOMBSTONE as _T

        return None if v is None or v == _T else v

    def _on_discard(self, key: bytes, value: bytes) -> None:
        parts = decode_key(key)
        if parts[1] != KIND_ELEMENT:
            return  # postings ride along; only element dots shrink the tombstone
        set_name, dot = parts[0], _dot_from_parts(parts)
        self._discarded.setdefault(set_name, []).append(dot)
        dig = self._digests.get(set_name)
        if dig is not None:  # uninitialised digests adopt post-compaction state
            dig.discard(parts[2], dot)

    def compact(self) -> Dict[bytes, List[Dot]]:
        """Run storage compaction; shrink tombstones by the discarded dots.

        Returns {set_name: [discarded dots]} (§4.3.3: "Once a key is removed
        the set-tombstone subtracts the deleted dot").
        """
        self._discarded = {}
        self._ts_cache = {}
        self.store.compact()
        discarded = self._discarded
        self._discarded = {}
        self._ts_cache = {}
        batch = []
        for set_name in set(discarded) | set(self._digests):
            ts0 = ts = self.read_tombstone(set_name)
            if set_name in discarded:
                ts = ts.subtract(discarded[set_name])
            # hygiene: a tombstone dot with no physical key left (e.g. a
            # redelivered remove re-added it after its key compacted away)
            # can never discard anything again — drop it here, since sync
            # skips its trim when a reply leaves the tombstone unchanged
            dig = self._digests.get(set_name)
            if dig is not None and not ts.is_zero():
                # O(runs) run-intersection: keep only removals the raw
                # total actually covers
                ts = ts.intersect(dig.raw_total())
            if ts is not ts0:
                batch.append((tombstone_key(set_name), _clock_to_bytes(ts)))
        if batch:
            self.store.put_batch(batch)
        return discarded


# ------------------------------------------------------------ streaming read
class ReadStream:
    """Batched streaming read of a bigset (§4.4), preserving element order.

    Each batch is a *partial* ORSWOT (the set-clock plus a slice of entries)
    suitable for the streaming quorum join in :mod:`repro.core.streaming`.
    """

    def __init__(self, vnode: BigsetVnode, set_name: bytes, batch_size: int):
        self.clock = vnode.read_clock(set_name)
        self._vnode = vnode
        self._set = set_name
        self._batch = batch_size

    def batches(self) -> Iterator[List[Tuple[bytes, Tuple[Dot, ...]]]]:
        out: List[Tuple[bytes, Tuple[Dot, ...]]] = []
        cur_el: Optional[bytes] = None
        cur_dots: List[Dot] = []
        for element, dot in self._vnode.fold(self._set):
            if element != cur_el:
                if cur_el is not None:
                    out.append((cur_el, tuple(cur_dots)))
                    if len(out) >= self._batch:
                        yield out
                        out = []
                cur_el, cur_dots = element, [dot]
            else:
                cur_dots.append(dot)
        if cur_el is not None:
            out.append((cur_el, tuple(cur_dots)))
        if out:
            yield out

    def entries(self) -> Iterator[Tuple[bytes, Tuple[Dot, ...]]]:
        for batch in self.batches():
            yield from batch
