"""Streaming bigset query executor (paper §4.4).

Executes logical plans against one :class:`~repro.core.bigset.BigsetVnode`
with three invariants:

* **Seek, don't fold**: every plan positions the LSM iterator at the first
  relevant element-key (cursor resumption seeks strictly past the last
  emitted element) and stops at the range end or limit — a range query costs
  O(result + causal metadata) bytes, never O(n).  Verified against
  per-query :class:`~repro.storage.lsm.IoStats` in ``tests/test_query.py``.
* **Bounded memory**: the element-key stream is consumed in fixed-size
  chunks; at most one chunk plus the entry currently being grouped is ever
  held.  Million-element sets page through a fixed-size window.
* **Batched visibility**: each chunk's dots are tested against the
  set-tombstone in one :class:`~repro.query.batch.BatchVisibility` dispatch
  (the ``dot_seen`` kernel) instead of per-dot Python probes.

Joins come in two strategies, chosen per query by the cost-based planner
(:mod:`repro.query.planner`) from LSM run statistics — or pinned via the
plan's ``strategy`` field:

* :func:`zipper_join` merges two ordered element streams end-to-end; when
  one side falls behind it drains its already-read chunk, then repositions
  the LSM cursor with one **positional seek** (skipped keys cost no IO).
* :func:`gallop_join` streams only the smaller (drive) side and probes the
  larger with bounded storage seeks — cost proportional to the small
  side's cardinality, independent of the large side's.

Both emit byte-identical entries; the chosen strategy is reported in
:attr:`QueryStats.strategy` and flows through the serve layer's per-page
stats.

PyTorch port of :mod:`repro.query.executor`: the executor takes a
``device`` (default ``"cuda"``) in place of ``use_pallas``/``interpret``,
and every visibility filter it builds runs there.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional, Tuple

import msgpack

from ..core.bigset import BigsetVnode
from ..core.clock import Clock
from ..core.dots import Dot, DotList
from ..device import DeviceLike, resolve_device
from ..storage.keycodec import successor_bytes
from .batch import BatchVisibility
from .cursor import decode_cursor, encode_cursor, resume_point
from .plan import (Count, IndexLookup, IndexRange, Join, Membership, Plan,
                   PlanError, Range, Scan)
from .plan import cursor_scope, index_span, validate
from .planner import GALLOP, choose_join, side_stats

DEFAULT_BATCH_SIZE = 1024
# chunk size right after a positional seek: the next read should pay for a
# probe-sized bite, not a full prefetch the gallop may immediately skip
SEEK_CHUNK = 8


@dataclass
class QueryStats:
    """Per-query cost accounting (fed by the store's IoStats meter)."""

    bytes_read: int = 0
    num_seeks: int = 0
    keys_scanned: int = 0
    elements_emitted: int = 0
    batches: int = 0
    keys_probed: int = 0   # point probes issued (membership / index lookup /
                           # gallop probes), counted on hits AND misses
    kernel_launches: int = 0  # batched dot_seen dispatches this query paid
    kernel_rows: int = 0      # dots those dispatches covered (pre-padding)
    strategy: str = ""     # join strategy the planner executed ("" otherwise)
    coverage: str = ""     # ring coverage the cluster planned for this query
                           # ("epoch=E;partitions=P;vnodes=V;r=R")


@dataclass
class QueryResult:
    entries: List[Tuple[bytes, DotList]] = field(default_factory=list)
    present: Optional[bool] = None    # Membership only
    count: Optional[int] = None       # Count only
    cursor: Optional[bytes] = None    # more pages exist iff not None
    clock: Optional[Clock] = None     # set-clock snapshot (quorum merge)
    stats: QueryStats = field(default_factory=QueryStats)
    # IndexLookup/IndexRange only: (index_key, element, dots) in index order
    index_entries: Optional[List[Tuple[bytes, bytes, DotList]]] = None

    @property
    def members(self) -> List[bytes]:
        return [e for e, _ in self.entries]


class _EntryStream:
    """Visible (element, dots) stream over a bounded element range.

    Groups the raw element-key stream by element and filters each chunk's
    dots through one batched visibility dispatch.  The raw stream is a
    positional :class:`~repro.core.bigset.ElementCursor`: ``seek_to``
    (galloping joins, cursor resumption) repositions it with one O(log n)
    storage seek — the skipped keys are never read, so they cost neither
    ``bytes_read`` nor ``keys_scanned`` — without rebuilding the tombstone
    filter.
    """

    def __init__(
        self,
        vnode: BigsetVnode,
        set_name: bytes,
        vis: BatchVisibility,
        stats: QueryStats,
        start: Optional[bytes] = None,
        end: Optional[bytes] = None,
        after: Optional[bytes] = None,
        batch_size: int = DEFAULT_BATCH_SIZE,
    ):
        self._vnode = vnode
        self._set = set_name
        self._vis = vis
        self._stats = stats
        self._batch = batch_size
        # Grow chunks geometrically: a limit-25 page must not pre-pay for a
        # full batch of keys (O(result), not O(batch)); deep scans still
        # amortise into full-width visibility dispatches.
        self._chunk = min(32, batch_size)
        # last element the raw cursor has read into a chunk: the boundary
        # between draining already-paid read-ahead and a storage seek
        self._last_raw_el: Optional[bytes] = None
        self._raw = vnode.element_cursor(
            set_name, start=start, end=end, after=after)
        self._gen = self._generate()
        self.head: Optional[Tuple[bytes, DotList]] = next(self._gen, None)

    def advance(self) -> Optional[Tuple[bytes, DotList]]:
        """Pop and return the current head; load the next entry."""
        h = self.head
        self.head = next(self._gen, None)
        return h

    def seek_to(self, element: bytes) -> None:
        """Position the head at the first visible entry >= ``element``.

        When the target is still inside the chunk the raw cursor already
        read (and metered), draining to it is free IO.  Past that
        read-ahead, one positional storage seek jumps the gap — the
        skipped keys are never read, so they cost no ``bytes_read`` and no
        ``keys_scanned``, and nothing already paid for is re-read.  The
        chunk size resets small after a seek so the next read pays for a
        probe-sized bite, not a full prefetch.
        """
        while self.head is not None and self.head[0] < element:
            if self._last_raw_el is None or self._last_raw_el >= element:
                self.advance()
                continue
            self._raw.seek(element)
            self._chunk = SEEK_CHUNK
            self._last_raw_el = None
            self._gen = self._generate()
            self.head = next(self._gen, None)
            return

    def _generate(self) -> Iterator[Tuple[bytes, DotList]]:
        raw = self._raw
        cur_el: Optional[bytes] = None
        cur_dots: List[Dot] = []
        while True:
            chunk: List[Tuple[bytes, Dot]] = []
            for el, dot, _v in raw:
                chunk.append((el, dot))
                self._last_raw_el = el
                if len(chunk) >= self._chunk:
                    break
            if not chunk:
                break
            self._chunk = min(self._chunk * 4, self._batch)
            dead = self._vis.seen_mask([d for _, d in chunk])
            self._stats.keys_scanned += len(chunk)
            self._stats.batches += 1
            for (el, dot), is_dead in zip(chunk, dead):
                if el != cur_el:
                    if cur_el is not None and cur_dots:
                        yield cur_el, tuple(cur_dots)
                    cur_el, cur_dots = el, []
                if not is_dead:
                    cur_dots.append(dot)
        if cur_el is not None and cur_dots:
            yield cur_el, tuple(cur_dots)


class _IndexStream:
    """Visible ``((index_key, element), dots)`` stream over a posting range.

    Groups the raw posting stream by ``(index_key, element)`` and filters
    each chunk's dots through one batched visibility dispatch — the same
    ``dot_seen`` path element scans use, because a posting is live
    iff its dot is live.  Each surviving group then fetches its element's
    full surviving dot context from the element keyspace (a bounded seek),
    so index results carry the same causal context a Range would return —
    total cost O(matches + causal metadata).
    """

    def __init__(
        self,
        vnode: BigsetVnode,
        set_name: bytes,
        index_name: bytes,
        vis: BatchVisibility,
        stats: QueryStats,
        start: Optional[bytes] = None,
        end: Optional[bytes] = None,
        at: Optional[Tuple[bytes, bytes]] = None,
        after: Optional[Tuple[bytes, bytes]] = None,
        batch_size: int = DEFAULT_BATCH_SIZE,
    ):
        self._vnode = vnode
        self._set = set_name
        self._index = index_name
        self._vis = vis
        self._stats = stats
        self._end = end
        self._batch = batch_size
        self._gen = self._generate(start=start, at=at, after=after)
        self.head: Optional[Tuple[Tuple[bytes, bytes], DotList]] = next(
            self._gen, None)

    def advance(self) -> Optional[Tuple[Tuple[bytes, bytes], DotList]]:
        h = self.head
        self.head = next(self._gen, None)
        return h

    def _generate(
        self,
        start: Optional[bytes],
        at: Optional[Tuple[bytes, bytes]],
        after: Optional[Tuple[bytes, bytes]],
    ) -> Iterator[Tuple[Tuple[bytes, bytes], DotList]]:
        raw = self._vnode.fold_postings(
            self._set, self._index, start=start, end=self._end,
            at=at, after=after)
        cur: Optional[Tuple[bytes, bytes]] = None
        cur_live = False
        chunk_size = min(32, self._batch)
        while True:
            chunk: List[Tuple[bytes, bytes, Dot]] = []
            for ik, el, dot in raw:
                chunk.append((ik, el, dot))
                if len(chunk) >= chunk_size:
                    break
            if not chunk:
                break
            chunk_size = min(chunk_size * 4, self._batch)
            dead = self._vis.seen_mask([d for _, _, d in chunk])
            self._stats.keys_scanned += len(chunk)
            self._stats.batches += 1
            for (ik, el, dot), is_dead in zip(chunk, dead):
                if (ik, el) != cur:
                    if cur is not None and cur_live:
                        entry = self._entry(cur)
                        if entry is not None:
                            yield entry
                    cur, cur_live = (ik, el), False
                if not is_dead:
                    cur_live = True
        if cur is not None and cur_live:
            entry = self._entry(cur)
            if entry is not None:
                yield entry

    def _entry(
        self, pos: Tuple[bytes, bytes]
    ) -> Optional[Tuple[Tuple[bytes, bytes], DotList]]:
        """Fetch the element's full surviving dots (the "then fetch matching
        elements" step): one bounded seek into the element range."""
        _ik, element = pos
        dots = [
            d for _e, d, _v in self._vnode.fold_raw(
                self._set, start=element, end=successor_bytes(element))
        ]
        mask = self._vis.seen_mask(dots)
        live = tuple(sorted(d for d, is_dead in zip(dots, mask) if not is_dead))
        return (pos, live) if live else None


class QueryExecutor:
    """Executes :mod:`repro_torch.query.plan` plans against one vnode."""

    def __init__(
        self,
        vnode: BigsetVnode,
        *,
        batch_size: int = DEFAULT_BATCH_SIZE,
        device: DeviceLike = None,
    ):
        self.vnode = vnode
        self.batch_size = batch_size
        self.device = resolve_device(device)

    # ----------------------------------------------------------------- public
    def execute(self, plan: Plan) -> QueryResult:
        validate(plan)
        meter = self.vnode.store.meter()
        if isinstance(plan, Membership):
            res = self._membership(plan)
        elif isinstance(plan, Range):
            res = self._range(plan.set_name, plan.start, plan.end,
                              plan.limit, plan.cursor, cursor_scope(plan))
        elif isinstance(plan, Scan):
            res = self._range(plan.set_name, None, None,
                              plan.page_size, plan.cursor, cursor_scope(plan))
        elif isinstance(plan, Count):
            res = self._count(plan)
        elif isinstance(plan, Join):
            res = self._join(plan)
        elif isinstance(plan, (IndexLookup, IndexRange)):
            res = self._index(plan)
        else:  # pragma: no cover - validate() already rejects
            raise PlanError(f"unknown plan {type(plan).__name__}")
        io = meter.delta()
        res.stats.bytes_read = io.bytes_read
        res.stats.num_seeks = io.num_seeks
        account_emitted(res)
        return res

    def entry_stream(
        self,
        set_name: bytes,
        start: Optional[bytes] = None,
        end: Optional[bytes] = None,
        after: Optional[bytes] = None,
        stats: Optional[QueryStats] = None,
    ) -> _EntryStream:
        """Visible entry stream hook (also driven by the cluster layer)."""
        stats = stats if stats is not None else QueryStats()
        vis = BatchVisibility(
            self.vnode.read_tombstone(set_name),
            device=self.device,
            stats=stats)
        return _EntryStream(
            self.vnode, set_name, vis, stats,
            start=start, end=end, after=after, batch_size=self.batch_size)

    def index_stream(
        self,
        set_name: bytes,
        index_name: bytes,
        start: Optional[bytes] = None,
        end: Optional[bytes] = None,
        at: Optional[Tuple[bytes, bytes]] = None,
        after: Optional[Tuple[bytes, bytes]] = None,
        stats: Optional[QueryStats] = None,
    ) -> _IndexStream:
        """Visible posting-group stream (also driven by the cluster layer)."""
        stats = stats if stats is not None else QueryStats()
        vis = BatchVisibility(
            self.vnode.read_tombstone(set_name),
            device=self.device,
            stats=stats)
        return _IndexStream(
            self.vnode, set_name, index_name, vis, stats,
            start=start, end=end, at=at, after=after,
            batch_size=self.batch_size)

    # ---------------------------------------------------------------- shapes
    def _membership(self, plan: Membership) -> QueryResult:
        res = QueryResult(clock=self.vnode.read_clock(plan.set_name))
        res.stats.keys_probed += 1  # misses must account the probed key too
        stream = self.entry_stream(
            plan.set_name, start=plan.element,
            end=plan.element + b"\x00", stats=res.stats)
        entry = stream.advance()
        if entry is not None:
            res.entries = [(entry[0], tuple(sorted(entry[1])))]
            res.present = True
        else:
            res.present = False
        return res

    def _range(
        self,
        set_name: bytes,
        start: Optional[bytes],
        end: Optional[bytes],
        limit: Optional[int],
        cursor: Optional[bytes],
        scope: bytes,
    ) -> QueryResult:
        resume_start, after = resume_point(cursor, scope)
        if resume_start is not None:
            start = resume_start
        res = QueryResult(clock=self.vnode.read_clock(set_name))
        stream = self.entry_stream(
            set_name, start=start, end=end, after=after, stats=res.stats)
        collect_page(stream_entries(stream), limit, scope, res)
        return res

    def _count(self, plan: Count) -> QueryResult:
        res = QueryResult(clock=self.vnode.read_clock(plan.set_name))
        stream = self.entry_stream(
            plan.set_name, start=plan.start, end=plan.end, stats=res.stats)
        n = 0
        while stream.advance() is not None:
            n += 1
        res.count = n
        return res

    def _index(self, plan) -> QueryResult:
        scope = cursor_scope(plan)
        start, end = index_span(plan)
        at, after = index_resume_point(plan.cursor, scope)
        res = QueryResult(
            clock=self.vnode.read_clock(plan.set_name), index_entries=[])
        if isinstance(plan, IndexLookup):
            res.stats.keys_probed += 1
        stream = self.index_stream(
            plan.set_name, plan.index, start=start, end=end,
            at=at, after=after, stats=res.stats)
        collect_index_page(stream, plan.limit, scope, res)
        return res

    def _join(self, plan: Join) -> QueryResult:
        scope = cursor_scope(plan)
        start, after = resume_point(plan.cursor, scope)
        res = QueryResult(
            clock=self.vnode.read_clock(plan.left).join(
                self.vnode.read_clock(plan.right)))
        choice = choose_join(
            plan.kind,
            side_stats(self.vnode.store, plan.left),
            side_stats(self.vnode.store, plan.right),
            forced=plan.strategy)
        res.stats.strategy = choice.strategy
        if choice.strategy == GALLOP:
            drive_name, probe_name = (
                (plan.left, plan.right) if choice.drive == "left"
                else (plan.right, plan.left))
            drive = self.entry_stream(
                drive_name, start=start, after=after, stats=res.stats)
            probe = self.element_probe(probe_name, res.stats)
            entries = gallop_join(plan.kind, drive, probe, choice.drive)
        else:
            left = self.entry_stream(
                plan.left, start=start, after=after, stats=res.stats)
            right = self.entry_stream(
                plan.right, start=start, after=after, stats=res.stats)
            entries = zipper_join(plan.kind, left, right)
        collect_page(entries, plan.limit, scope, res)
        return res

    def element_probe(
        self, set_name: bytes, stats: QueryStats
    ) -> Callable[[bytes], Optional[DotList]]:
        """Bounded point probe: one element's surviving dots, or None.

        The gallop join's larger-side primitive — a storage seek spanning
        exactly the element's keys (like Membership), visibility-filtered
        through the same batched path as streams.  Counted in
        ``keys_probed`` on hits AND misses; only the element's own keys
        land in ``keys_scanned``, never the gap galloped over.
        """
        vis = BatchVisibility(
            self.vnode.read_tombstone(set_name),
            device=self.device,
            stats=stats)
        vnode = self.vnode

        def probe(element: bytes) -> Optional[DotList]:
            stats.keys_probed += 1
            dots = [
                dot for _el, dot, _v in vnode.fold_raw(
                    set_name, start=element, end=element + b"\x00")
            ]
            stats.keys_scanned += len(dots)
            if not dots:
                return None
            dead = vis.seen_mask(dots)
            live = tuple(d for d, is_dead in zip(dots, dead) if not is_dead)
            return live or None

        return probe


def stream_entries(stream) -> Iterator[Tuple[bytes, DotList]]:
    """Drain a head/advance entry stream as an iterator."""
    while stream.head is not None:
        yield stream.advance()


def account_emitted(res: QueryResult) -> None:
    """Fill ``stats.elements_emitted`` for every plan shape.

    ``Count`` streams the whole range without materialising entries, so its
    emitted work is the count itself — leaving it at ``len(entries) == 0``
    under-reports the query's output.
    """
    res.stats.elements_emitted = (
        res.count if res.count is not None else len(res.entries))


def encode_index_position(index_key: bytes, element: bytes) -> bytes:
    """Pack an index cursor position — length-delimited, like plan scopes,
    so ``(b"a:b", b"c")`` and ``(b"a", b"b:c")`` never alias."""
    return msgpack.packb([index_key, element])


def index_resume_point(
    cursor: Optional[bytes], scope: bytes
) -> "Tuple[Optional[Tuple[bytes, bytes]], Optional[Tuple[bytes, bytes]]]":
    """Decode an index cursor into ``(at, after)`` posting-group positions."""
    if cursor is None:
        return None, None
    pos, inclusive = decode_cursor(cursor, scope)
    index_key, element = msgpack.unpackb(pos)
    return ((index_key, element), None) if inclusive else (
        None, (index_key, element))


def collect_index_page(
    stream,
    limit: Optional[int],
    scope: bytes,
    res: QueryResult,
) -> None:
    """Pagination over ``((index_key, element), dots)`` streams.

    Same rule as :func:`collect_page`, but the resume position is the
    ``(index_key, element)`` group boundary — an element can recur under
    several index keys, so the element alone cannot name where a page
    stopped.  Fills both ``res.index_entries`` and the flat ``res.entries``.
    """
    if res.index_entries is None:
        res.index_entries = []
    while stream.head is not None:
        (index_key, element), dots = stream.head
        if limit is not None and len(res.index_entries) >= limit:
            if res.index_entries:
                last_ik, last_el, _ = res.index_entries[-1]
                res.cursor = encode_cursor(
                    scope, encode_index_position(last_ik, last_el))
            else:
                res.cursor = encode_cursor(
                    scope, encode_index_position(index_key, element),
                    inclusive=True)
            return
        stream.advance()
        res.index_entries.append((index_key, element, dots))
        res.entries.append((element, dots))


def collect_page(
    entries: Iterator[Tuple[bytes, DotList]],
    limit: Optional[int],
    scope: bytes,
    res: QueryResult,
) -> None:
    """The one pagination rule, shared by vnode and quorum paths.

    Fills ``res.entries`` up to ``limit`` and mints the resume cursor:
    exclusive past the last emitted element, or inclusive at the next
    pending element when the page emitted nothing (``limit=0``).
    """
    for el, dots in entries:
        if limit is not None and len(res.entries) >= limit:
            if res.entries:
                res.cursor = encode_cursor(scope, res.entries[-1][0])
            else:
                res.cursor = encode_cursor(scope, el, inclusive=True)
            return
        res.entries.append((el, dots))


def gallop_join(
    kind: str, drive, probe, drive_side: str = "left"
) -> Iterator[Tuple[bytes, DotList]]:
    """Seek-gallop join: stream the small (drive) side, probe the large.

    ``drive`` is a head/advance entry stream (vnode or quorum);
    ``probe(element)`` resolves the larger side's surviving dots for
    exactly that element via a bounded storage seek, or None.  Total cost
    is O(drive + probes) — the large side's cardinality never appears.

    Emitted dots follow the same single-domain rule as
    :func:`zipper_join`: intersect yields the LEFT set's dots (the drive
    entry's when driving left, the probe's when driving right);
    difference emits left survivors, so it must always drive left.  Union
    structurally cannot gallop (every entry of both sides is emitted) —
    the planner maps it to the zipper before execution reaches here.
    """
    if kind == "intersect":
        while drive.head is not None:
            el, ddots = drive.advance()
            pdots = probe(el)
            if pdots is not None:
                yield el, tuple(ddots if drive_side == "left" else pdots)
    elif kind == "difference":
        if drive_side != "left":
            raise PlanError("gallop difference must drive the left side")
        while drive.head is not None:
            el, ddots = drive.advance()
            if probe(el) is None:
                yield el, tuple(ddots)
    else:
        raise PlanError(f"gallop join cannot execute kind {kind!r}")


def zipper_join(
    kind: str, left, right
) -> Iterator[Tuple[bytes, DotList]]:
    """Ordered zipper over two visible entry streams (§4.4 streaming join).

    Entry dots always come from a *single* set's clock domain — the left
    set when the element is present there, otherwise the right set.  Dots
    from the two sets must never be mixed in one tuple: the same
    ``(actor, counter)`` names unrelated inserts in each set, so a blended
    tuple would be unusable (and dangerous) as a remove context.
    """
    if kind == "intersect":
        while left.head is not None and right.head is not None:
            lh, rh = left.head[0], right.head[0]
            if lh < rh:
                left.seek_to(rh)
            elif rh < lh:
                right.seek_to(lh)
            else:
                el, ld = left.advance()
                right.advance()
                yield el, tuple(ld)
    elif kind == "union":
        while left.head is not None or right.head is not None:
            if right.head is None or (
                    left.head is not None and left.head[0] < right.head[0]):
                yield left.advance()
            elif left.head is None or right.head[0] < left.head[0]:
                yield right.advance()
            else:
                el, ld = left.advance()
                right.advance()
                yield el, tuple(ld)
    elif kind == "difference":
        while left.head is not None:
            if right.head is None or left.head[0] < right.head[0]:
                yield left.advance()
            elif right.head[0] < left.head[0]:
                right.seek_to(left.head[0])
            else:
                left.advance()
                right.advance()
    else:  # pragma: no cover - validate() already rejects
        raise PlanError(f"unknown join kind {kind!r}")
