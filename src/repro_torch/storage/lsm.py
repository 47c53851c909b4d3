"""LSM-tree ordered KV store — a faithful-enough leveldb stand-in.

Structure: an in-memory *memtable* (dict), flushed into immutable sorted
*runs* (sstables).  Reads consult memtable then runs newest-first; scans
merge all levels.  Compaction merges runs and applies a caller-supplied
``drop`` predicate — this is the hook the paper adds to leveldb so the
set-tombstone can discard superseded element-keys without ever issuing
deletes (§4.3.3).

Durability is opt-in: construct with a :class:`~repro.storage.wal.DurableMedia`
and every batch is framed into an append-only WAL with **group commit** —
one fsync acknowledges up to ``group_depth`` batches (§4.3's log-before-
memtable discipline, with leveldb's batched sync amortization).  Flushes
and compactions publish segment files plus a manifest recording the WAL
*horizon*; :meth:`LsmStore.recover` rebuilds a crashed store by loading
the manifested segments and replaying only the WAL records above the
horizon.  Without media the store is volatile and every WAL path is a
no-op (zero extra accounting).

Every operation is metered in :class:`IoStats` (bytes read / written /
transferred), because the paper's central claim is about **bytes read and
written over the life of the set** (§2.1: O(n) per op, O(n²) lifetime for
riak-objects vs O(causal metadata) for bigset).

Reads go through :class:`LsmIterator`, a *positional* merged cursor: it
bisects every level to its start key, streams a heap merge, and can
:meth:`~LsmIterator.seek` to a new position in O(log n) per level — the
entries skipped by a seek are never touched, so they cost no ``bytes_read``.
That positional seek is what lets the query layer's gallop joins skip IO
instead of merely skipping Python iterations.  Each immutable run also
carries statistics (key count, key-range fences, cumulative byte offsets);
:meth:`LsmStore.range_stats` turns them into O(log n) cardinality/byte
estimates for any key range — the input to cost-based join planning
(:mod:`repro.query.planner`).

PyTorch port: a copy of :mod:`repro.storage.lsm`; everything below
this docstring is unchanged.
"""
from __future__ import annotations

import bisect
import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from .wal import (MANIFEST, DurableMedia, RecoveryResult, WalError,
                  decode_manifest, decode_segment, decode_wal,
                  encode_manifest, encode_segment, encode_wal_record)

TOMBSTONE = b"\xff\xfe__deleted__"  # storage-level delete marker


@dataclass
class IoStats:
    bytes_written: int = 0      # memtable apply volume (foreground writes)
    bytes_read: int = 0         # get/scan bytes returned + keys touched
    bytes_flushed: int = 0      # memtable -> run
    bytes_compacted: int = 0    # compaction rewrite volume
    bytes_wal: int = 0          # WAL record bytes appended (durable mode)
    bytes_recovered: int = 0    # WAL bytes replayed by recover()
    num_writes: int = 0
    num_reads: int = 0
    num_seeks: int = 0
    num_fsyncs: int = 0         # group commits: one fsync acks many batches
    num_recoveries: int = 0

    def snapshot(self) -> "IoStats":
        return IoStats(**vars(self))

    def delta(self, since: "IoStats") -> "IoStats":
        return IoStats(**{k: getattr(self, k) - getattr(since, k) for k in vars(self)})

    def total_io(self) -> int:
        return self.bytes_written + self.bytes_read


class IoMeter:
    """Live window over a store's :class:`IoStats` (per-query accounting).

    The query executor opens a meter around each plan execution so results
    can report *bytes touched by this query* — the paper's O(result +
    causal metadata) claim made measurable (§2.1, §4.4).
    """

    def __init__(self, stats: IoStats):
        self._stats = stats
        self._before = stats.snapshot()

    def delta(self) -> IoStats:
        return self._stats.delta(self._before)


@dataclass(frozen=True)
class RunStats:
    """Statistics of one immutable run: cardinality, fences, volume."""

    key_count: int
    min_key: bytes       # key-range fences: a range outside [min, max]
    max_key: bytes       # cannot touch this run
    total_bytes: int


@dataclass(frozen=True)
class RangeStats:
    """Approximate cost of a key range: entry count and byte volume.

    Counts are upper bounds — shadowed keys and storage tombstones are
    included (deduplicating them would cost the scan the estimate exists
    to avoid).  Good enough for *relative* cost decisions (join planning),
    not for exact cardinality.
    """

    keys: int
    bytes: int


class _Run:
    """Immutable sorted run of (key, value) pairs.

    ``cum_bytes[i]`` is the byte volume of entries ``[0, i)`` — immutability
    makes the prefix sums free to keep, and they turn any range's byte
    estimate into two bisects and a subtraction.
    """

    __slots__ = ("keys", "values", "cum_bytes")

    def __init__(self, items: List[Tuple[bytes, bytes]]):
        self.keys = [k for k, _ in items]
        self.values = [v for _, v in items]
        cum = [0]
        for k, v in items:
            cum.append(cum[-1] + len(k) + len(v))
        self.cum_bytes = cum

    def get(self, key: bytes) -> Optional[bytes]:
        i = bisect.bisect_left(self.keys, key)
        if i < len(self.keys) and self.keys[i] == key:
            return self.values[i]
        return None

    def span(self, lo: bytes, hi: Optional[bytes]) -> Tuple[int, int]:
        """Index range [i, j) of keys in [lo, hi); hi=None is unbounded."""
        i = bisect.bisect_left(self.keys, lo)
        j = len(self.keys) if hi is None else bisect.bisect_left(self.keys, hi)
        return i, max(i, j)

    def stats(self) -> RunStats:
        return RunStats(
            key_count=len(self.keys),
            min_key=self.keys[0] if self.keys else b"",
            max_key=self.keys[-1] if self.keys else b"",
            total_bytes=self.cum_bytes[-1],
        )

    def __len__(self) -> int:
        return len(self.keys)


class LsmIterator:
    """Positional merged cursor over a snapshot of the store.

    Construction bisects every level (the sorted memtable view plus each
    immutable run) to the first key >= ``lo`` and streams a heap merge in
    key order — newest level wins per key, storage tombstones are dropped.
    ``hi=None`` is genuinely unbounded: the cursor runs to the end of the
    keyspace, whatever the keys look like.

    :meth:`seek` repositions the cursor in O(log n) per level.  Entries
    skipped over by a seek are **never touched**: no ``bytes_read`` is
    metered for them (each ``seek`` counts one ``num_seeks``) — this is the
    storage half of the query layer's gallop join.

    The cursor snapshots its levels at construction: writes issued while it
    is open are not visible through it (same semantics as the previous
    per-scan memtable snapshot).
    """

    __slots__ = ("_store", "_hi", "_keys", "_vals", "_pos", "_heap", "_last")

    def __init__(self, store: "LsmStore", lo: bytes = b"",
                 hi: Optional[bytes] = None):
        self._store = store
        self._hi = hi
        mem_keys, mem_vals = store._memtable_view()
        self._keys: List[List[bytes]] = [mem_keys]
        self._vals: List[List[bytes]] = [mem_vals]
        for run in store.runs:  # newest first: lower index shadows higher
            self._keys.append(run.keys)
            self._vals.append(run.values)
        self._pos = [0] * len(self._keys)
        self._heap: List[Tuple[bytes, int, bytes]] = []
        self._last: Optional[bytes] = None
        self._position(lo)

    def _push(self, idx: int) -> None:
        i = self._pos[idx]
        ks = self._keys[idx]
        if i < len(ks):
            k = ks[i]
            if self._hi is None or k < self._hi:
                heapq.heappush(self._heap, (k, idx, self._vals[idx][i]))
                self._pos[idx] = i + 1

    def _position(self, lo: bytes) -> None:
        self._store.stats.num_seeks += 1
        self._heap = []
        for idx, ks in enumerate(self._keys):
            self._pos[idx] = bisect.bisect_left(ks, lo)
            self._push(idx)

    def seek(self, lo: bytes) -> None:
        """Reposition at the first live key >= ``lo`` (any direction)."""
        self._last = None
        self._position(lo)

    def __iter__(self) -> "LsmIterator":
        return self

    def __next__(self) -> Tuple[bytes, bytes]:
        while self._heap:
            k, idx, v = heapq.heappop(self._heap)
            self._push(idx)
            if k == self._last:
                continue  # older level shadowed
            self._last = k
            if v == TOMBSTONE:
                continue
            self._store.stats.bytes_read += len(k) + len(v)
            return k, v
        raise StopIteration


class LsmStore:
    """Ordered KV store with memtable + sorted runs + pluggable compaction.

    Pass ``media`` (a :class:`~repro.storage.wal.DurableMedia`) for a
    durable store: batches are WAL-framed before the memtable apply and
    acknowledged by group commit — the fsync fires every ``group_depth``
    batches, so ``commit_seq`` (the acknowledged horizon) trails ``seq``
    by at most ``group_depth - 1`` un-fsynced batches.  ``sync()`` forces
    the pending group commit.  Without media the store is volatile and
    none of the WAL fields move.
    """

    def __init__(self, memtable_limit: int = 4096, auto_compact_runs: int = 8,
                 media: Optional["DurableMedia"] = None, group_depth: int = 1):
        self.memtable: Dict[bytes, bytes] = {}
        self.runs: List[_Run] = []  # newest first
        self.stats = IoStats()
        self.memtable_limit = memtable_limit
        self.auto_compact_runs = auto_compact_runs
        self.media = media
        self.group_depth = max(1, group_depth)
        self._seq = 0              # seq of the latest batch appended
        self.commit_seq = 0        # highest durable (acknowledged) seq
        self._pending = 0          # batches appended since the last fsync
        self._manifest_horizon = 0  # seqs <= this live in durable segments
        self._next_seg = 0
        self._seg_names: List[str] = []  # newest first, parallel to runs
        # drop(key, value) -> bool: True to discard during compaction.
        # Set by the bigset layer (the paper's modified-leveldb hook).
        self.compaction_filter: Optional[Callable[[bytes, bytes], bool]] = None
        self.on_discard: Optional[Callable[[bytes, bytes], None]] = None
        self._compacting = False
        # lazily-built sorted view of the memtable, invalidated by writes:
        # cursor positioning is O(log memtable + page), not O(memtable sort)
        # per scan call
        self._mem_keys: Optional[List[bytes]] = None
        self._mem_vals: Optional[List[bytes]] = None

    # ----------------------------------------------------------------- write
    def put_batch(self, items: List[Tuple[bytes, bytes]]) -> int:
        """Atomic write batch: WAL append, memtable apply, group commit.

        In durable mode the batch is CRC-framed into the WAL buffer first
        (billed to ``bytes_wal``), then applied to the memtable; the fsync
        that *acknowledges* it is deferred until ``group_depth`` batches
        are pending (or a flush captures them in a durable segment), so
        fsyncs < batches whenever ``group_depth > 1``.  Returns the batch
        seq; it is durable once ``commit_seq`` reaches it.  Volatile
        stores skip every WAL step and acknowledge immediately.
        """
        self._seq += 1
        seq = self._seq
        if self.media is not None:
            record = encode_wal_record(seq, items)
            self.media.wal_append(record)
            self.stats.bytes_wal += len(record)
            self._pending += 1
        for k, v in items:
            self.stats.bytes_written += len(k) + len(v)
            self.memtable[k] = v
        self.stats.num_writes += 1
        self._mem_keys = self._mem_vals = None
        if len(self.memtable) >= self.memtable_limit:
            self.flush()
        if self.media is None:
            self.commit_seq = seq
        elif self._pending >= self.group_depth:
            self.sync()
        return seq

    def sync(self) -> None:
        """Force the pending group commit: one fsync acknowledges every
        appended batch (``commit_seq`` catches up to the latest seq).
        A crash point armed at a WAL byte offset fires here, tearing the
        durable log mid-record."""
        if self.media is None or self._pending == 0:
            return
        self.media.wal_sync()
        self.stats.num_fsyncs += 1
        self._pending = 0
        self.commit_seq = self._seq

    def put(self, key: bytes, value: bytes) -> None:
        self.put_batch([(key, value)])

    def delete(self, key: bytes) -> None:
        self.put_batch([(key, TOMBSTONE)])

    # ------------------------------------------------------------- recovery
    def recover(self) -> RecoveryResult:
        """Rebuild a crashed store from its durable media.

        Loads the manifested segments as runs (newest first), then replays
        WAL records **above** the manifest horizon into the memtable —
        records at or below it were already captured by a durable flush
        (and possibly rewritten by compaction), so replaying them would
        resurrect discarded element-keys; they are counted as skipped and
        their bytes are never re-billed.  A torn final record (mid-fsync
        crash) is discarded by CRC framing.  Restores exactly the
        acknowledged prefix: every batch with ``seq <= commit_seq`` at
        crash time, nothing beyond the durable WAL.

        Only valid on a freshly-constructed store holding the media.
        """
        if self.media is None:
            raise WalError("recover() requires durable media")
        if self.memtable or self.runs or self._seq:
            raise WalError("recover() on a store that already has state")
        segments, horizon, next_seg = decode_manifest(
            self.media.read_file(MANIFEST))
        for name in segments:  # manifest order is newest-first, like runs
            data = self.media.read_file(name)
            if data is None:
                raise WalError(f"manifest references missing segment {name}")
            self.runs.append(_Run(decode_segment(data)))
        self._seg_names = list(segments)
        self._manifest_horizon = horizon
        self._next_seg = next_seg
        records, torn_bytes = decode_wal(bytes(self.media.wal))
        replayed = skipped = nbytes = 0
        last_seq = horizon
        for rec in records:
            last_seq = max(last_seq, rec.seq)
            if rec.seq <= horizon:
                skipped += 1
                continue
            for k, v in rec.items:
                self.memtable[k] = v
            replayed += 1
            nbytes += rec.nbytes
        self._mem_keys = self._mem_vals = None
        self._seq = last_seq        # continue batch numbering monotonically
        self.commit_seq = last_seq  # everything restored is durable
        self._pending = 0
        self.stats.bytes_recovered += nbytes
        self.stats.num_recoveries += 1
        return RecoveryResult(
            segments=len(segments), batches_replayed=replayed,
            batches_skipped=skipped, bytes_replayed=nbytes,
            torn_bytes=torn_bytes, horizon=horizon, last_seq=last_seq)

    # ------------------------------------------------------------------ read
    def get(self, key: bytes) -> Optional[bytes]:
        self.stats.num_reads += 1
        v = self.memtable.get(key)
        if v is None:
            for run in self.runs:
                v = run.get(key)
                if v is not None:
                    break
        if v is None or v == TOMBSTONE:
            self.stats.bytes_read += len(key)
            return None
        self.stats.bytes_read += len(key) + len(v)
        return v

    def _memtable_view(self) -> Tuple[List[bytes], List[bytes]]:
        """Sorted (keys, values) view of the memtable, cached until a write.

        Keeping the view bisectable makes cursor positioning O(log n +
        page) instead of O(memtable) per scan — read-heavy cursor paging
        sorts once, not once per page.
        """
        if self._mem_keys is None:
            items = sorted(self.memtable.items())
            self._mem_keys = [k for k, _ in items]
            self._mem_vals = [v for _, v in items]
        return self._mem_keys, self._mem_vals

    def scan(self, lo: bytes = b"", hi: Optional[bytes] = None) -> LsmIterator:
        """Merged positional cursor over [lo, hi); newest level wins per
        key.  ``hi=None`` scans to the end of the keyspace.  Use the
        returned cursor's :meth:`LsmIterator.seek` to gallop without
        paying for skipped keys."""
        return LsmIterator(self, lo, hi)

    def seek(
        self, lo: bytes, hi: Optional[bytes] = None,
        limit: Optional[int] = None,
    ) -> Iterator[Tuple[bytes, bytes]]:
        """Bounded scan: position at ``lo`` and stream at most ``limit`` live
        entries below ``hi``.  ``hi=None`` is genuinely unbounded — the
        merged cursor has no upper fence, whatever the key bytes are.

        This is the primitive the query executor drives — a range query pays
        for the entries it returns (the iterator is lazy and metering happens
        per yielded entry), never for the whole keyspace.
        """
        it = LsmIterator(self, lo, hi)
        return itertools.islice(it, limit) if limit is not None else it

    def meter(self) -> IoMeter:
        """Open a per-query IO accounting window over this store's stats."""
        return IoMeter(self.stats)

    # ------------------------------------------------------------ statistics
    def run_stats(self) -> List[RunStats]:
        """Per-run statistics, newest first: count, fences, byte volume."""
        return [run.stats() for run in self.runs]

    def range_stats(self, lo: bytes, hi: Optional[bytes] = None) -> RangeStats:
        """Approximate keys/bytes in ``[lo, hi)`` across all levels.

        O(log n) per run (bisect against the fences + cumulative byte
        offsets) plus O(matching memtable entries); never touches values.
        The count is an upper bound (shadowed keys and storage tombstones
        included) — the planner's cost model only needs relative
        magnitudes.  Callers with a tuple-key prefix get ``[lo, hi)`` from
        :func:`repro.storage.keycodec.prefix_bounds`.
        """
        mem_keys, mem_vals = self._memtable_view()
        i = bisect.bisect_left(mem_keys, lo)
        j = len(mem_keys) if hi is None else bisect.bisect_left(mem_keys, hi)
        j = max(i, j)
        keys = j - i
        nbytes = sum(
            len(mem_keys[x]) + len(mem_vals[x]) for x in range(i, j))
        for run in self.runs:
            i, j = run.span(lo, hi)
            keys += j - i
            nbytes += run.cum_bytes[j] - run.cum_bytes[i]
        return RangeStats(keys=keys, bytes=nbytes)

    # ------------------------------------------------------------ level mgmt
    def flush(self) -> None:
        if not self.memtable:
            return
        items = sorted(self.memtable.items())
        self.stats.bytes_flushed += sum(len(k) + len(v) for k, v in items)
        self.runs.insert(0, _Run(items))
        self.memtable = {}
        self._mem_keys = self._mem_vals = None
        if self.media is not None:
            # Publish the run as a durable segment and advance the manifest
            # horizon to the last captured batch: those batches are now
            # durable without their WAL fsync, and the unsynced WAL tail
            # (all <= horizon) is redundant.  A crash between the two
            # publishes leaves the old manifest pointing at the old
            # segments + durable WAL — still exactly the acknowledged
            # prefix.
            name = f"seg-{self._next_seg:08d}"
            self._next_seg += 1
            self._manifest_horizon = self._seq
            self.media.write_file(name, encode_segment(items))
            self._seg_names.insert(0, name)
            self._publish_manifest()
            self.media.wal_drop_buffer()
            self._pending = 0
            self.commit_seq = self._seq
        if len(self.runs) >= self.auto_compact_runs and not self._compacting:
            self.compact()

    def _publish_manifest(self) -> None:
        self.media.write_file(
            MANIFEST,
            encode_manifest(self._seg_names, self._manifest_horizon,
                            self._next_seg))

    def compact(self) -> List[Tuple[bytes, bytes]]:
        """Merge all levels into one run, applying the compaction filter.

        Returns the list of (key, value) pairs *discarded by the filter*
        (storage tombstones are dropped silently).  The bigset layer uses the
        returned dots to shrink the set-tombstone (§4.3.3).
        """
        self._compacting = True
        try:
            return self._compact_inner()
        finally:
            self._compacting = False

    def _compact_inner(self) -> List[Tuple[bytes, bytes]]:
        self.flush()
        merged: List[Tuple[bytes, bytes]] = []
        discarded: List[Tuple[bytes, bytes]] = []
        seen_keys: set = set()
        flt = self.compaction_filter
        # newest-first iteration; first occurrence of a key wins
        for run in self.runs:
            for k, v in zip(run.keys, run.values):
                if k in seen_keys:
                    continue
                seen_keys.add(k)
                self.stats.bytes_compacted += len(k) + len(v)
                if v == TOMBSTONE:
                    continue
                if flt is not None and flt(k, v):
                    discarded.append((k, v))
                    if self.on_discard is not None:
                        self.on_discard(k, v)
                    continue
                merged.append((k, v))
        merged.sort()
        self.stats.bytes_compacted += sum(len(k) + len(v) for k, v in merged)
        self.runs = [_Run(merged)] if merged else []
        if self.media is not None:
            # One merged segment replaces every prior one, then the WAL is
            # atomically emptied: records <= horizon must never replay
            # after the filter discarded their keys (the set-tombstone
            # already shrank past those dots).  Crash ordering is safe at
            # every publish: before the manifest lands the old
            # segments+WAL are authoritative; after it, the merged
            # segment is, and stale WAL records fall at or below the new
            # horizon so recovery skips them.
            stale = self._seg_names
            self._seg_names = []
            self._manifest_horizon = self._seq
            if merged:
                name = f"seg-{self._next_seg:08d}"
                self._next_seg += 1
                self.media.write_file(name, encode_segment(merged))
                self._seg_names = [name]
            self._publish_manifest()
            self.media.wal_reset()
            self._pending = 0
            self.commit_seq = self._seq
            for name in stale:
                self.media.delete_file(name)
        return discarded

    # ------------------------------------------------------------- inspection
    def __len__(self) -> int:
        n = 0
        seen: set = set()
        for k, v in self.memtable.items():
            seen.add(k)
            if v != TOMBSTONE:
                n += 1
        for run in self.runs:
            for k, v in zip(run.keys, run.values):
                if k in seen:
                    continue
                seen.add(k)
                if v != TOMBSTONE:
                    n += 1
        return n

    def approximate_bytes(self) -> int:
        total = sum(len(k) + len(v) for k, v in self.memtable.items())
        for run in self.runs:
            total += sum(len(k) + len(v) for k, v in zip(run.keys, run.values))
        return total
