"""Durable media for the LSM stand-in: WAL, segment files, crash injection.

The paper's bigsets inherit durability from leveldb (§4.3: every batch hits
a log before the memtable).  This module supplies the equivalent for our
simulated store without touching the real filesystem: a
:class:`DurableMedia` models one vnode's disk — an append-only write-ahead
log with an explicit *unsynced buffer* (bytes written but not yet fsynced),
plus a namespace of atomically-published files (segments and a manifest).

Crash semantics are the interesting part, and they are deterministic by
construction (no wall clock, no hidden randomness — invariant BS001):

* ``crash()`` drops the unsynced WAL buffer and nothing else.  Everything
  previously fsynced or atomically published survives.
* A :class:`CrashPoint` arms a seeded kill point.  ``wal_bytes=N`` makes
  the *next fsync that would carry the durable WAL past byte N* die mid-way,
  leaving the durable log truncated at exactly N — which in general tears
  the final record (the CRC-framed decoder discards the torn tail).
  ``file_writes=K`` makes the K-th subsequent atomic file publish raise
  *before* publishing — modelling a crash mid-flush or mid-compaction.

Record framing: each WAL record is ``<len, crc32>`` header + body, body is
``<seq, n_items>`` + length-prefixed key/value pairs.  :func:`decode_wal`
stops at the first short or CRC-mismatched frame and reports the torn byte
count — a partial record is indistinguishable from garbage and must never
be replayed (invariant 11: acknowledged ⇒ durable, and nothing *beyond*
the durable prefix is resurrected).

Segments are whole flushed runs, CRC-framed the same way; the manifest
(msgpack) names the live segments newest-first and records the *horizon*:
the highest batch seq already folded into a durable segment.  Recovery
replays only WAL records **above** the horizon — records at or below it
were captured by a flush (and possibly rewritten by a compaction that
shrank the set-tombstone), so replaying them would resurrect element-keys
whose dots were already discarded.

PyTorch port: a copy of :mod:`repro.storage.wal`; everything below
this docstring is unchanged.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import msgpack

MANIFEST = "MANIFEST"

_HDR = struct.Struct("<II")       # body_len, crc32(body)
_BODY_HDR = struct.Struct("<QI")  # seq, n_items
_ITEM_HDR = struct.Struct("<II")  # key_len, value_len


class WalError(RuntimeError):
    """Durable-media misuse or unrecoverable corruption (not a crash)."""


class CrashError(RuntimeError):
    """A scheduled :class:`CrashPoint` fired: the vnode process is dead.

    The in-memory store that raised this must be discarded; the
    :class:`DurableMedia` it was writing to survives and can be handed to
    a fresh store's ``recover()``.
    """


@dataclass(frozen=True)
class CrashPoint:
    """A deterministic kill point, armed via :meth:`DurableMedia.schedule_crash`.

    ``wal_bytes``: die during the fsync that would carry the durable WAL
    past this absolute byte offset, truncating it there (torn tail).
    ``file_writes``: die on the N-th subsequent atomic file publish
    (1-based), before the file lands — segment/manifest/WAL-reset writes
    all count, so N selects mid-flush vs mid-compaction deaths.
    """

    wal_bytes: Optional[int] = None
    file_writes: Optional[int] = None


@dataclass(frozen=True)
class RecoveryResult:
    """What ``LsmStore.recover()`` rebuilt, for assertions and spans."""

    segments: int            # durable runs loaded from the manifest
    batches_replayed: int    # WAL records above the horizon -> memtable
    batches_skipped: int     # WAL records <= horizon (already in segments)
    bytes_replayed: int      # WAL bytes applied (billed once, to bytes_recovered)
    torn_bytes: int          # trailing bytes discarded by CRC framing
    horizon: int             # manifest horizon (highest segment-covered seq)
    last_seq: int            # highest seq restored (continues numbering)


class DurableMedia:
    """One vnode's simulated disk: durable WAL bytes + published files.

    Writes are buffered (``wal_append``) until ``wal_sync`` — the fsync —
    moves them into the durable log.  File publishes (``write_file``,
    ``wal_reset``) are atomic: they either land whole or, under an armed
    :class:`CrashPoint`, not at all.  ``crash()`` models power loss: the
    unsynced buffer is gone, counters and durable state remain.
    """

    def __init__(self) -> None:
        self.files: Dict[str, bytes] = {}
        self.wal = bytearray()          # durable (fsynced) log bytes
        self._buffer = bytearray()      # written, not yet fsynced
        self.wal_fsyncs = 0             # group-commit fsyncs issued
        self.file_fsyncs = 0            # atomic file publishes
        self.crashes = 0
        self._crash: Optional[CrashPoint] = None
        self._file_writes_seen = 0

    # --------------------------------------------------------------- faults
    def schedule_crash(self, point: CrashPoint) -> None:
        """Arm a kill point; the matching write raises :class:`CrashError`."""
        self._crash = point
        self._file_writes_seen = 0

    def crash(self) -> None:
        """Power loss: drop the unsynced buffer, disarm any kill point."""
        self._buffer.clear()
        self._crash = None
        self.crashes += 1

    def _check_file_crash(self) -> None:
        cp = self._crash
        if cp is not None and cp.file_writes is not None:
            self._file_writes_seen += 1
            if self._file_writes_seen >= cp.file_writes:
                raise CrashError(
                    f"crashed on file publish #{self._file_writes_seen}")

    # ------------------------------------------------------------------ WAL
    def wal_append(self, data: bytes) -> None:
        """Buffer bytes at the log tail; durable only after ``wal_sync``."""
        self._buffer.extend(data)

    def wal_pending(self) -> int:
        """Bytes written but not yet fsynced (lost by a crash)."""
        return len(self._buffer)

    def wal_sync(self) -> None:
        """fsync: move the buffer into the durable log (one group commit).

        Under an armed ``wal_bytes`` kill point the fsync dies mid-write:
        the durable log is truncated at exactly that offset — usually in
        the middle of a record — and :class:`CrashError` is raised.
        """
        if not self._buffer:
            return
        cp = self._crash
        if cp is not None and cp.wal_bytes is not None \
                and len(self.wal) + len(self._buffer) >= cp.wal_bytes:
            keep = max(cp.wal_bytes - len(self.wal), 0)
            self.wal.extend(self._buffer[:keep])
            raise CrashError(
                f"crashed mid-fsync: durable WAL torn at byte {len(self.wal)}")
        self.wal.extend(self._buffer)
        self._buffer.clear()
        self.wal_fsyncs += 1

    def wal_drop_buffer(self) -> None:
        """Discard unsynced bytes made redundant by a durable flush."""
        self._buffer.clear()

    def wal_reset(self, data: bytes = b"") -> None:
        """Atomically replace the log (write-temp + rename, one publish)."""
        self._check_file_crash()
        self.wal = bytearray(data)
        self._buffer.clear()
        self.file_fsyncs += 1

    # ---------------------------------------------------------------- files
    def write_file(self, name: str, data: bytes) -> None:
        """Atomically publish a file; crash points fire *before* it lands."""
        self._check_file_crash()
        self.files[name] = bytes(data)
        self.file_fsyncs += 1

    def read_file(self, name: str) -> Optional[bytes]:
        return self.files.get(name)

    def delete_file(self, name: str) -> None:
        self.files.pop(name, None)


# -------------------------------------------------------------- WAL framing
def encode_wal_record(seq: int, items: List[Tuple[bytes, bytes]]) -> bytes:
    """Frame one write batch: ``<len, crc>`` + ``<seq, n>`` + k/v pairs."""
    parts = [_BODY_HDR.pack(seq, len(items))]
    for k, v in items:
        parts.append(_ITEM_HDR.pack(len(k), len(v)))
        parts.append(k)
        parts.append(v)
    body = b"".join(parts)
    return _HDR.pack(len(body), zlib.crc32(body)) + body


@dataclass(frozen=True)
class WalRecord:
    seq: int
    items: Tuple[Tuple[bytes, bytes], ...]
    nbytes: int  # framed size (header + body)


def decode_wal(data: bytes) -> Tuple[List[WalRecord], int]:
    """Decode records until the first torn/corrupt frame.

    Returns ``(records, torn_bytes)`` — the trailing bytes that failed
    length or CRC framing.  A torn tail is *expected* after a mid-fsync
    crash and is silently discarded by recovery; only bytes before it
    were ever acknowledged.
    """
    records: List[WalRecord] = []
    off = 0
    n = len(data)
    while off < n:
        if n - off < _HDR.size:
            break  # torn header
        body_len, crc = _HDR.unpack_from(data, off)
        body_start = off + _HDR.size
        if n - body_start < body_len:
            break  # torn body
        body = data[body_start:body_start + body_len]
        if zlib.crc32(body) != crc:
            break  # corrupt frame: stop replay here
        seq, n_items = _BODY_HDR.unpack_from(body, 0)
        pos = _BODY_HDR.size
        items: List[Tuple[bytes, bytes]] = []
        ok = True
        for _ in range(n_items):
            if len(body) - pos < _ITEM_HDR.size:
                ok = False
                break
            klen, vlen = _ITEM_HDR.unpack_from(body, pos)
            pos += _ITEM_HDR.size
            if len(body) - pos < klen + vlen:
                ok = False
                break
            items.append((body[pos:pos + klen], body[pos + klen:pos + klen + vlen]))
            pos += klen + vlen
        if not ok:
            break  # CRC passed but framing is inconsistent: treat as torn
        records.append(WalRecord(seq, tuple(items), _HDR.size + body_len))
        off = body_start + body_len
    return records, n - off


# ----------------------------------------------------------- segment framing
def encode_segment(items: List[Tuple[bytes, bytes]]) -> bytes:
    """Frame one immutable sorted run (same CRC framing as WAL records)."""
    parts = [struct.pack("<I", len(items))]
    for k, v in items:
        parts.append(_ITEM_HDR.pack(len(k), len(v)))
        parts.append(k)
        parts.append(v)
    body = b"".join(parts)
    return _HDR.pack(len(body), zlib.crc32(body)) + body


def decode_segment(data: bytes) -> List[Tuple[bytes, bytes]]:
    """Decode a published segment; corruption here is fatal, not torn.

    Segments are published atomically — unlike the WAL there is no legal
    partial state, so any framing failure raises :class:`WalError`.
    """
    if len(data) < _HDR.size:
        raise WalError("segment shorter than its header")
    body_len, crc = _HDR.unpack(data[:_HDR.size])
    body = data[_HDR.size:]
    if len(body) != body_len or zlib.crc32(body) != crc:
        raise WalError("segment failed CRC framing")
    (count,) = struct.unpack_from("<I", body, 0)
    pos = 4
    items: List[Tuple[bytes, bytes]] = []
    for _ in range(count):
        if len(body) - pos < _ITEM_HDR.size:
            raise WalError("segment item header truncated")
        klen, vlen = _ITEM_HDR.unpack_from(body, pos)
        pos += _ITEM_HDR.size
        if len(body) - pos < klen + vlen:
            raise WalError("segment item payload truncated")
        items.append((body[pos:pos + klen], body[pos + klen:pos + klen + vlen]))
        pos += klen + vlen
    return items


# ---------------------------------------------------------------- manifest
def encode_manifest(segments: List[str], horizon: int, next_seg: int) -> bytes:
    return msgpack.packb(
        {"segments": list(segments), "horizon": horizon, "next_seg": next_seg},
        use_bin_type=True)


def decode_manifest(data: Optional[bytes]) -> Tuple[List[str], int, int]:
    """Returns ``(segments newest-first, horizon, next_seg)``; empty-media
    defaults when no manifest was ever published."""
    if data is None:
        return [], 0, 0
    doc = msgpack.unpackb(data, raw=False)
    return list(doc["segments"]), int(doc["horizon"]), int(doc["next_seg"])
