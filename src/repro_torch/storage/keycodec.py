"""Order-preserving tuple -> bytes key codec and the bigset key kinds.

leveldb (and our LSM stand-in) orders keys lexicographically by raw bytes.
Bigset requires element-keys to sort by ``(set, kind, element, actor,
counter)`` so that (a) a set's keyspace is one contiguous range, (b) the
clock/tombstone keys sort *before* the element keys of the same set, and
(c) element keys sort by element then dot — the property that enables the
§4.4 streaming ORSWOT join and range queries.

The *kind* byte partitions a set's keyspace into sub-ranges:

* ``KIND_CLOCK``     — ``(set, 0)``: the serialized set-clock
* ``KIND_TOMBSTONE`` — ``(set, 1)``: the serialized set-tombstone
* ``KIND_ELEMENT``   — ``(set, 2, element, actor, counter)``: one per insert
* ``KIND_INDEX``     — ``(set, 3, index_name, index_key, element, actor,
  counter)``: secondary-index postings, mirroring element-keys dot-for-dot
  (a posting is live iff its dot is live under the same set-tombstone)

Components supported: ``bytes``/``str`` (escaped, terminator-based) and
non-negative ``int`` (fixed 8-byte big-endian).  Escaping maps ``0x00`` to
``0x00 0x01`` and terminates with ``0x00 0x00``, preserving order.

PyTorch port: a copy of :mod:`repro.storage.keycodec`; everything below
this docstring is unchanged.
"""
from __future__ import annotations

import struct
from typing import Tuple

class KeyCodecError(ValueError):
    """Malformed, truncated, or out-of-range key material.

    Typed (and a ``ValueError`` subclass, so pre-existing handlers keep
    working) rather than an assert or a leaked ``struct.error``: the
    ``python -O`` CI job runs with asserts stripped, and sync/serve paths
    decode peer-supplied keys — they must fail loudly on garbage.
    """


KIND_CLOCK = 0
KIND_TOMBSTONE = 1
KIND_ELEMENT = 2
KIND_INDEX = 3

_STR_TAG = b"\x01"
_INT_TAG = b"\x02"
_TERM = b"\x00\x00"
_ESC = b"\x00\x01"


def encode_key(parts: Tuple) -> bytes:
    out = bytearray()
    for p in parts:
        if isinstance(p, str):
            p = p.encode("utf-8")
        if isinstance(p, (bytes, bytearray)):
            out += _STR_TAG
            out += bytes(p).replace(b"\x00", _ESC)
            out += _TERM
        elif isinstance(p, int):
            if p < 0 or p >= 1 << 64:
                raise KeyCodecError(f"int key component out of range: {p}")
            out += _INT_TAG
            out += struct.pack(">Q", p)
        else:
            raise TypeError(f"unsupported key component type: {type(p)!r}")
    return bytes(out)


def decode_key(key: bytes) -> Tuple:
    parts = []
    i = 0
    n = len(key)
    while i < n:
        tag = key[i : i + 1]
        i += 1
        if tag == _STR_TAG:
            buf = bytearray()
            while True:
                j = key.find(b"\x00", i)
                if j < 0:
                    raise KeyCodecError(
                        f"unterminated string component at offset {i}")
                nxt = key[j : j + 2]
                if nxt == _TERM:
                    buf += key[i:j]
                    i = j + 2
                    break
                elif nxt == _ESC:
                    buf += key[i:j] + b"\x00"
                    i = j + 2
                else:
                    raise KeyCodecError(
                        f"malformed escape at offset {j} in string component")
            parts.append(bytes(buf))
        elif tag == _INT_TAG:
            if n - i < 8:
                raise KeyCodecError(
                    f"truncated int component at offset {i}: "
                    f"{n - i} of 8 bytes")
            parts.append(struct.unpack(">Q", key[i : i + 8])[0])
            i += 8
        else:
            raise KeyCodecError(f"bad tag byte {tag!r} at offset {i - 1}")
    return tuple(parts)


def successor_bytes(b: bytes) -> bytes:
    """The immediate successor of ``b`` in bytes order (``b + b"\\x00"``).

    Used to turn an inclusive component bound into the exclusive bound of
    the next value: in the order-preserving codec, ``encode_key((.., x))``
    through ``encode_key((.., successor_bytes(x)))`` spans exactly the keys
    whose component equals ``x`` plus all of their extensions.
    """
    return b + b"\x00"


def prefix_bounds(parts: Tuple) -> Tuple[bytes, bytes]:
    """Encoded ``[lo, hi)`` bounds covering every key extending ``parts``.

    ``hi`` is the encoded prefix followed by ``0xff``: component tags are
    ``0x01``/``0x02``, so no well-formed key extending the prefix can reach
    it, and any key with a different component diverges before it.
    """
    lo = encode_key(parts)
    return lo, lo + b"\xff"
