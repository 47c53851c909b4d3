"""Posting keys — the secondary-index keyspace inside a set's key range.

A posting is ``(set, KIND_INDEX, index_name, index_key, element, actor,
counter) -> b""``: the element-key of an insert, re-sorted by the index key
its extractor produced.  Postings live in the *same* LSM keyspace as the
element-keys they mirror and under the same set-clock / set-tombstone:

* written in the same atomic batch as the element-key (coordinator and
  downstream replica alike, re-derived from the delta's element + value);
* live iff their dot is live — visibility is the same batched
  ``tombstone.seen(dot)`` filter the element scan uses;
* discarded by the same compaction filter, in the same pass, as the
  element-key that shares their dot.  There is no separate index GC.

``KIND_INDEX`` sorts immediately after ``KIND_ELEMENT``, so element scans
(`element_bounds`) and posting scans never overlap, and a set remains one
contiguous key range.

PyTorch port: a copy of :mod:`repro.index.postings`; everything below
this docstring is unchanged.
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..core.dots import Dot, dot_from_key
from ..storage.keycodec import (KIND_INDEX, decode_key, encode_key,
                                prefix_bounds, successor_bytes)

# (index_key, element): the sort position of one posting group
Position = Tuple[bytes, bytes]


def posting_key(
    set_name: bytes, index_name: bytes, index_key: bytes,
    element: bytes, dot: Dot,
) -> bytes:
    return encode_key((set_name, KIND_INDEX, index_name, index_key,
                       element, dot.actor, dot.counter))


def decode_posting_key(key: bytes) -> Tuple[bytes, bytes, bytes, bytes, Dot]:
    """Decode ``(set_name, index_name, index_key, element, dot)``.

    Raises :class:`ValueError` for any other key kind — postings share the
    keyspace with clocks and element-keys, and a silent mis-decode would
    fabricate a garbage dot.
    """
    parts = decode_key(key)
    if len(parts) != 7 or parts[1] != KIND_INDEX:
        raise ValueError(f"not an index posting key: {parts!r}")
    set_name, _kind, index_name, index_key, element, actor, counter = parts
    return set_name, index_name, index_key, element, dot_from_key(
        actor, counter)


def index_range(set_name: bytes, index_name: bytes) -> Tuple[bytes, bytes]:
    """Bounds of one whole index's posting range."""
    return prefix_bounds((set_name, KIND_INDEX, index_name))


def index_bounds(
    set_name: bytes,
    index_name: bytes,
    start: Optional[bytes] = None,
    end: Optional[bytes] = None,
    at: Optional[Position] = None,
    after: Optional[Position] = None,
) -> Tuple[bytes, bytes]:
    """Encoded posting bounds for index keys in ``[start, end)``.

    ``at``/``after`` position the scan at a ``(index_key, element)`` group
    boundary for cursor resumption: ``at`` starts *at* the group (a page
    that emitted nothing), ``after`` strictly past every posting of the
    group (``element + b"\\x00"`` upper-bounds the group, exactly as the
    element-keyspace cursor does).  They win over ``start``.
    """
    if after is not None:
        ik, el = after
        lo = encode_key(
            (set_name, KIND_INDEX, index_name, ik, successor_bytes(el)))
    elif at is not None:
        ik, el = at
        lo = encode_key((set_name, KIND_INDEX, index_name, ik, el))
    elif start is not None:
        lo = encode_key((set_name, KIND_INDEX, index_name, start))
    else:
        lo = encode_key((set_name, KIND_INDEX, index_name))
    if end is not None:
        hi = encode_key((set_name, KIND_INDEX, index_name, end))
    else:
        hi = index_range(set_name, index_name)[1]
    return lo, hi


def lookup_span(key: bytes) -> Tuple[bytes, bytes]:
    """The ``[start, end)`` index-key span matching exactly ``key``."""
    return key, successor_bytes(key)
