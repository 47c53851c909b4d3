"""Index specs — pluggable extractors from element/value to index keys.

An :class:`IndexSpec` names a secondary index and supplies its extractor:
``extract(element, value) -> iterable of index keys``.  The extractor must
be **deterministic** — downstream replicas re-derive postings from the
replicated :class:`~repro.core.bigset.InsertDelta` (which carries element
and value), so no index data ever travels on the wire.  An extractor that
yields nothing leaves the insert unindexed under that index; yielding
several keys builds a multi-valued index.

Extractors run on the write path (and during backfill), so they should be
cheap and must never raise: malformed payloads yield no keys.

PyTorch port: a copy of :mod:`repro.index.spec`; everything below
this docstring is unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Tuple

import msgpack

Extractor = Callable[[bytes, bytes], Iterable[bytes]]


@dataclass(frozen=True)
class IndexSpec:
    """A named secondary index over one bigset.

    ``name`` scopes the index's posting range inside the set's keyspace;
    two specs with the same name on one set are the same index (last
    registration wins).
    """

    name: bytes
    extract: Extractor

    def keys(self, element: bytes, value: bytes) -> Tuple[bytes, ...]:
        """Extractor call with the never-raise contract enforced."""
        try:
            return tuple(self.extract(element, value))
        except Exception:
            return ()


# ------------------------------------------------------- standard extractors
def by_value(name: bytes = b"value") -> IndexSpec:
    """Index each insert under its whole value payload (empty values skip)."""
    return IndexSpec(name, lambda el, v: (v,) if v else ())


def by_value_prefix(n: int, name: bytes | None = None) -> IndexSpec:
    """Index under the first ``n`` bytes of the value (empty values skip)."""
    return IndexSpec(
        name or b"value_prefix:%d" % n,
        lambda el, v: (v[:n],) if v else ())


def by_element_prefix(n: int, name: bytes | None = None) -> IndexSpec:
    """Index under the first ``n`` bytes of the element itself."""
    return IndexSpec(name or b"element_prefix:%d" % n, lambda el, v: (el[:n],))


def by_element_suffix(n: int, name: bytes | None = None) -> IndexSpec:
    """Index under the last ``n`` bytes of the element (hash-bucket style)."""
    return IndexSpec(name or b"element_suffix:%d" % n, lambda el, v: (el[-n:],))


def by_length(name: bytes = b"length") -> IndexSpec:
    """Index under the value length, fixed-width so keys sort numerically."""
    return IndexSpec(name, lambda el, v: (b"%012d" % len(v),))


def by_field(field: bytes, name: bytes | None = None) -> IndexSpec:
    """Index under one field of a msgpack-map value (absent/bad -> no keys).

    The field's value is indexed as bytes (str values are utf-8 encoded);
    non-scalar fields are skipped.
    """

    def extract(el: bytes, v: bytes) -> Iterable[bytes]:
        obj = msgpack.unpackb(v, strict_map_key=False)
        if not isinstance(obj, dict):
            return ()
        got = obj.get(field, obj.get(field.decode("utf-8", "replace")))
        if isinstance(got, bytes):
            return (got,)
        if isinstance(got, str):
            return (got.encode("utf-8"),)
        if isinstance(got, int) and 0 <= got < 1 << 63:
            return (b"%020d" % got,)
        return ()

    return IndexSpec(name or b"field:" + field, extract)
