"""Logical query plans over bigsets (paper §4.4).

A plan is a small frozen dataclass naming *what* to compute; the streaming
executor (:mod:`repro.query.executor`) decides *how* — which LSM seeks to
issue, how to batch visibility filtering, when to stop.  Plans are
deliberately storage-agnostic so the cluster layer can scatter the same plan
to every replica and quorum-merge the partial results.

Supported shapes:

* :class:`Membership` — is ``element`` in the set (plus its causal context)?
  A single seek (§4.4: "querying for a lone element ... only requires a
  seek, not a full set fold").
* :class:`Range` — ordered members in ``[start, end)``, optionally limited
  and resumable via a cursor.
* :class:`Count` — cardinality of a range without materialising it.
* :class:`Scan` — full-set pagination: a Range with a page size, built for
  cursoring through million-element sets.
* :class:`Join` — cross-set streaming intersect/union/difference, a zipper
  over two lexicographic element streams (§4.4's streaming ORSWOT join
  generalised to two sets).
* :class:`IndexLookup` — elements whose registered secondary index
  (:mod:`repro.index`) produced exactly ``key``: a seek into the posting
  range, never an element fold.
* :class:`IndexRange` — elements whose index key falls in ``[start, end)``,
  streamed in ``(index_key, element)`` order with limit/cursor pagination.

PyTorch port: a copy of :mod:`repro.query.plan`; everything below
this docstring is unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import msgpack

from ..index.postings import lookup_span

JOIN_KINDS = ("intersect", "union", "difference")
JOIN_STRATEGIES = ("zipper", "gallop")


class PlanError(ValueError):
    """Raised for malformed or unsupported plans."""


@dataclass(frozen=True)
class Membership:
    set_name: bytes
    element: bytes


@dataclass(frozen=True)
class Range:
    set_name: bytes
    start: Optional[bytes] = None   # inclusive; None = set start
    end: Optional[bytes] = None     # exclusive; None = set end
    limit: Optional[int] = None     # max elements returned
    cursor: Optional[bytes] = None  # opaque resume token (wins over start)


@dataclass(frozen=True)
class Count:
    set_name: bytes
    start: Optional[bytes] = None
    end: Optional[bytes] = None


@dataclass(frozen=True)
class Scan:
    set_name: bytes
    page_size: int = 1000
    cursor: Optional[bytes] = None


@dataclass(frozen=True)
class Join:
    """Cross-set streaming join.

    Result entry dots belong to the *left* set's clock domain when the
    element is present there, otherwise the right set's — they are a causal
    context for that set only, never a blend of both (each set has its own
    clock, so equal dots name unrelated inserts across sets).

    ``strategy`` pins the executor's algorithm (``"zipper"`` zippers both
    ordered streams end-to-end; ``"gallop"`` drives the smaller side and
    probes the larger with bounded storage seeks); ``None`` — the default —
    lets the cost-based planner (:mod:`repro.query.planner`) choose from
    LSM run statistics.  The strategy never changes the result, only its
    cost, so it is deliberately **not** part of the cursor scope: a scan
    may switch strategy between pages as statistics shift.
    """

    kind: str                       # intersect | union | difference
    left: bytes                     # left set name
    right: bytes                    # right set name
    limit: Optional[int] = None
    cursor: Optional[bytes] = None
    strategy: Optional[str] = None  # zipper | gallop | None = planner picks


@dataclass(frozen=True)
class IndexLookup:
    """Exact-match probe of one secondary index (``index key == key``)."""

    set_name: bytes
    index: bytes                    # index name (IndexSpec.name)
    key: bytes                      # exact index key to match
    limit: Optional[int] = None
    cursor: Optional[bytes] = None


@dataclass(frozen=True)
class IndexRange:
    """Index-ordered scan over ``[start, end)`` of one secondary index.

    Results stream in ``(index_key, element)`` order — an element appears
    once per matching index key (multi-valued extractors may match several
    times), each carrying its full surviving dot context.
    """

    set_name: bytes
    index: bytes
    start: Optional[bytes] = None   # inclusive; None = index start
    end: Optional[bytes] = None     # exclusive; None = index end
    limit: Optional[int] = None
    cursor: Optional[bytes] = None  # opaque resume token


Plan = Union[Membership, Range, Count, Scan, Join, IndexLookup, IndexRange]
IndexPlan = Union[IndexLookup, IndexRange]


def index_span(plan: IndexPlan) -> Tuple[Optional[bytes], Optional[bytes]]:
    """Normalise an index plan to its ``[start, end)`` index-key span.

    A lookup is the degenerate range matching exactly ``key`` — both shapes
    share one executor path, one cursor scope, and one quorum merge.
    """
    if isinstance(plan, IndexLookup):
        return lookup_span(plan.key)
    return plan.start, plan.end


def validate(plan: Plan) -> Plan:
    """Check a plan's invariants; returns the plan for chaining."""
    if isinstance(plan, Membership):
        if not plan.set_name or plan.element is None:
            raise PlanError("membership needs a set name and an element")
    elif isinstance(plan, Range):
        if not plan.set_name:
            raise PlanError("range needs a set name")
        if plan.limit is not None and plan.limit < 0:
            raise PlanError("range limit must be >= 0")
        if (plan.start is not None and plan.end is not None
                and plan.start >= plan.end):
            raise PlanError("empty range: start >= end")
    elif isinstance(plan, Count):
        if not plan.set_name:
            raise PlanError("count needs a set name")
        if (plan.start is not None and plan.end is not None
                and plan.start >= plan.end):
            raise PlanError("empty range: start >= end")
    elif isinstance(plan, Scan):
        if not plan.set_name:
            raise PlanError("scan needs a set name")
        if plan.page_size <= 0:
            raise PlanError("scan page_size must be > 0")
    elif isinstance(plan, Join):
        if plan.kind not in JOIN_KINDS:
            raise PlanError(f"unknown join kind {plan.kind!r}")
        if not plan.left or not plan.right:
            raise PlanError("join needs two set names")
        if plan.limit is not None and plan.limit < 0:
            raise PlanError("join limit must be >= 0")
        if plan.strategy is not None and plan.strategy not in JOIN_STRATEGIES:
            raise PlanError(
                f"unknown join strategy {plan.strategy!r} "
                f"(expected one of {JOIN_STRATEGIES} or None)")
    elif isinstance(plan, IndexLookup):
        if not plan.set_name or not plan.index:
            raise PlanError("index lookup needs a set name and an index name")
        if plan.key is None:
            raise PlanError("index lookup needs a key")
        if plan.limit is not None and plan.limit < 0:
            raise PlanError("index lookup limit must be >= 0")
    elif isinstance(plan, IndexRange):
        if not plan.set_name or not plan.index:
            raise PlanError("index range needs a set name and an index name")
        if plan.limit is not None and plan.limit < 0:
            raise PlanError("index range limit must be >= 0")
        if (plan.start is not None and plan.end is not None
                and plan.start >= plan.end):
            raise PlanError("empty index range: start >= end")
    else:
        raise PlanError(f"unknown plan type {type(plan).__name__}")
    return plan


# ------------------------------------------------------------- wire codec
# The serve layer (:mod:`repro.serve.bigset_service`) ships plans between
# client and service as a versioned msgpack envelope: ``[version, shape,
# fields]``.  Field maps (not positional tuples) so shapes can grow fields
# without breaking older tokensets; bytes stay bytes under msgpack, so set
# names and range bounds round-trip exactly.
PLAN_WIRE_VERSION = 1

_WIRE_SHAPES = {
    Membership: "membership",
    Range: "range",
    Count: "count",
    Scan: "scan",
    Join: "join",
    IndexLookup: "index_lookup",
    IndexRange: "index_range",
}
_SHAPE_TYPES = {tag: cls for cls, tag in _WIRE_SHAPES.items()}


def plan_to_wire(plan: Plan) -> bytes:
    """Encode a validated plan as its wire envelope (every shape)."""
    validate(plan)
    shape = _WIRE_SHAPES[type(plan)]
    fields = {
        f: getattr(plan, f) for f in type(plan).__dataclass_fields__
    }
    return msgpack.packb([PLAN_WIRE_VERSION, shape, fields])


def plan_from_wire(blob: bytes) -> Plan:
    """Decode and validate a wire envelope back into a plan.

    Raises :class:`PlanError` for anything malformed — undecodable bytes,
    unknown versions or shapes, missing or extra fields — so the serve
    layer can map every bad request to one error path.
    """
    try:
        envelope = msgpack.unpackb(blob)
    except Exception as e:
        raise PlanError(f"undecodable plan envelope: {e}") from None
    if not (isinstance(envelope, (list, tuple)) and len(envelope) == 3):
        raise PlanError(f"malformed plan envelope: {envelope!r}")
    version, shape, fields = envelope
    if version != PLAN_WIRE_VERSION:
        raise PlanError(f"unsupported plan wire version {version!r}")
    cls = _SHAPE_TYPES.get(shape)
    if cls is None:
        raise PlanError(f"unknown plan shape {shape!r}")
    if not isinstance(fields, dict):
        raise PlanError("plan fields must be a map")
    known = set(cls.__dataclass_fields__)
    unknown = set(fields) - known
    if unknown:
        raise PlanError(f"unknown {shape} fields {sorted(unknown)}")
    try:
        plan = cls(**fields)
    except TypeError as e:
        raise PlanError(f"bad {shape} fields: {e}") from None
    return validate(plan)


def cursor_scope(plan: Plan) -> bytes:
    """The scope a cursor is valid for — tokens must not cross query shapes.

    Components are length-delimited (msgpack), not joined with a separator:
    ``Range(b"a:b")`` and ``Range(b"a", start=b"b:")`` must never share a
    scope, or one query's cursor would resume the other.
    """
    if isinstance(plan, (Range, Count)):
        return msgpack.packb(
            ["range", plan.set_name, plan.start or b"", plan.end or b""])
    if isinstance(plan, Scan):
        return msgpack.packb(["scan", plan.set_name])
    if isinstance(plan, Join):
        # strategy is deliberately not part of the scope: both strategies
        # emit the same element sequence, so a cursor minted under one
        # must resume under the other (the planner may flip mid-scan)
        return msgpack.packb(["join", plan.kind, plan.left, plan.right])
    if isinstance(plan, (IndexLookup, IndexRange)):
        start, end = index_span(plan)
        return msgpack.packb(
            ["index", plan.set_name, plan.index, start or b"", end or b""])
    raise PlanError(f"plan {type(plan).__name__} does not paginate")
