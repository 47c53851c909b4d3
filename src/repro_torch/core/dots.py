"""Dots — the unit of causality in bigset.

A *dot* is a pair ``(actor, counter)`` naming the ``counter``-th event performed
by ``actor`` (Almeida et al., "Scalable and accurate causality tracking").  Every
insert of an element into a bigset is tagged with a fresh dot minted by the
coordinating vnode; the dot is the element-key's causal identity and the unit
that set-clocks and set-tombstones track.

PyTorch port: a copy of :mod:`repro.core.dots`; everything below
this docstring is unchanged.
"""
from __future__ import annotations

from typing import Any, Iterable, NamedTuple, Tuple

ActorId = Any  # opaque, hashable, totally ordered (bytes/str/int)


class Dot(NamedTuple):
    actor: ActorId
    counter: int

    def __repr__(self) -> str:  # compact debugging
        return f"{self.actor}:{self.counter}"


DotList = Tuple[Dot, ...]


def as_dot(x: "Dot | Tuple[ActorId, int]") -> Dot:
    if isinstance(x, Dot):
        return x
    a, c = x
    if not isinstance(c, int) or c < 1:
        raise ValueError(f"dot counter must be a positive int, got {c!r}")
    return Dot(a, c)


def sort_dots(dots: Iterable[Dot]) -> DotList:
    return tuple(sorted(as_dot(d) for d in dots))


def dot_from_key(actor: ActorId, counter: int) -> Dot:
    """Dot from decoded storage-key components.

    The key codec round-trips string actors as utf-8 bytes; this is the one
    place that mapping is undone, shared by element-key and posting-key
    decoding so the two can never drift.
    """
    return Dot(actor.decode() if isinstance(actor, bytes) else actor, counter)
