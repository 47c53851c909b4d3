"""Streaming ORSWOT join (paper §4.4).

    "Bigset has a novel streaming ORSWOT CRDT Join operation, that is able
     to perform a merge on subsets of an ORSWOT.  This is enabled by the
     fact that the set element keys are stored and therefore streamed in
     lexicographical element order."

Given R replica streams — each a :class:`~repro.core.bigset.ReadStream`
(a fixed clock plus entries in lexicographic element order) — the merge is a
k-way ordered merge.  For each element the surviving dots are computed with
the standard optimized-OR-set rule against the *other* streams' clocks:

    keep(d from stream i) = d present in every stream that has the element,
                            OR d unseen by the clock of every stream missing d

Because each stream's clock is fixed for the whole read, a window of one
element suffices: the merge is O(1) memory and can paginate / early-exit —
this is what makes membership and range queries on a quorum possible
without materialising the full set.

PyTorch port: a copy of :mod:`repro.core.streaming`; everything below
this docstring is unchanged.
"""
from __future__ import annotations

import heapq
from typing import Dict, FrozenSet, Iterable, Iterator, List, Sequence, Tuple

from .clock import Clock
from .dots import Dot
from .orswot import Orswot


class _PeekStream:
    __slots__ = ("clock", "_it", "head")

    def __init__(self, clock: Clock, entries: Iterable[Tuple[bytes, Tuple[Dot, ...]]]):
        self.clock = clock
        self._it = iter(entries)
        self.head = next(self._it, None)

    def pop(self):
        h = self.head
        self.head = next(self._it, None)
        return h


def merge_entry(
    per_stream_dots: Sequence[FrozenSet[Dot] | None], clocks: Sequence[Clock]
) -> FrozenSet[Dot]:
    """Surviving dots for one element across R streams.

    ``per_stream_dots[i]`` is None when stream i did not list the element
    (equivalently: it has no surviving dots for it).
    """
    survivors = set()
    all_dots = set()
    for ds in per_stream_dots:
        if ds:
            all_dots |= ds
    for d in all_dots:
        ok = True
        for ds, ck in zip(per_stream_dots, clocks):
            if ds is not None and d in ds:
                continue
            # stream lacks d: d survives only if that stream never saw it
            if ck.seen(d):
                ok = False
                break
        if ok:
            survivors.add(d)
    return frozenset(survivors)


def streaming_join(
    streams: Sequence[Tuple[Clock, Iterable[Tuple[bytes, Tuple[Dot, ...]]]]],
) -> Iterator[Tuple[bytes, FrozenSet[Dot]]]:
    """K-way streaming merge of replica read streams.

    Yields (element, surviving dots) for surviving elements, in element
    order.  Never holds more than one element per stream in memory.
    """
    ps = [_PeekStream(c, e) for c, e in streams]
    clocks = [p.clock for p in ps]
    heap: List[Tuple[bytes, int]] = [
        (p.head[0], i) for i, p in enumerate(ps) if p.head is not None
    ]
    heapq.heapify(heap)
    while heap:
        element = heap[0][0]
        per_stream: List[FrozenSet[Dot] | None] = [None] * len(ps)
        while heap and heap[0][0] == element:
            _, i = heapq.heappop(heap)
            per_stream[i] = frozenset(ps[i].pop()[1])
            if ps[i].head is not None:
                heapq.heappush(heap, (ps[i].head[0], i))
        dots = merge_entry(per_stream, clocks)
        if dots:
            yield element, dots


def quorum_read(
    streams: Sequence[Tuple[Clock, Iterable[Tuple[bytes, Tuple[Dot, ...]]]]],
) -> Orswot:
    """Materialise a quorum read as a classic ORSWOT (clock = join of clocks)."""
    clock = Clock.zero()
    for c, _ in streams:
        clock = clock.join(c)
    entries: Dict[bytes, FrozenSet[Dot]] = {}
    for element, dots in streaming_join(streams):
        entries[element] = dots
    return Orswot(clock, entries)


def quorum_is_member(
    probes: Sequence[Tuple[Clock, FrozenSet[Dot] | None]],
) -> Tuple[bool, Tuple[Dot, ...]]:
    """Membership across a quorum from per-replica ``is_member`` probes."""
    clocks = [c for c, _ in probes]
    per_stream = [ds for _, ds in probes]
    dots = merge_entry(per_stream, clocks)
    return bool(dots), tuple(sorted(dots))
