"""State-based ORSWOT — the Riak Sets baseline (paper §2).

An Observe-Remove Set WithOut Tombstones (Bieniusa et al., "An optimized
conflict-free replicated set").  State is ``(clock, entries)`` where
``entries`` maps each present element to its minimal set of surviving dots.
Riak stores this whole structure as one opaque blob inside a riak-object —
which is exactly the O(n)-per-write behaviour the paper's bigset removes.

The ``entries`` clock here is generalised to gappy :class:`~repro.core.clock.Clock`
values so that the same ``merge`` implements both full-state joins and
delta-state joins (a delta is simply a small ORSWOT whose clock covers only
the dots it mentions) — see :mod:`repro.core.delta_orswot`.

PyTorch port: a copy of :mod:`repro.core.orswot`; everything below
this docstring is unchanged.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, Mapping, Tuple

from .clock import Clock
from .dots import ActorId, Dot


class Orswot:
    __slots__ = ("clock", "entries")

    def __init__(
        self,
        clock: Clock | None = None,
        entries: Mapping[object, FrozenSet[Dot]] | None = None,
    ):
        self.clock: Clock = clock or Clock.zero()
        self.entries: Mapping[object, FrozenSet[Dot]] = {
            e: frozenset(ds) for e, ds in (entries or {}).items() if ds
        }

    # ----------------------------------------------------------------- api
    @staticmethod
    def new() -> "Orswot":
        return Orswot()

    def value(self) -> FrozenSet[object]:
        return frozenset(self.entries)

    def __contains__(self, element: object) -> bool:
        return element in self.entries

    def __len__(self) -> int:
        return len(self.entries)

    def context_of(self, element: object) -> Tuple[Dot, ...]:
        """The causal context a client would supply to remove/re-add element."""
        return tuple(sorted(self.entries.get(element, frozenset())))

    # ------------------------------------------------------------- mutators
    def add(self, actor: ActorId, element: object) -> "Orswot":
        """Coordinator-side add: mint a dot, replace all prior dots of element.

        The replaced dots stay covered by the clock, so merges at other
        replicas discard them (add-wins, no tombstones).
        """
        clock, dot = self.clock.increment(actor)
        entries = dict(self.entries)
        entries[element] = frozenset((dot,))
        return Orswot(clock, entries)

    def remove(self, element: object, ctx: Iterable[Dot] | None = None) -> "Orswot":
        """Remove the element's *observed* dots (those in ``ctx``; all if None)."""
        cur = self.entries.get(element)
        if cur is None:
            return self
        drop = frozenset(ctx) if ctx is not None else cur
        keep = cur - drop
        entries = dict(self.entries)
        if keep:
            entries[element] = keep
        else:
            del entries[element]
        return Orswot(self.clock, entries)

    # ---------------------------------------------------------------- merge
    def merge(self, other: "Orswot") -> "Orswot":
        """Join two ORSWOT states (also joins deltas; clocks may be gappy).

        An element's surviving dots are: dots present on both sides, plus
        dots present on exactly one side that the *other* side's clock has
        not seen (i.e. adds the other side has not yet observed).
        """
        clock = self.clock.join(other.clock)
        entries: Dict[object, FrozenSet[Dot]] = {}
        for e in set(self.entries) | set(other.entries):
            da = self.entries.get(e, frozenset())
            db = other.entries.get(e, frozenset())
            keep = (
                (da & db)
                | {d for d in da - db if not other.clock.seen(d)}
                | {d for d in db - da if not self.clock.seen(d)}
            )
            if keep:
                entries[e] = keep
        return Orswot(clock, entries)

    # ------------------------------------------------------------ accounting
    def size_bytes(self) -> int:
        """Approximate serialized size (the paper's cost metric, §2.1)."""
        total = self.clock.size_bytes()
        for e, ds in self.entries.items():
            total += _elem_bytes(e) + 16 * len(ds)
        return total

    # -------------------------------------------------------------- helpers
    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Orswot):
            return NotImplemented
        return self.clock == other.clock and self.entries == other.entries

    def __repr__(self) -> str:
        return f"Orswot(n={len(self.entries)}, clock={self.clock!r})"


def _elem_bytes(e: object) -> int:
    if isinstance(e, bytes):
        return len(e)
    if isinstance(e, str):
        return len(e.encode())
    return 8
