"""Logical clocks for bigset: ``{BaseVV(), DotCloud()}`` (paper §4.1).

Both the *set-clock* and the *set-tombstone* are instances of this structure:

* ``base`` — a version vector: ``actor -> max contiguous counter`` (events
  ``1..base[actor]`` have all been seen).
* ``runs`` — the dot-cloud, *interval-compressed*: ``actor -> tuple of
  (lo, hi) runs`` of counters seen beyond the contiguous base.  Invariants:
  runs are sorted, disjoint, non-adjacent (``next.lo > prev.hi + 1``), and
  the first run starts at ``base[a] + 2`` or later (a run touching the base
  would have been folded into it).

This is Riak's bigset clock-ranges idea: a removal below the base used to
fragment the summary into one cloud entry *per retained counter* (the old
frozenset cloud's documented "hole" problem); with runs the cost of any
clock is O(actors + interval runs) — causal metadata — never O(dots).  The
legacy per-dot cloud is still available as the read-only :attr:`cloud`
property (O(events); tests and legacy codecs only).

A replica **never** has an entry for itself in the DotCloud (paper §4.1): a
coordinator only mints contiguous events for itself via :meth:`increment`.

The clock is a join-semilattice under :meth:`join`; :meth:`seen` is the
membership test used by Algorithms 1 & 2 and by compaction.  The tombstone
additionally *shrinks* via :meth:`subtract` / :meth:`subtract_clock` once
compaction discards keys (paper §4.3.3), and digest comparison ships
diverged *ranges* via :meth:`diff_runs` — all O(runs) run merges.

The implementation is purely functional: every operation returns a new clock.

PyTorch port: a copy of :mod:`repro.core.clock`; everything below
this docstring is unchanged except its ``# bigset-lint: disable=BS003``
escapes.  They serve the reference's linter (``python -m repro.analysis
src``, CI's lint job), which finds no layer under ``src/repro_torch/`` and
so takes this ``core/`` for another layer.  The port's linter
(``python -m repro_torch.analysis``) scopes it as ``core/``, BS003's home,
and reads only ``# bigset-lint-torch:`` escapes.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Dict, FrozenSet, Iterable, List, Mapping, Sequence, Tuple

from .dots import ActorId, Dot, as_dot

Run = Tuple[int, int]

_EMPTY: "Clock | None" = None


# ---------------------------------------------------------------- run algebra
def runs_from_counters(counters: Iterable[int]) -> Tuple[Run, ...]:
    """Sorted-unique counters -> coalesced (lo, hi) runs."""
    cs = sorted(set(int(c) for c in counters))
    out: List[Run] = []
    for c in cs:
        if out and c == out[-1][1] + 1:
            out[-1] = (out[-1][0], c)
        else:
            out.append((c, c))
    return tuple(out)


def canonical_runs(runs: Iterable[Sequence[int]]) -> Tuple[Run, ...]:
    """Arbitrary (lo, hi) pairs -> sorted, coalesced, non-empty runs."""
    rs = sorted((int(lo), int(hi)) for lo, hi in runs if int(lo) <= int(hi))
    out: List[Run] = []
    for lo, hi in rs:
        if out and lo <= out[-1][1] + 1:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return tuple(out)


def union_runs(x: Sequence[Run], y: Sequence[Run]) -> Tuple[Run, ...]:
    """Union of two canonical run lists — O(|x| + |y|) merge."""
    if not x:
        return tuple(y)
    if not y:
        return tuple(x)
    out: List[Run] = []
    i = j = 0
    while i < len(x) or j < len(y):
        if j >= len(y) or (i < len(x) and x[i][0] <= y[j][0]):
            lo, hi = x[i]
            i += 1
        else:
            lo, hi = y[j]
            j += 1
        if out and lo <= out[-1][1] + 1:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return tuple(out)


def difference_runs(x: Sequence[Run], y: Sequence[Run]) -> Tuple[Run, ...]:
    """Events in ``x`` not in ``y`` — O(|x| + |y|) merge."""
    if not x or not y:
        return tuple(x)
    out: List[Run] = []
    j = 0
    for lo, hi in x:
        cur = lo
        while j < len(y) and y[j][1] < cur:
            j += 1
        k = j
        while k < len(y) and y[k][0] <= hi:
            ylo, yhi = y[k]
            if ylo > cur:
                out.append((cur, ylo - 1))
            cur = max(cur, yhi + 1)
            if yhi > hi:
                break
            k += 1
        if cur <= hi:
            out.append((cur, hi))
    return tuple(out)


def intersect_runs(x: Sequence[Run], y: Sequence[Run]) -> Tuple[Run, ...]:
    """Events in both ``x`` and ``y`` — O(|x| + |y|) merge."""
    out: List[Run] = []
    i = j = 0
    while i < len(x) and j < len(y):
        lo = max(x[i][0], y[j][0])
        hi = min(x[i][1], y[j][1])
        if lo <= hi:
            out.append((lo, hi))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return tuple(out)


def runs_contain(runs: Sequence[Run], c: int) -> bool:
    """Point membership — O(log runs) bisect on run starts."""
    i = bisect_right(runs, (c, float("inf")))
    return i > 0 and runs[i - 1][1] >= c


def covers_runs(x: Sequence[Run], y: Sequence[Run]) -> bool:
    """Is every event of ``y`` inside ``x``?  O(|x| + |y|).

    Because canonical runs are coalesced, a covered ``y`` run must sit
    within a *single* ``x`` run (a gap between x runs is a real gap).
    """
    i = 0
    for lo, hi in y:
        while i < len(x) and x[i][1] < lo:
            i += 1
        if i >= len(x) or x[i][0] > lo or x[i][1] < hi:
            return False
    return True


def count_runs_events(runs: Sequence[Run]) -> int:
    return sum(hi - lo + 1 for lo, hi in runs)


def _split_full(full: Tuple[Run, ...]) -> Tuple[int, Tuple[Run, ...]]:
    """Full run list -> (base, beyond-base runs)."""
    if full and full[0][0] == 1:
        return full[0][1], full[1:]
    return 0, full


class Clock:
    __slots__ = ("base", "runs")

    def __init__(
        self,
        base: Mapping[ActorId, int] | None = None,
        cloud: Mapping[ActorId, Iterable[int]] | None = None,
        runs: Mapping[ActorId, Iterable[Sequence[int]]] | None = None,
        _normalise: bool = True,  # kept for signature compat; always normalises
    ):
        b: Dict[ActorId, int] = {
            a: int(n) for a, n in (base or {}).items() if int(n) > 0
        }
        r: Dict[ActorId, Tuple[Run, ...]] = {}
        for a, rs in (runs or {}).items():
            cr = canonical_runs(rs)
            if cr:
                r[a] = cr
        for a, s in (cloud or {}).items():
            cr = runs_from_counters(s)
            if cr:
                r[a] = union_runs(r[a], cr) if a in r else cr
        # fold runs contiguous with the base into the base VV (normalisation)
        for a in list(r):
            full = union_runs(((1, b[a]),) if a in b else (), r[a])
            bb, rr = _split_full(full)
            if bb:
                b[a] = bb
            if rr:
                r[a] = rr
            else:
                del r[a]
        self.base: Mapping[ActorId, int] = b  # bigset-lint: disable=BS003 -- this is the port's own core/ layer
        self.runs: Mapping[ActorId, Tuple[Run, ...]] = r  # bigset-lint: disable=BS003 -- this is the port's own core/ layer

    @classmethod
    def _make(
        cls,
        base: Dict[ActorId, int],
        runs: Dict[ActorId, Tuple[Run, ...]],
    ) -> "Clock":
        """Trusted fast path: parts already satisfy the run invariants."""
        c = object.__new__(cls)
        c.base = base  # bigset-lint: disable=BS003 -- this is the port's own core/ layer
        c.runs = runs  # bigset-lint: disable=BS003 -- this is the port's own core/ layer
        return c

    # ---------------------------------------------------------------- basics
    @staticmethod
    def zero() -> "Clock":
        global _EMPTY
        if _EMPTY is None:
            _EMPTY = Clock._make({}, {})
        return _EMPTY

    def is_zero(self) -> bool:
        return not self.base and not self.runs

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Clock):
            return NotImplemented
        return self.base == other.base and self.runs == other.runs

    def __hash__(self) -> int:
        return hash(
            (
                tuple(sorted(self.base.items())),
                tuple(sorted(self.runs.items())),
            )
        )

    def __repr__(self) -> str:
        runs = {a: list(rs) for a, rs in sorted(self.runs.items())}
        return f"Clock(base={dict(sorted(self.base.items()))}, runs={runs})"

    @property
    def cloud(self) -> Mapping[ActorId, FrozenSet[int]]:
        """Legacy per-dot view of the run cloud — O(events beyond base).

        Compatibility/oracle accessor only: production layers outside
        ``core/`` must stay O(runs) (lint rule BS008 enforces this).
        """
        return {
            a: frozenset(c for lo, hi in rs for c in range(lo, hi + 1))
            for a, rs in self.runs.items()
        }

    def _full(self, a: ActorId) -> Tuple[Run, ...]:
        """Canonical run list over *all* events seen for actor ``a``."""
        b = self.base.get(a, 0)
        rs = self.runs.get(a, ())
        return ((1, b),) + rs if b else rs

    # ----------------------------------------------------------------- seen
    def seen(self, dot: Dot) -> bool:
        """Has this clock observed ``dot``?  (Algorithms 1 & 2's test.)"""
        dot = as_dot(dot)
        if dot.counter <= self.base.get(dot.actor, 0):
            return True
        return runs_contain(self.runs.get(dot.actor, ()), dot.counter)

    def seen_all(self, dots: Iterable[Dot]) -> bool:
        return all(self.seen(d) for d in dots)

    # ----------------------------------------------------------- coordinator
    def increment(self, actor: ActorId) -> Tuple["Clock", Dot]:
        """Mint the next contiguous event for ``actor`` (coordinator-side).

        Returns ``(clock', dot)`` where ``dot`` is the freshly minted event.
        Only ever called by a replica for *itself*, hence it extends the base
        VV and never touches the run cloud (a replica has no cloud entry for
        itself, §4.1).
        """
        if actor in self.runs:
            # §4.1 invariant: "A replica will never have an entry for itself
            # in the DotCloud" — minting below a gap would reuse/skip events.
            raise ValueError(f"actor {actor!r} has its own dots in the cloud")
        base = dict(self.base)
        nxt = base.get(actor, 0) + 1
        base[actor] = nxt
        return Clock._make(base, dict(self.runs)), Dot(actor, nxt)

    def latest_dot(self, actor: ActorId) -> Dot:
        return Dot(actor, self.base.get(actor, 0))

    # ------------------------------------------------------------------ add
    def add(self, dot: Dot) -> "Clock":
        """Add one observed event (replica-side delta apply)."""
        dot = as_dot(dot)
        if self.seen(dot):
            return self
        return self.add_dots((dot,))

    def add_dots(self, dots: Iterable[Dot]) -> "Clock":
        by_actor: Dict[ActorId, List[int]] = {}
        for d in dots:
            d = as_dot(d)
            if not self.seen(d):
                by_actor.setdefault(d.actor, []).append(d.counter)
        if not by_actor:
            return self
        base = dict(self.base)
        runs = dict(self.runs)
        for a, cs in by_actor.items():
            full = union_runs(self._full(a), runs_from_counters(cs))
            self._set_actor(base, runs, a, full)
        return Clock._make(base, runs)

    def add_runs(self, ranges: Iterable[Tuple[ActorId, int, int]]) -> "Clock":
        """Observe whole ``(actor, lo, hi)`` ranges — O(runs) bulk apply.

        This is how digest-sync results are absorbed: diverged *ranges* from
        :meth:`diff_runs` apply without ever enumerating counters.
        """
        by_actor: Dict[ActorId, List[Run]] = {}
        for a, lo, hi in ranges:
            if int(lo) <= int(hi):
                by_actor.setdefault(a, []).append((int(lo), int(hi)))
        if not by_actor:
            return self
        base = dict(self.base)
        runs = dict(self.runs)
        changed = False
        for a, rs in by_actor.items():
            full0 = self._full(a)
            full = union_runs(full0, canonical_runs(rs))
            if full != full0:
                changed = True
                self._set_actor(base, runs, a, full)
        return Clock._make(base, runs) if changed else self

    # ----------------------------------------------------------------- join
    def join(self, other: "Clock") -> "Clock":
        """Least upper bound of two clocks (semilattice join) — O(runs)."""
        if self is other:
            return self
        base: Dict[ActorId, int] = {}
        runs: Dict[ActorId, Tuple[Run, ...]] = {}
        for a in self.actors() | other.actors():
            full = union_runs(self._full(a), other._full(a))
            self._set_actor(base, runs, a, full)
        return Clock._make(base, runs)

    # ------------------------------------------------------------- subtract
    def subtract(self, dots: Iterable[Dot]) -> "Clock":
        """Remove ``dots`` from this clock (tombstone trimming, §4.3.3).

        Only meaningful for clocks that describe *sets of dots* (the
        set-tombstone, survivors digests): after compaction discards an
        element-key, its dot is subtracted so the summary stays minimal.
        Subtracting a dot below the base splits the base run into interval
        runs for the retained ranges — the hole is permanent (counters are
        never re-minted), but the cost stays O(interval runs), never
        O(retained counters) as in the old frozenset cloud.
        """
        by_actor: Dict[ActorId, List[int]] = {}
        for d in dots:
            d = as_dot(d)
            by_actor.setdefault(d.actor, []).append(d.counter)
        if not by_actor:
            return self
        base = dict(self.base)
        runs = dict(self.runs)
        changed = False
        for a, cs in by_actor.items():
            full0 = self._full(a)
            full = difference_runs(full0, runs_from_counters(cs))
            if full != full0:
                changed = True
                self._set_actor(base, runs, a, full)
        return Clock._make(base, runs) if changed else self

    def subtract_clock(self, other: "Clock") -> "Clock":
        """Set-minus of dot sets: events seen by self but not by other.

        The O(runs) replacement for ``subtract(o.all_dots())`` — used by
        survivors digests (raw total minus tombstone) and tombstone trims.
        """
        base: Dict[ActorId, int] = {}
        runs: Dict[ActorId, Tuple[Run, ...]] = {}
        changed = False
        for a in self.actors():
            full0 = self._full(a)
            full = difference_runs(full0, other._full(a))
            if full != full0:
                changed = True
            self._set_actor(base, runs, a, full)
        return Clock._make(base, runs) if changed else self

    def intersect(self, other: "Clock") -> "Clock":
        """Events seen by both clocks — O(runs).

        Tombstone trimming uses this to drop entries with no backing
        element-key: ``ts.intersect(raw)`` keeps only removals the raw
        total actually covers.
        """
        base: Dict[ActorId, int] = {}
        runs: Dict[ActorId, Tuple[Run, ...]] = {}
        changed = False
        for a in self.actors():
            full0 = self._full(a)
            full = intersect_runs(full0, other._full(a))
            if full != full0:
                changed = True
            self._set_actor(base, runs, a, full)
        return Clock._make(base, runs) if changed else self

    # ------------------------------------------------------------- ordering
    def descends(self, other: "Clock") -> bool:
        """True iff self has seen every event other has (self >= other)."""
        for a in other.actors():
            if not covers_runs(self._full(a), other._full(a)):
                return False
        return True

    def dominates(self, other: "Clock") -> bool:
        return self.descends(other) and self != other

    # ---------------------------------------------------------------- dots
    def diff_runs(self, other: "Clock") -> Tuple[Tuple[ActorId, int, int], ...]:
        """Ranges seen by ``self`` but not ``other`` — O(runs).

        This is the digest subtraction at the heart of digest-driven
        anti-entropy: two survivors digests (clock summaries of surviving
        element-key dots) yield the exact diverged *ranges* without touching
        a single element-key, and without enumerating a single counter.
        """
        out: List[Tuple[ActorId, int, int]] = []
        for a in sorted(self.actors(), key=repr):
            for lo, hi in difference_runs(self._full(a), other._full(a)):
                out.append((a, lo, hi))
        return tuple(out)

    def diff_dots(self, other: "Clock") -> Tuple[Dot, ...]:
        """Dots seen by ``self`` but not by ``other`` — O(diff).

        Enumerated form of :meth:`diff_runs`, for callers that need the
        individual diverged dots (the diff itself is materialised, so cost
        is O(actual divergence), not O(cloud fragmentation)).
        """
        out = []
        for a, lo, hi in self.diff_runs(other):
            out.extend(Dot(a, c) for c in range(lo, hi + 1))
        return tuple(sorted(out))

    def all_dots(self) -> Tuple[Dot, ...]:
        """Every dot this clock has seen (O(total events) — for tests/small clocks)."""
        out = []
        for a in self.actors():
            for lo, hi in self._full(a):
                out.extend(Dot(a, c) for c in range(lo, hi + 1))
        return tuple(sorted(out))

    def iter_runs(self) -> Tuple[Tuple[ActorId, int, int], ...]:
        """Every (actor, lo, hi) run this clock has seen, base included."""
        out: List[Tuple[ActorId, int, int]] = []
        for a in sorted(self.actors(), key=repr):
            out.extend((a, lo, hi) for lo, hi in self._full(a))
        return tuple(out)

    def actors(self) -> FrozenSet[ActorId]:
        return frozenset(self.base) | frozenset(self.runs)

    def n_runs(self) -> int:
        """Total interval runs (a base entry counts as one run)."""
        return len(self.base) + sum(len(rs) for rs in self.runs.values())

    def n_events(self) -> int:
        """Total events covered — O(runs) to compute."""
        return sum(self.base.values()) + sum(
            count_runs_events(rs) for rs in self.runs.values()
        )

    def size_bytes(self) -> int:
        """Approximate serialized size — the metric the paper optimises for.

        O(actors + interval runs): each run is (actor, lo, hi) ~ three
        8-byte words, regardless of how many events it spans.
        """
        return 24 * self.n_runs()

    # ---------------------------------------------------------- (de)coding
    def to_obj(self):
        """Run-length codec (version 2): ``{"b": base, "r": runs}``."""
        return {
            "b": sorted(self.base.items()),
            "r": sorted(
                (a, [list(r) for r in rs]) for a, rs in self.runs.items()
            ),
        }

    @staticmethod
    def from_obj(o) -> "Clock":
        """Decode a clock object — new run-length or legacy per-dot codecs.

        Accepts (newest first):
        * ``{"b": [[a, n]...], "r": [[a, [[lo, hi]...]]...]}`` — run-length,
        * ``{"b": [[a, n]...], "c": [[a, [c...]]...]}`` — legacy msgpack
          per-dot cloud (pre-interval ``KIND_CLOCK`` / orswot payloads),
        * ``{"base": ..., "cloud": ...}`` — legacy ``to_obj`` form.
        """
        if "r" in o:
            return Clock(dict(o["b"]), runs={a: rs for a, rs in o["r"]})
        if "c" in o:
            return Clock(dict(o["b"]), {a: set(s) for a, s in o["c"]})
        return Clock(dict(o["base"]), {a: set(s) for a, s in o["cloud"]})

    # ------------------------------------------------------------- internals
    @staticmethod
    def _set_actor(
        base: Dict[ActorId, int],
        runs: Dict[ActorId, Tuple[Run, ...]],
        a: ActorId,
        full: Tuple[Run, ...],
    ) -> None:
        """Install a canonical full run list for actor ``a`` into parts."""
        b, rs = _split_full(full)
        if b:
            base[a] = b
        else:
            base.pop(a, None)
        if rs:
            runs[a] = rs
        else:
            runs.pop(a, None)
