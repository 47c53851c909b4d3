"""Cost-based join planning over LSM run statistics.

The paper's bet is that decomposition makes work proportional to causal
metadata, not cardinality (§2.1), and that the full-read trade-off "is
mitigated by enabling queries on sets" (§4.4).  A join that always zippers
both element streams end-to-end betrays that bet: intersecting a
100-element set against a 1M-element set pays O(n) of the large side.  This
module is the chooser that keeps join IO proportional to the *smaller*
side when the data is skewed:

* **zipper** — the §4.4 streaming join: both ordered element streams are
  merged end-to-end.  Cost ~ ``left.keys + right.keys``.  Optimal when the
  sides are comparable (every key must be visited anyway), and the only
  correct shape for ``union`` (every entry of both sides is emitted —
  there is nothing to skip).
* **gallop** — drive the smaller side's stream; probe the larger side with
  bounded positional seeks (:meth:`repro.storage.lsm.LsmIterator.seek`
  skips the gap without touching it).  Cost ~ ``drive.keys * (1 +
  SEEK_COST_KEYS)`` — independent of the large side's cardinality.

Statistics come from :meth:`repro.storage.lsm.LsmStore.range_stats`: per-run
key counts, range fences, and cumulative byte offsets make any range's
cardinality/volume estimate a couple of bisects, never a scan.  The chosen
strategy is surfaced in :attr:`repro.query.executor.QueryStats.strategy`
and rides the serve layer's per-page stats to clients.

Both strategies return byte-identical entries (asserted in
``tests/test_planner.py``); the planner only moves cost, never results —
which is also why a cursor minted under one strategy resumes under the
other.

PyTorch port: a copy of :mod:`repro.query.planner`; everything below
this docstring is unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

from ..core.bigset import element_range
from ..storage.lsm import LsmStore
from .plan import PlanError

ZIPPER = "zipper"
GALLOP = "gallop"

# One positional probe (a bisect per level, heap rebuild, one element's
# keys decoded + visibility-filtered) costs about this many sequentially
# streamed keys.  Gallop wins once the large side exceeds
# SEEK_COST_KEYS x the small side — measured crossover in
# benchmarks/bench_joins.py.
SEEK_COST_KEYS = 12.0


@dataclass(frozen=True)
class SideStats:
    """Approximate size of one join side's element range."""

    keys: int    # element-key count (upper bound: shadowed keys included)
    bytes: int   # byte volume of the range


@dataclass(frozen=True)
class JoinChoice:
    """The planner's verdict: which algorithm, driving which side, and why."""

    strategy: str          # "zipper" | "gallop"
    drive: str             # side the executor streams: "left" | "right"
    left: SideStats
    right: SideStats
    est_zipper: float      # estimated keys touched by the zipper
    est_gallop: float      # estimated keys touched by the gallop (inf: n/a)
    reason: str


def side_stats(store: LsmStore, set_name: bytes) -> SideStats:
    """Size of one set's element range, from run statistics (no scan)."""
    lo, hi = element_range(set_name)
    rs = store.range_stats(lo, hi)
    return SideStats(keys=rs.keys, bytes=rs.bytes)


def quorum_side_stats(stores: Iterable[LsmStore], set_name: bytes) -> SideStats:
    """Aggregate side size across the replicas a coverage query touches.

    Sums preserve the left:right skew ratio (each replica holds the full
    set), which is all the cost model compares.
    """
    keys = nbytes = 0
    for store in stores:
        s = side_stats(store, set_name)
        keys += s.keys
        nbytes += s.bytes
    return SideStats(keys=keys, bytes=nbytes)


def gallop_drive(kind: str, left: SideStats, right: SideStats) -> Optional[str]:
    """Which side a gallop join would drive, or None if gallop can't apply.

    Intersect is symmetric: drive whichever side is smaller.  Difference
    must emit the left side's survivors, so it can only ever drive left
    (galloping helps exactly when the right side is the big one).  Union
    emits every entry of both sides — nothing can be skipped.
    """
    if kind == "intersect":
        return "left" if left.keys <= right.keys else "right"
    if kind == "difference":
        return "left"
    return None


def choose_join(
    kind: str,
    left: SideStats,
    right: SideStats,
    forced: Optional[str] = None,
) -> JoinChoice:
    """Pick zipper vs gallop for one join from its sides' run statistics.

    ``forced`` (the plan's ``strategy`` field) overrides the cost model —
    except for union, which structurally cannot gallop and always zippers.
    """
    drive = gallop_drive(kind, left, right)
    est_zipper = float(left.keys + right.keys)
    if drive is None:
        est_gallop = float("inf")
    else:
        d = left if drive == "left" else right
        est_gallop = d.keys * (1.0 + SEEK_COST_KEYS)

    if forced is not None:
        if forced not in (ZIPPER, GALLOP):
            raise PlanError(f"unknown join strategy {forced!r}")
        if forced == GALLOP and drive is None:
            strategy = ZIPPER
            reason = "forced gallop, but union must stream both sides"
        else:
            strategy = forced
            reason = f"forced {forced}"
    elif est_gallop < est_zipper:
        strategy = GALLOP
        reason = (f"gallop ~{est_gallop:.0f} keys beats "
                  f"zipper ~{est_zipper:.0f}")
    else:
        strategy = ZIPPER
        reason = (f"zipper ~{est_zipper:.0f} keys beats "
                  f"gallop ~{est_gallop:.0f}")

    if strategy == ZIPPER:
        drive = "left"  # the zipper streams both; left is just convention
    return JoinChoice(
        strategy=strategy, drive=drive or "left", left=left, right=right,
        est_zipper=est_zipper, est_gallop=est_gallop, reason=reason)
