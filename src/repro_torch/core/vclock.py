"""Dense PyTorch logical clocks — the device form of BaseVV + DotCloud.

The port of :mod:`repro.core.vclock`.  The paper's clocks are sparse maps;
their hot operations (dot-seen filtering of element-key streams, clock
joins, tombstone subtraction) are the write and read path of every bigset
op.  On the device we hold a *dense interval* clock per actor universe:

* ``starts : int32[A, R]`` — per-actor run start counters,
* ``ends   : int32[A, R]`` — per-actor run end counters (inclusive).

Row ``a`` holds the actor's seen events as sorted, disjoint, coalesced
``(lo, hi)`` runs — the base VV is simply the first run when it starts at 1.
Empty slots are the sentinel ``(1, 0)`` (``lo > hi``), which no membership
test can hit.  Cost is O(interval runs) — causal metadata — with no window
cap.

The lattice ops are data-parallel interval merges over fixed shapes:

    join      = run union            (set-clock ⊔ delta)
    subtract  = run difference       (tombstone shrink, §4.3.3) — origin-free
    intersect = run intersection     (tombstone ∩ raw trim)
    seen      = any(lo ≤ c ≤ hi)     (Algorithms 1 & 2)
    popcount  = Σ (hi - lo + 1)      (events per actor)

The merges use a boundary sweep: a counter ``p`` starts an output run iff it
is live under the op's predicate and ``p - 1`` is not; ``p`` ends one iff it
is live and ``p + 1`` is not.  Candidate boundaries come only from input run
edges, so the sweep is O(P²) dense compares over P = Ra + Rb candidates.

Every function keeps its tensors on the device of its inputs; a clock is
built on the device its caller names (``from_clock(..., device=...)``).
``dots_seen`` is the plain version the ``kernels/dot_seen`` CUDA kernel is
held against.  Differences from the JAX module, all deliberate:

* an actor outside ``[0, A)`` reads as unseen (JAX clamps the gather index
  to the last row, torch would raise);
* ``sort_runs`` sorts stably, as ``jnp.argsort`` does, so tied empty slots
  keep their order;
* ``add_dots`` sorts on one int64 key ``(actor << 32) | (counter + 2**31)``
  where JAX lexsorts, and segment-reduces with ``scatter_reduce``; dots of
  actors outside the universe are dropped.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch

from .clock import Clock

_INT32_MAX = 2**31 - 1


class DenseClock(NamedTuple):
    starts: torch.Tensor  # int32[A, R] (empty slot: starts=1, ends=0)
    ends: torch.Tensor    # int32[A, R]

    @property
    def n_actors(self) -> int:
        return self.starts.shape[0]

    @property
    def n_runs(self) -> int:
        return self.starts.shape[1]

    @property
    def device(self) -> torch.device:
        return self.starts.device


def zero(n_actors: int, n_runs: int = 1, *, device) -> DenseClock:
    return DenseClock(
        torch.ones((n_actors, n_runs), dtype=torch.int32, device=device),
        torch.zeros((n_actors, n_runs), dtype=torch.int32, device=device),
    )


# ------------------------------------------------------------------- seen
def dots_seen(clock: DenseClock, actors: torch.Tensor,
              counters: torch.Tensor) -> torch.Tensor:
    """Vectorised Algorithm-1/2 membership test.

    actors : int32[N] (indices into the actor universe)
    counters : int32[N] (event numbers, 1-based)
    returns bool[N]

    A dot is seen iff some run of its actor's row contains its counter —
    a broadcast interval test over all R runs, no window cap.  An actor
    outside ``[0, A)`` is unseen.
    """
    n_actors = clock.starts.shape[0]
    known = (actors >= 0) & (actors < n_actors)
    rows = torch.where(known, actors, torch.zeros_like(actors)).long()
    if n_actors == 0:
        return torch.zeros_like(known)
    s = clock.starts[rows]                       # [N, R]
    e = clock.ends[rows]                         # [N, R]
    c = counters[:, None]                        # [N, 1]
    return torch.any((s <= c) & (c <= e), dim=1) & known


# ------------------------------------------------------------------ lattice
def _require_same_universe(a: DenseClock, b: DenseClock) -> None:
    if a.starts.shape[0] != b.starts.shape[0]:
        raise ValueError("dense clocks must share the actor universe")


def _interval_merge(a_s, a_e, b_s, b_e, mode: str):
    """Boundary-sweep run merge — shared math for join/subtract/intersect.

    Inputs are int32[A, Ra] / int32[A, Rb] run arrays; output is the
    *unsorted* int32[A, Ra+Rb] run arrays of the result (empty slots
    ``(1, 0)``).  ``mode``: ``"or"`` (union), ``"andnot"`` (difference),
    ``"and"`` (intersection).

    Candidates are computed in int64 so ``b_e + 1`` and ``b_s - 1`` cannot
    wrap at the int32 edges; every emitted bound is an input bound or one
    past one that the predicate proved live, so it fits int32 again.
    """
    a_s, a_e, b_s, b_e = (t.long() for t in (a_s, a_e, b_s, b_e))
    a_valid = a_s <= a_e
    b_valid = b_s <= b_e

    def in_a(x):  # x: int64[A, P] -> bool[A, P]
        return torch.any(
            (a_s[:, None, :] <= x[:, :, None]) & (x[:, :, None] <= a_e[:, None, :]),
            dim=-1)

    def in_b(x):
        return torch.any(
            (b_s[:, None, :] <= x[:, :, None]) & (x[:, :, None] <= b_e[:, None, :]),
            dim=-1)

    s_valid = torch.cat([a_valid, b_valid], dim=1)
    e_valid = s_valid
    if mode == "or":
        def live(x):
            return in_a(x) | in_b(x)
        cand_s = torch.cat([a_s, b_s], dim=1)
        cand_e = torch.cat([a_e, b_e], dim=1)
    elif mode == "andnot":
        def live(x):
            return in_a(x) & ~in_b(x)
        # a difference run starts at an A start or just after a B end,
        # and ends at an A end or just before a B start
        cand_s = torch.cat([a_s, b_e + 1], dim=1)
        cand_e = torch.cat([a_e, b_s - 1], dim=1)
    elif mode == "and":
        def live(x):
            return in_a(x) & in_b(x)
        cand_s = torch.cat([a_s, b_s], dim=1)
        cand_e = torch.cat([a_e, b_e], dim=1)
    else:  # pragma: no cover
        raise ValueError(f"unknown merge mode {mode!r}")

    is_start = s_valid & live(cand_s) & ~live(cand_s - 1)
    # two candidates can carry the same start value (e.g. identical runs in
    # both inputs under "or") — keep only the first occurrence per row
    p = cand_s.shape[1]
    same = cand_s[:, :, None] == cand_s[:, None, :]              # [A, P, P]
    earlier = torch.tril(torch.ones((p, p), dtype=torch.bool,
                                    device=cand_s.device), diagonal=-1)
    dup = torch.any(same & earlier[None, :, :] & is_start[:, None, :], dim=-1)
    is_start = is_start & ~dup

    is_end = e_valid & live(cand_e) & ~live(cand_e + 1)
    # each output run ends at the smallest end-boundary >= its start
    reach = is_end[:, None, :] & (cand_e[:, None, :] >= cand_s[:, :, None])
    big = torch.full_like(cand_e, _INT32_MAX)
    ends_for = torch.where(reach, cand_e[:, None, :], big[:, None, :]).amin(dim=-1)

    out_s = torch.where(is_start, cand_s, torch.ones_like(cand_s))
    out_e = torch.where(is_start, ends_for, torch.zeros_like(ends_for))
    return out_s.to(torch.int32), out_e.to(torch.int32)


def sort_runs(starts: torch.Tensor, ends: torch.Tensor):
    """Canonicalise run arrays: sort rows by start, empties ``(1, 0)`` last."""
    valid = starts <= ends
    key = torch.where(valid, starts, torch.full_like(starts, _INT32_MAX))
    order = torch.argsort(key, dim=1, stable=True)
    s = torch.take_along_dim(starts, order, dim=1)
    e = torch.take_along_dim(ends, order, dim=1)
    ok = s <= e
    return (torch.where(ok, s, torch.ones_like(s)),
            torch.where(ok, e, torch.zeros_like(e)))


def join(a: DenseClock, b: DenseClock) -> DenseClock:
    """⊔ of two dense clocks (run union) — no alignment requirements."""
    _require_same_universe(a, b)
    s, e = _interval_merge(a.starts, a.ends, b.starts, b.ends, "or")
    return DenseClock(*sort_runs(s, e))


def subtract(a: DenseClock, b: DenseClock) -> DenseClock:
    """Remove b's events from a (tombstone shrink, §4.3.3), origin-free."""
    _require_same_universe(a, b)
    s, e = _interval_merge(a.starts, a.ends, b.starts, b.ends, "andnot")
    return DenseClock(*sort_runs(s, e))


def intersect(a: DenseClock, b: DenseClock) -> DenseClock:
    """Events seen by both clocks (run intersection)."""
    _require_same_universe(a, b)
    s, e = _interval_merge(a.starts, a.ends, b.starts, b.ends, "and")
    return DenseClock(*sort_runs(s, e))


def add_dots(clock: DenseClock, actors: torch.Tensor,
             counters: torch.Tensor) -> DenseClock:
    """Observe a batch of dots (delta apply) — one run build + one merge.

    Sorts the dots, detects run breaks, segment-reduces each run's bounds,
    scatters the runs into per-actor rows and unions them with the clock.
    Duplicate dots land in the same run and adjacent counters coalesce
    before the merge.
    """
    n = int(actors.shape[0])
    if n == 0:
        return clock
    n_a = clock.n_actors
    dev = clock.device
    a64 = actors.to(device=dev, dtype=torch.int64)
    c64 = counters.to(device=dev, dtype=torch.int64)
    # one int64 key orders by (actor, counter): counters are int32, so the
    # low word (shifted to unsigned) never carries into the actor word
    order = torch.argsort((a64 << 32) | (c64 + 2**31), stable=True)
    a = a64[order]
    c = c64[order]
    prev_a = torch.cat([a[:1] - 1, a[:-1]])
    prev_c = torch.cat([c[:1], c[:-1]])
    new_run = (a != prev_a) | (c > prev_c + 1)
    gid = torch.cumsum(new_run.long(), dim=0) - 1                  # [n]
    n_runs = int(gid[-1]) + 1

    def seg(src, reduce):
        out = torch.zeros(n_runs, dtype=torch.int64, device=dev)
        return out.scatter_reduce(0, gid, src, reduce, include_self=False)

    run_lo = seg(c, "amin")
    run_hi = seg(c, "amax")
    run_actor = seg(a, "amax")
    run_ids = torch.arange(n_runs, dtype=torch.int64, device=dev)
    # rank of each run within its actor row (runs are actor-grouped)
    first = torch.zeros(n_a + 1, dtype=torch.int64, device=dev).scatter_reduce(
        0, run_actor.clamp(0, n_a), run_ids, "amin", include_self=False)
    rank = run_ids - first[run_actor.clamp(0, n_a)]
    # runs of actors outside the universe are dropped, as JAX's
    # ``.at[].set(mode="drop")`` drops out-of-range rows
    keep = (run_actor >= 0) & (run_actor < n_a)
    delta_s = torch.ones((n_a, n), dtype=torch.int32, device=dev)
    delta_e = torch.zeros((n_a, n), dtype=torch.int32, device=dev)
    idx = (run_actor[keep], rank[keep])
    delta_s.index_put_(idx, run_lo[keep].to(torch.int32))
    delta_e.index_put_(idx, run_hi[keep].to(torch.int32))
    return join(clock, DenseClock(delta_s, delta_e))


def compact(clock: DenseClock) -> DenseClock:
    """Trim trailing all-empty run columns (host-side width reduction).

    Merges widen arrays to Ra + Rb; after coalescing most columns are the
    empty sentinel.  Call between chained merges to keep widths O(runs).
    """
    used = (clock.starts <= clock.ends).any(dim=0).cpu().numpy()
    width = int(used.nonzero()[0].max()) + 1 if used.any() else 1
    return DenseClock(clock.starts[:, :width].contiguous(),
                      clock.ends[:, :width].contiguous())


def popcount(clock: DenseClock) -> torch.Tensor:
    """Events per actor — Σ (hi - lo + 1) over valid runs (int32[A])."""
    span = (clock.ends - clock.starts + 1).clamp(min=0)
    return span.sum(dim=1, dtype=torch.int32)


def base_vv(clock: DenseClock) -> torch.Tensor:
    """Effective version vector: the contiguous horizon per actor.

    Requires canonical (sorted) rows — true for anything built by
    :func:`from_clock` or returned by the merge ops.
    """
    first_s, first_e = clock.starts[:, 0], clock.ends[:, 0]
    return torch.where(first_s == 1, first_e, torch.zeros_like(first_e))


# ------------------------------------------------------------- conversions
def from_clock(
    clock: Clock, actor_index: Dict[object, int], n_actors: int,
    n_runs: int | None = None, *, device,
) -> DenseClock:
    """Sparse → dense: O(runs), one row slot per interval run.

    ``n_runs`` pads the run axis to a fixed width; defaults to the widest
    row.  Raises if a row needs more than ``n_runs``.  The arrays are built
    on the host and copied to ``device`` once.
    """
    rows: Dict[int, list] = {}
    for a, lo, hi in clock.iter_runs():
        rows.setdefault(actor_index[a], []).append((lo, hi))
    widest = max((len(r) for r in rows.values()), default=0)
    width = max(1, widest) if n_runs is None else n_runs
    if widest > width:
        raise ValueError(
            f"clock has {widest} runs in a row; n_runs={width} too narrow")
    starts = np.ones((n_actors, width), np.int32)
    ends = np.zeros((n_actors, width), np.int32)
    for i, rs in rows.items():
        for k, (lo, hi) in enumerate(rs):
            starts[i, k] = lo
            ends[i, k] = hi
    return DenseClock(torch.from_numpy(starts).to(device),
                      torch.from_numpy(ends).to(device))


def to_clock(clock: DenseClock, actors: Sequence[object]) -> Clock:
    """Dense → sparse (normalised BaseVV + run cloud)."""
    s = clock.starts.cpu().numpy()
    e = clock.ends.cpu().numpy()
    runs: Dict[object, list] = {}
    for i, a in enumerate(actors):
        rs = [(int(lo), int(hi)) for lo, hi in zip(s[i], e[i]) if lo <= hi]
        if rs:
            runs[a] = rs
    return Clock(runs=runs)
