"""Delta-CRDT ORSWOT — the paper's §3 baseline (riak_dt delta_data_types).

A delta-mutator returns, instead of the full post-state, a small ORSWOT
fragment that other replicas can join with the generic
:meth:`repro.core.orswot.Orswot.merge`.  The paper's observation (§3) is that
this *alone* barely helps a durable store: the delta is small on the wire,
but the downstream replica must still **read + deserialize + merge + write
the full state** for every delta ("an incoming delta never supersedes the
local state, even without concurrency").  The byte accounting in
:mod:`benchmarks.bench_writes` makes this visible.

PyTorch port: a copy of :mod:`repro.core.delta_orswot`; everything below
this docstring is unchanged.
"""
from __future__ import annotations

from typing import Iterable, Tuple

from .clock import Clock
from .dots import ActorId, Dot
from .orswot import Orswot


def delta_add(state: Orswot, actor: ActorId, element: object) -> Tuple[Orswot, Orswot]:
    """Coordinator add.  Returns ``(new_state, delta)``.

    The delta's clock covers the new dot *and* the replaced dots of the
    element (the causal context of the add), so that joining it elsewhere
    removes the superseded adds.
    """
    replaced = state.entries.get(element, frozenset())
    clock, dot = state.clock.increment(actor)
    new_entries = dict(state.entries)
    new_entries[element] = frozenset((dot,))
    new_state = Orswot(clock, new_entries)

    delta_clock = Clock.zero().add_dots((dot, *replaced))
    delta = Orswot(delta_clock, {element: frozenset((dot,))})
    return new_state, delta


def delta_remove(
    state: Orswot, element: object, ctx: Iterable[Dot] | None = None
) -> Tuple[Orswot, Orswot]:
    """Coordinator remove.  Returns ``(new_state, delta)``.

    The delta is entry-less: its clock covers exactly the removed dots, so a
    join discards them everywhere (observed-remove).
    """
    cur = state.entries.get(element, frozenset())
    drop = frozenset(ctx) if ctx is not None else cur
    new_state = state.remove(element, drop)
    delta = Orswot(Clock.zero().add_dots(drop), {})
    return new_state, delta


def join_delta(state: Orswot, delta: Orswot) -> Orswot:
    """Downstream delta apply — a full-state merge, per §3's complaint."""
    return state.merge(delta)


def group_deltas(deltas: Iterable[Orswot]) -> Orswot:
    """Delta-group composition: deltas are themselves joinable."""
    acc = Orswot.new()
    for d in deltas:
        acc = acc.merge(d)
    return acc
