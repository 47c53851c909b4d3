"""Partitioned placement: the consistent-hash ring over bigset partitions.

The source paper's deployment context is Riak's ring: a bigset is
decomposed *on disk* precisely so vnodes can own slices of the element
keyspace instead of whole opaque sets.  This module is that ring for our
cluster — it turns ``(set_name, element)`` into a partition id and a
**preference list** of owner vnodes, so that

* writes route to the partition's N owners instead of fanning to every
  vnode (cluster capacity scales with vnode count);
* coverage queries plan a *minimal covering set* over partial owners
  (per-partition quorum merge instead of per-set);
* a ring change (:meth:`Ring.with_actors`) is described by a
  :class:`RingDelta` naming exactly the moved partitions, so handoff is
  digest-ladder anti-entropy over the moved partitions only — O(moved
  data + causal metadata), never O(cluster state).

Placement is **rendezvous (highest-random-weight) hashing**: each vnode's
score for a partition is a seeded keyed hash, and the owners are the
``factor`` top scorers.  Adding a vnode therefore moves only the
partitions where the newcomer out-scores an incumbent — the minimal-move
property a mod-N ring lacks — while every replica computes identical
placement from ``(actors, seed)`` with no shared state.

The **degenerate full-replication ring** (:meth:`Ring.full`) has one
partition owned by every vnode and stores under the set's own name, so a
cluster built without an explicit ring behaves — and bills wire bytes —
byte-identically to the pre-partitioning code.

Partition storage naming: partition ``pid`` of set ``s`` is stored as the
*independent bigset* ``s + b"\\x00#" + pid`` (the NUL keeps generated
names out of the application namespace).  Each partition has its own
set-clock, tombstone, and digest: dots minted for different partitions
are never conflated, which is what makes the per-partition quorum merge
exactly the ORSWOT merge it was before — element→partition is
deterministic, so every causal decision about an element happens inside
one partition's clock domain.

PyTorch port: a copy of :mod:`repro.cluster.placement`; everything below
this docstring is unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from hashlib import blake2b
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

#: default partition count — plenty of placement granularity for tens of
#: vnodes while keeping per-set metadata (clocks, digests) bounded
DEFAULT_PARTITIONS = 64

_PSET_SEP = b"\x00#"


class VnodeDown(RuntimeError):
    """An operation needed a crashed vnode (crash()ed, not restarted).

    Carries *which* vnode was down and for which set, so routing layers
    can record hinted-handoff bookkeeping and tests can assert the owner.
    """

    def __init__(self, message: str, vnode: Optional[str] = None,
                 set_name: Optional[bytes] = None):
        super().__init__(message)
        self.vnode = vnode
        self.set_name = set_name


# ------------------------------------------------------------- pset codec
def partition_set(set_name: bytes, pid: int) -> bytes:
    """Storage name of partition ``pid`` of ``set_name``."""
    return set_name + _PSET_SEP + pid.to_bytes(2, "big")


def split_partition_set(pset: bytes) -> Tuple[bytes, Optional[int]]:
    """Inverse of :func:`partition_set`; ``(pset, None)`` if unpartitioned."""
    i = pset.rfind(_PSET_SEP)
    if i < 0 or len(pset) - i != len(_PSET_SEP) + 2:
        return pset, None
    return pset[:i], int.from_bytes(pset[i + len(_PSET_SEP):], "big")


# ---------------------------------------------------------------- the ring
@dataclass(frozen=True)
class PreferenceList:
    """Placement verdict for one partition: owners first, then fallbacks.

    ``owners`` are the ``factor`` top rendezvous scorers — the replicas a
    write must reach and a coverage query draws its quorum from.
    ``fallbacks`` are the remaining vnodes in score order: sloppy
    placement targets when an owner is down (hinted handoff).
    """

    pid: int
    owners: Tuple[str, ...]
    fallbacks: Tuple[str, ...]


@dataclass(frozen=True)
class Ring:
    """A versioned, seeded consistent-hash ring over bigset partitions.

    Immutable: a membership change mints a *new* ring with a bumped
    ``epoch`` (:meth:`with_actors`), and :meth:`delta_to` names exactly
    the partitions whose ownership moved.  All placement is a pure
    function of ``(actors, factor, n_partitions, seed)``, so every vnode
    and every client computes identical routing with no coordination.
    """

    actors: Tuple[str, ...]
    factor: int
    n_partitions: int = DEFAULT_PARTITIONS
    seed: int = 0
    epoch: int = 0
    #: degenerate mode: one partition, every vnode an owner, storage
    #: passthrough — byte-identical to the pre-partitioning cluster
    full_replication: bool = False
    _ranking: Tuple[Tuple[str, ...], ...] = field(
        default=(), repr=False, compare=False)

    def __post_init__(self):
        if not self.actors:
            raise ValueError("ring needs at least one actor")
        if not (1 <= self.factor <= len(self.actors)):
            raise ValueError(
                f"factor {self.factor} not in [1, {len(self.actors)}]")
        if self.full_replication:
            ranking = (tuple(self.actors),) * self.n_partitions
        else:
            ranking = tuple(
                tuple(sorted(self.actors,
                             key=lambda a: self._score(pid, a),
                             reverse=True))
                for pid in range(self.n_partitions))
        object.__setattr__(self, "_ranking", ranking)

    # -------------------------------------------------------- constructors
    @classmethod
    def full(cls, actors: Sequence[str], epoch: int = 0) -> "Ring":
        """The degenerate full-replication ring (the default cluster)."""
        actors = tuple(actors)
        return cls(actors=actors, factor=len(actors), n_partitions=1,
                   epoch=epoch, full_replication=True)

    @classmethod
    def build(cls, actors: Sequence[str], factor: int = 3,
              n_partitions: int = DEFAULT_PARTITIONS, seed: int = 0,
              epoch: int = 0) -> "Ring":
        return cls(actors=tuple(actors), factor=factor,
                   n_partitions=n_partitions, seed=seed, epoch=epoch)

    @classmethod
    def from_members(cls, view, factor: int = 3,
                     n_partitions: int = DEFAULT_PARTITIONS, seed: int = 0,
                     epoch: int = 0) -> "Ring":
        """Build a ring from a membership view's alive-set.

        ``view`` is a :class:`~repro.cluster.membership.MembershipView`
        (or anything with ``members()``); members sort lexicographically
        so every node that shares the converged view builds the same ring.
        """
        members = sorted(view.members() if hasattr(view, "members")
                         else view)
        return cls.build(members, factor=min(factor, len(members)),
                         n_partitions=n_partitions, seed=seed, epoch=epoch)

    # ----------------------------------------------------------- placement
    def _score(self, pid: int, actor: str) -> int:
        h = blake2b(digest_size=8,
                    key=self.seed.to_bytes(8, "big", signed=False))
        h.update(pid.to_bytes(4, "big"))
        h.update(actor.encode())
        return int.from_bytes(h.digest(), "big")

    def partition(self, set_name: bytes, element: bytes) -> int:
        """The partition id of one ``(set, element)`` — seeded, stable."""
        if self.full_replication:
            return 0
        h = blake2b(digest_size=8,
                    key=self.seed.to_bytes(8, "big", signed=False))
        h.update(set_name)
        h.update(b"\x00")
        h.update(element)
        return int.from_bytes(h.digest(), "big") % self.n_partitions

    def owners(self, pid: int) -> Tuple[str, ...]:
        return self._ranking[pid][: self.factor]

    def fallbacks(self, pid: int) -> Tuple[str, ...]:
        return self._ranking[pid][self.factor:]

    def preference_list(self, set_name: bytes,
                        element: bytes) -> PreferenceList:
        pid = self.partition(set_name, element)
        return PreferenceList(pid, self.owners(pid), self.fallbacks(pid))

    def partitions(self) -> range:
        return range(self.n_partitions)

    def write_quorum(self) -> int:
        """Majority of the replication factor — the ack threshold."""
        return self.factor // 2 + 1

    # ------------------------------------------------------------- storage
    def storage_set(self, set_name: bytes, pid: int) -> bytes:
        """The bigset name partition ``pid`` of ``set_name`` stores under."""
        if self.full_replication:
            return set_name
        return partition_set(set_name, pid)

    def storage_sets(self, set_name: bytes) -> List[bytes]:
        return [self.storage_set(set_name, pid) for pid in self.partitions()]

    # --------------------------------------------------------- ring change
    def with_actors(self, actors: Sequence[str],
                    epoch: Optional[int] = None) -> "Ring":
        """A new ring over ``actors`` at ``epoch`` (default: bump by one)."""
        actors = tuple(actors)
        epoch = self.epoch + 1 if epoch is None else epoch
        if self.full_replication:
            return Ring.full(actors, epoch=epoch)
        return Ring(actors=actors, factor=min(self.factor, len(actors)),
                    n_partitions=self.n_partitions, seed=self.seed,
                    epoch=epoch)

    def delta_to(self, new: "Ring") -> "RingDelta":
        """The ownership moves between this ring and ``new``.

        Only partitions whose owner set changed appear — the heart of the
        O(moved partitions) rebalance bound.
        """
        if new.n_partitions != self.n_partitions and not (
                self.full_replication and new.full_replication):
            raise ValueError("rings must share a partition space")
        moves = []
        for pid in self.partitions():
            old = self.owners(pid)
            now = new.owners(pid)
            if set(old) != set(now):
                moves.append(PartitionMove(
                    pid=pid, old_owners=old, new_owners=now,
                    joined=tuple(a for a in now if a not in old),
                    left=tuple(a for a in old if a not in now)))
        return RingDelta(old_epoch=self.epoch, new_epoch=new.epoch,
                         moves=tuple(moves))


@dataclass(frozen=True)
class PartitionMove:
    """One partition's ownership change inside a :class:`RingDelta`."""

    pid: int
    old_owners: Tuple[str, ...]
    new_owners: Tuple[str, ...]
    joined: Tuple[str, ...]   # owners gained: must pull the partition
    left: Tuple[str, ...]     # owners lost: retire once joiners dominate

    def survivors(self) -> Tuple[str, ...]:
        """Old owners that remain owners — the preferred handoff donors."""
        return tuple(a for a in self.old_owners if a in self.new_owners)


@dataclass(frozen=True)
class RingDelta:
    """Ownership moves between two ring epochs (what handoff must ship)."""

    old_epoch: int
    new_epoch: int
    moves: Tuple[PartitionMove, ...]

    def moved_pids(self) -> Tuple[int, ...]:
        return tuple(m.pid for m in self.moves)


# ------------------------------------------------------------ coverage plan
@dataclass(frozen=True)
class CoveragePlan:
    """A minimal covering set over partial owners for one query.

    ``assignments`` maps every partition the query touches to the ``r``
    live owners whose streams join its quorum merge; ``vnodes`` is the
    (minimised) union — the query's storage footprint.  Surfaced to
    clients via :attr:`repro.query.executor.QueryStats.coverage`.
    """

    epoch: int
    r: int
    assignments: Tuple[Tuple[int, bytes, Tuple[str, ...]], ...]
    vnodes: FrozenSet[str]

    def describe(self) -> str:
        return (f"epoch={self.epoch};partitions={len(self.assignments)};"
                f"vnodes={len(self.vnodes)};r={self.r}")


def plan_coverage(ring: Ring, set_name: bytes, live: Iterable[str], r: int,
                  pids: Optional[Iterable[int]] = None) -> CoveragePlan:
    """Greedy minimal covering set: ``r`` live owners per partition.

    Owners already selected for another partition are preferred, so the
    plan's vnode footprint stays near the theoretical minimum and each
    touched vnode answers for many partitions in one pass.  Raises
    :class:`VnodeDown` naming a crashed owner when any partition cannot
    field ``r`` live owners — a coverage query never silently degrades
    below its quorum.
    """
    live_set = frozenset(live)
    chosen: Dict[int, Tuple[str, ...]] = {}
    used: set = set()
    for pid in (ring.partitions() if pids is None else pids):
        owners = ring.owners(pid)
        alive = [a for a in owners if a in live_set]
        if len(alive) < r:
            down = next((a for a in owners if a not in live_set), None)
            if down is None:
                raise ValueError(
                    f"r={r} exceeds replication factor {len(owners)}")
            raise VnodeDown(
                f"partition {pid} of {set_name!r} needs {r} owners, "
                f"{len(alive)} live (owner {down} down)",
                vnode=down, set_name=set_name)
        picked = [a for a in alive if a in used][:r]
        for a in alive:
            if len(picked) >= r:
                break
            if a not in picked:
                picked.append(a)
        used.update(picked)
        chosen[pid] = tuple(picked)
    assignments = tuple(
        (pid, ring.storage_set(set_name, pid), chosen[pid])
        for pid in sorted(chosen))
    return CoveragePlan(epoch=ring.epoch, r=r, assignments=assignments,
                        vnodes=frozenset(used))
