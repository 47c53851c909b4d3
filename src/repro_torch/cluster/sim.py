"""Deterministic message-passing simulation for replica clusters.

Delivery semantics are configurable per test: messages can be dropped,
duplicated, and delivered in arbitrary (seeded-random) order.  CRDT
convergence must hold under *all* of these — the property tests drive this
directly.  Byte accounting (``bytes_sent``) feeds the paper's network-cost
comparisons (§3: deltas save wire bytes; §4: bigset saves wire *and* disk).

PyTorch port: a copy of :mod:`repro.cluster.sim`; everything below
this docstring is unchanged.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple


class DeliveryBudget(RuntimeError):
    """``deliver_all`` ran out of ``max_steps`` with messages still queued."""


@dataclass
class Message:
    src: str
    dst: str
    payload: Any
    size_bytes: int


class Network:
    def __init__(
        self,
        seed: int = 0,
        drop_prob: float = 0.0,
        dup_prob: float = 0.0,
        reorder: bool = False,
    ):
        self.rng = random.Random(seed)
        self.drop_prob = drop_prob
        self.dup_prob = dup_prob
        self.reorder = reorder
        self.queue: List[Message] = []
        self.bytes_sent = 0
        self.msgs_sent = 0
        self.msgs_dropped = 0
        # Crashed actors: traffic to them is dropped at send time AND at
        # delivery time — messages queued before the crash must not arrive
        # at a vnode that no longer exists.
        self.blackholes: Set[str] = set()

    def blackhole(self, actor: str) -> None:
        """Start dropping all traffic addressed to ``actor`` (crashed)."""
        self.blackholes.add(actor)

    def heal(self, actor: str) -> None:
        """Stop blackholing ``actor`` (restarted)."""
        self.blackholes.discard(actor)

    def send(self, src: str, dst: str, payload: Any, size_bytes: int) -> None:
        """Enqueue a message; ``size_bytes`` is its billed wire volume.

        The parameter is **required**, and a non-empty payload billed at
        zero raises: ``bytes_sent`` feeds every wire-cost comparison (and
        now the ``net.*`` metrics), so an unbilled call site would make
        those read 0 silently — the bug class this guard exists for.
        Empty-payload control messages (``None``, ``b""``, ``0``) may
        legitimately bill zero.
        """
        if size_bytes <= 0 and payload:
            raise ValueError(
                f"non-empty payload {type(payload).__name__} billed "
                f"{size_bytes} wire bytes ({src}->{dst})")
        self.msgs_sent += 1
        self.bytes_sent += size_bytes  # billed even if dropped: it was sent
        if dst in self.blackholes:
            self.msgs_dropped += 1
            return
        if self.drop_prob and self.rng.random() < self.drop_prob:
            self.msgs_dropped += 1
            return
        self.queue.append(Message(src, dst, payload, size_bytes))
        if self.dup_prob and self.rng.random() < self.dup_prob:
            self.queue.append(Message(src, dst, payload, size_bytes))

    def pending(self) -> int:
        return len(self.queue)

    def deliver_one(self, handler: Callable[[Message], None]) -> bool:
        if not self.queue:
            return False
        idx = self.rng.randrange(len(self.queue)) if self.reorder else 0
        msg = self.queue.pop(idx)
        if msg.dst in self.blackholes:
            self.msgs_dropped += 1  # queued before the crash, never arrives
            return True
        handler(msg)
        return True

    def deliver_all(self, handler: Callable[[Message], None], max_steps: int = 1_000_000) -> int:
        """Deliver until the queue drains.  Raises :class:`DeliveryBudget`
        if ``max_steps`` deliveries were not enough — callers treat
        ``deliver_all`` as "everything arrived" (``settle()``, replication
        fan-out), so silently returning with traffic still queued would
        turn a budget overrun into invisible message loss."""
        n = 0
        while self.queue and n < max_steps:
            self.deliver_one(handler)
            n += 1
        if self.queue:
            raise DeliveryBudget(
                f"deliver_all: {len(self.queue)} messages still queued "
                f"after {max_steps} deliveries")
        return n
