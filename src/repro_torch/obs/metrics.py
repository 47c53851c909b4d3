"""Unified metrics registry for the bigset stack.

The repo accumulated five siloed, pull-based stat structs (storage
:class:`~repro.storage.lsm.IoStats`, per-query :class:`~repro.query.
executor.QueryStats`, :class:`~repro.cluster.antientropy.AntiEntropyStats`,
:class:`~repro.cluster.sim.Network` counters, serve admission counters).
Each is still the *source of truth* for its layer — they are cheap,
allocation-free, and the benchmarks read them directly — but no single
view ever joined them.  This module is that view: a registry of uniformly
named counters, gauges, and fixed-bucket histograms, plus **adapters**
that lift each existing struct into it without the structs knowing.

Naming convention: dotted lowercase ``layer.field`` —
``storage.bytes_read``, ``serve.pages_served``, ``antientropy.
digest_bytes``, ``net.bytes_sent``, ``kernels.dot_seen.launches``.
Lifted snapshots are **gauges set to the struct's current value** (the
structs are already monotonic ledgers; re-lifting is idempotent), while
event-driven instrumentation (serve request counts, latency histograms)
uses counters/histograms owned by the registry itself.

PyTorch port: a copy of :mod:`repro.obs.metrics`; everything below
this docstring is unchanged.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple, Union

Number = Union[int, float]

# Default histogram buckets: latencies in seconds, 1us .. ~4s, x4 steps.
# Fixed at registration so two runs bucket identically (determinism).
LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    1e-6 * 4 ** i for i in range(12))


class Counter:
    """Monotonic event count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: Number = 1) -> None:
        if n < 0:
            raise ValueError(f"counter decremented by {n}")
        self.value += n

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Point-in-time value (lifted struct fields land here)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value: Number = 0

    def set(self, v: Number) -> None:
        self.value = v

    def inc(self, n: Number = 1) -> None:
        self.value += n

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket histogram: ``buckets`` are inclusive upper bounds,
    plus an implicit overflow bucket.  Bucketing is a bisect, so observe
    is O(log buckets) and two identical runs fill identical counts."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float] = LATENCY_BUCKETS):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"histogram buckets must be sorted: {buckets!r}")
        self.buckets: Tuple[float, ...] = tuple(buckets)
        self.counts: List[int] = [0] * (len(self.buckets) + 1)
        self.sum: float = 0.0
        self.count: int = 0

    def observe(self, v: Number) -> None:
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    def snapshot(self) -> dict:
        return {"type": "histogram", "buckets": list(self.buckets),
                "counts": list(self.counts), "sum": self.sum,
                "count": self.count}


Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Get-or-create registry keyed by metric name.

    A name is bound to one metric kind forever — asking for the same name
    as a different kind raises, so a typo cannot silently fork a series.
    ``snapshot()`` is a plain ``{name: {...}}`` dict in sorted-name order:
    msgpack/JSON-ready, which is exactly what the serve layer's ``stats``
    op and ``benchmarks/run.py --metrics-out`` ship.
    """

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}

    def _get(self, name: str, kind: type, **kwargs) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = kind(**kwargs)
        elif type(m) is not kind:
            raise TypeError(
                f"metric {name!r} is a {type(m).__name__}, "
                f"not a {kind.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
        h = self._get(name, Histogram, buckets=buckets)
        if h.buckets != tuple(buckets):
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{h.buckets}")
        return h

    def snapshot(self) -> Dict[str, dict]:
        return {name: self._metrics[name].snapshot()
                for name in sorted(self._metrics)}


# ------------------------------------------------------------------ adapters
# Lift the stack's existing stat structs into uniformly named gauges.  Each
# adapter reads ``vars(struct)`` so a field added to a struct shows up in
# the registry without touching this module — the structs stay the single
# source of field names.

def lift_struct(reg: MetricsRegistry, prefix: str, struct: object) -> None:
    """Lift every numeric field of a stats dataclass into ``prefix.field``."""
    for field_name, value in vars(struct).items():
        if isinstance(value, (int, float)):
            reg.gauge(f"{prefix}.{field_name}").set(value)


def lift_io_stats(reg: MetricsRegistry, io, prefix: str = "storage") -> None:
    """:class:`~repro.storage.lsm.IoStats` → ``storage.*`` gauges."""
    lift_struct(reg, prefix, io)


def lift_durable_media(reg: MetricsRegistry, media,
                       prefix: str = "storage.media") -> None:
    """:class:`~repro.storage.wal.DurableMedia` counters → gauges.

    ``wal_fsyncs`` against the store's batch count is the group-commit
    amortization evidence (fsyncs < batches at depth > 1); ``crashes``
    and the durable log size round out the fault ledger.  The replay-side
    counters (``bytes_recovered``, ``num_recoveries``) already ride
    :func:`lift_io_stats` — IoStats lifting is vars()-driven.
    """
    reg.gauge(f"{prefix}.wal_fsyncs").set(media.wal_fsyncs)
    reg.gauge(f"{prefix}.file_fsyncs").set(media.file_fsyncs)
    reg.gauge(f"{prefix}.wal_durable_bytes").set(len(media.wal))
    reg.gauge(f"{prefix}.wal_pending_bytes").set(media.wal_pending())
    reg.gauge(f"{prefix}.crashes").set(media.crashes)


def lift_query_stats(reg: MetricsRegistry, stats,
                     prefix: str = "query") -> None:
    """One query's :class:`~repro.query.executor.QueryStats` accumulated
    into ``query.*`` counters (queries are events, not snapshots); the
    join strategy becomes a per-strategy counter."""
    for field_name, value in vars(stats).items():
        if isinstance(value, (int, float)):
            reg.counter(f"{prefix}.{field_name}").inc(value)
    if getattr(stats, "strategy", ""):
        reg.counter(f"{prefix}.strategy.{stats.strategy}").inc()


def lift_ae_stats(reg: MetricsRegistry, stats,
                  prefix: str = "antientropy") -> None:
    """:class:`~repro.cluster.antientropy.AntiEntropyStats` →
    ``antientropy.*`` gauges."""
    lift_struct(reg, prefix, stats)


def lift_network(reg: MetricsRegistry, net, prefix: str = "net") -> None:
    """:class:`~repro.cluster.sim.Network` counters → ``net.*`` gauges.

    ``net.bytes_sent`` is the wire-bytes/op evidence the delta-interval
    replication work (ROADMAP) measures itself against — which is why
    :meth:`Network.send` now refuses un-billed non-empty payloads.
    """
    reg.gauge(f"{prefix}.bytes_sent").set(net.bytes_sent)
    reg.gauge(f"{prefix}.msgs_sent").set(net.msgs_sent)
    reg.gauge(f"{prefix}.msgs_dropped").set(net.msgs_dropped)
    reg.gauge(f"{prefix}.pending").set(net.pending())


def lift_dispatch_stats(reg: MetricsRegistry, stats: Optional[object] = None,
                        prefix: str = "kernels.dot_seen") -> None:
    """Pallas ``dot_seen`` launch ledger → ``kernels.dot_seen.*`` gauges.

    Defaults to the process-wide :data:`repro.kernels.dot_seen.ops.
    DISPATCHES` counter — the baseline the ROADMAP cross-query
    micro-batcher must beat (fewer launches over wider batches).
    """
    if stats is None:
        from ..kernels.dot_seen.ops import DISPATCHES
        stats = DISPATCHES
    lift_struct(reg, prefix, stats)
