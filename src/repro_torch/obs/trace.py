"""End-to-end tracing for the bigset stack.

One request — serve envelope in, page out — crosses six layers: the
service, the cluster coordinator, per-replica executors, LSM storage, the
Pallas visibility kernel, and the simulated network (replication, read
repair, anti-entropy).  Each layer's stat structs (IoStats, QueryStats,
AntiEntropyStats, ...) meter its own silo; this module is the joining
view: a **span** per unit of work, explicitly parented into one tree per
request, so the paper's cost claims become per-request evidence instead
of pull-based aggregates.

Design constraints, in order:

* **Disabled ⇒ zero behavior change.**  The default tracer is
  :data:`NULL_TRACER`: every instrumentation point degrades to a cheap
  no-op, and — critically — network payloads are *never* wrapped, so the
  bytes a disabled cluster ships are byte-identical to the pre-tracing
  code (asserted in ``tests/test_obs.py``).
* **Deterministic under injected clocks.**  The tracer takes a
  ``clock() -> float`` exactly like the serve layer's lease clock: tests
  drive a fake clock and assert exact span durations.  Span ids are a
  plain counter, not random — two identical runs produce identical trees.
* **Causality over call stacks.**  Synchronous work parents implicitly
  via a current-span stack; work that crosses the (droppable, duplicable,
  reorderable) network carries an explicit :class:`TraceContext` inside
  the message payload, so a replica's delivery span parents under the
  coordinator span *whenever it runs* — a dropped message is simply a
  missing leaf, a duplicated one is two leaves, never a broken tree.

PyTorch port: a copy of :mod:`repro.obs.trace`; everything below
this docstring is unchanged except its lint escapes: they are the port's
linter's (``# bigset-lint-torch:``, read by ``python -m
repro_torch.analysis``) in place of the reference's (``# bigset-lint:``,
read by ``python -m repro.analysis``).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional


@dataclass(frozen=True)
class TraceContext:
    """The portable identity of a span: enough to parent remote work.

    This is what rides inside network payloads (see
    :class:`~repro.cluster.clusters.TracedPayload`) — two ints, so the
    wire-byte cost of tracing is negligible and accountable.
    """

    trace_id: int
    span_id: int


class Span:
    """One unit of traced work.  Mutable until :meth:`Tracer.finish`."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start", "end",
                 "attrs")

    def __init__(self, name: str, trace_id: int, span_id: int,
                 parent_id: Optional[int], start: float,
                 attrs: Dict[str, Any]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end: Optional[float] = None
        self.attrs = attrs

    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def set(self, **attrs: Any) -> "Span":
        """Attach (or overwrite) attributes; returns self for chaining."""
        self.attrs.update(attrs)
        return self

    @property
    def duration(self) -> float:
        return (self.end - self.start) if self.end is not None else 0.0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"id={self.span_id}, parent={self.parent_id}, "
                f"dur={self.duration:.6f}, attrs={self.attrs})")


class Tracer:
    """Span factory + in-memory sink.

    ``clock`` is injectable monotonic seconds (the ``bigset_service``
    lease-clock idiom); ids are sequential so tests are exact.  Finished
    spans accumulate in :attr:`spans` until :meth:`clear` / :meth:`drain`
    — exporters (:mod:`repro.obs.export`) read them from there.
    """

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.monotonic):  # bigset-lint-torch: disable=BS001 -- default for the *injectable* clock; deterministic runs inject a fake (tests/test_obs.py)
        self._clock = clock
        self._next_id = 0
        self._stack: List[Span] = []
        self.spans: List[Span] = []

    # ------------------------------------------------------------ span api
    def current(self) -> Optional[TraceContext]:
        """Context of the innermost open span, or None outside any span."""
        return self._stack[-1].context() if self._stack else None

    def start(self, name: str, parent: Optional[TraceContext] = None,
              **attrs: Any) -> Span:
        """Open a span.  ``parent`` defaults to the current span; a span
        opened with neither starts a new trace (it is a root)."""
        if parent is None:
            parent = self.current()
        self._next_id += 1
        if parent is None:
            trace_id, parent_id = self._next_id, None
        else:
            trace_id, parent_id = parent.trace_id, parent.span_id
        return Span(name, trace_id, self._next_id, parent_id,
                    self._clock(), attrs)

    def finish(self, span: Span) -> Span:
        span.end = self._clock()
        self.spans.append(span)
        return span

    @contextmanager
    def span(self, name: str, parent: Optional[TraceContext] = None,
             **attrs: Any) -> Iterator[Span]:
        """Scoped span: children opened inside parent under it implicitly."""
        sp = self.start(name, parent=parent, **attrs)
        self._stack.append(sp)
        try:
            yield sp
        except BaseException as e:
            sp.set(error=type(e).__name__)
            raise
        finally:
            self._stack.pop()
            self.finish(sp)

    # ---------------------------------------------------------------- sink
    def clear(self) -> None:
        self.spans = []

    def drain(self) -> List[Span]:
        """Pop-and-return all finished spans (exporters' consume step)."""
        out, self.spans = self.spans, []
        return out


class _NullSpan(Span):
    """Shared inert span: every mutation is a no-op."""

    def __init__(self):
        super().__init__("null", 0, 0, None, 0.0, {})

    def set(self, **attrs: Any) -> "Span":
        return self

    def context(self) -> TraceContext:  # pragma: no cover - never parented
        return TraceContext(0, 0)


class NullTracer(Tracer):
    """Tracing off: no spans, no ids, no clock reads, no payload wrapping.

    Instrumentation points must ALSO consult :attr:`enabled` before doing
    anything that would alter observable behavior (wrapping a network
    payload, building attribute dicts from expensive reprs) — the null
    tracer makes the *span calls* free, ``enabled`` keeps the *side
    effects* out.
    """

    enabled = False
    _SPAN = _NullSpan()

    def __init__(self):
        super().__init__(clock=lambda: 0.0)

    def current(self) -> Optional[TraceContext]:
        return None

    def start(self, name: str, parent: Optional[TraceContext] = None,
              **attrs: Any) -> Span:
        return self._SPAN

    def finish(self, span: Span) -> Span:
        return span

    @contextmanager
    def span(self, name: str, parent: Optional[TraceContext] = None,
             **attrs: Any) -> Iterator[Span]:
        yield self._SPAN


NULL_TRACER = NullTracer()
