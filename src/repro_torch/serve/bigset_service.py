"""Bigset query service — the serve layer over :class:`BigsetCluster`.

The paper's trade-off is that decomposition costs full-set reads but "is
mitigated by enabling queries on sets"; the query layer builds them and this
module serves them: a request/response layer that accepts wire-encoded
query plans (msgpack, versioned envelope — :func:`repro.query.plan.
plan_to_wire`), dispatches them through ``BigsetCluster.query()``, and
streams results back as **cursor-paginated pages** with per-page
:class:`~repro.query.executor.QueryStats` attached.  Like a delta on the
write path, a page on the read path costs O(page + causal metadata) bytes,
never O(n) — asserted in ``tests/test_serve_bigset.py``.

Three serve-layer concerns live here, deliberately outside the query
engine:

* **Admission control / backpressure** — a bounded in-flight budget, by
  outstanding pages (open cursor leases) and by bytes (a sliding window
  fed from per-query IoStats via the :class:`~repro.cluster.clusters.
  ClusterSession` hook).  Overload gets an explicit ``RetryAfter``-style
  rejection (status ``"retry"`` + seconds hint), **never** a dropped or
  invalidated cursor: a client resumes the same token after backing off.
* **Cursor leases** — raw executor cursors are never handed out.  Each
  page's resume token is wrapped (:func:`repro.query.cursor.wrap_lease`)
  binding it to the issuing session, and the service tracks a per-lease
  deadline: any valid touch (even a rejected one) renews it, idle leases
  expire and are swept, and a foreign session's token is refused.
* **Write path** — insert / remove / batch mutate with causal-context
  round-tripping: an insert answers with its minted dot, a membership
  query answers with the element's surviving dots, and a remove accepts
  exactly those wire dots back as its observed-remove context (§4.3.2).

Transport is deliberately abstract: :meth:`BigsetService.handle` maps one
request byte-string to one response byte-string, so any socket server,
RPC framework, or in-process test can carry the protocol.

PyTorch port: a copy of :mod:`repro.serve.bigset_service`; everything below
this docstring is unchanged except its lint escapes: they are the port's
linter's (``# bigset-lint-torch:``, read by ``python -m
repro_torch.analysis``) in place of the reference's (``# bigset-lint:``,
read by ``python -m repro.analysis``).
"""
from __future__ import annotations

import secrets
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import msgpack

from ..cluster.clusters import BigsetCluster, ClusterSession
from ..core.clock import runs_from_counters
from ..core.dots import Dot, DotList
from ..obs.metrics import (MetricsRegistry, lift_ae_stats,
                           lift_dispatch_stats, lift_io_stats, lift_network,
                           lift_query_stats)
from ..obs.trace import NULL_TRACER, Tracer
from ..query import cursor as query_cursor
from ..query.cursor import LeaseError, unwrap_lease, wrap_lease
from ..query.executor import QueryResult
from ..query.plan import Plan, PlanError, plan_from_wire, plan_to_wire

WIRE_VERSION = 1
ANON_SESSION = b""  # implicit session for clients that never open one

STATUS_OK = "ok"
STATUS_RETRY = "retry"
STATUS_ERROR = "error"


class ServiceError(Exception):
    """A request the service refused; ``kind`` keys the wire error body."""

    def __init__(self, kind: str, message: str):
        super().__init__(message)
        self.kind = kind


class Backpressure(Exception):
    """Client-side surfacing of a ``retry`` response (admission rejected)."""

    def __init__(self, reason: str, retry_after: float):
        super().__init__(f"backpressured ({reason}): retry in {retry_after:.3f}s")
        self.reason = reason
        self.retry_after = retry_after


@dataclass(frozen=True)
class ServiceConfig:
    """Serve-layer knobs; defaults suit an in-process demo cluster."""

    byte_budget: int = 4 << 20      # bytes_read served per budget window
    budget_window: float = 1.0      # seconds before the byte budget refills
    max_open_cursors: int = 64      # outstanding pages across all sessions
    lease_ttl: float = 30.0         # idle seconds before a cursor lease dies
    retry_after: float = 0.05       # hint when rejected on open cursors
    max_page_size: int = 10_000     # page_size/limit cap per request
    default_r: Optional[int] = None  # quorum size (None = majority)


# ----------------------------------------------------------------- wire dots
def dots_to_wire(dots: Sequence[Dot]) -> List[List]:
    """Run-compressed causal context: ``[[actor, lo, hi], ...]``.

    Contiguous counters per actor coalesce into one triple, so a ctx stays
    O(interval runs) on the wire however many dots it covers.  A single dot
    rides as ``[actor, c, c]``.
    """
    by_actor: dict = {}
    for d in dots:
        by_actor.setdefault(d.actor, []).append(d.counter)
    out: List[List] = []
    for a in sorted(by_actor, key=repr):
        for lo, hi in runs_from_counters(by_actor[a]):
            out.append([a, lo, hi])
    return out


def dots_from_wire(wire) -> DotList:
    """Decode a wire ctx — run triples or the legacy per-dot 2-lists."""
    try:
        out: List[Dot] = []
        for item in wire or ():
            if len(item) == 2:          # legacy [actor, counter]
                a, c = item
                out.append(Dot(a, int(c)))
            else:
                a, lo, hi = item
                lo, hi = int(lo), int(hi)
                if lo > hi:
                    raise ValueError(f"empty run [{lo}, {hi}]")
                out.extend(Dot(a, c) for c in range(lo, hi + 1))
        return tuple(out)
    except (TypeError, ValueError) as e:
        raise ServiceError("request", f"malformed dot list: {e}") from None


@dataclass
class _Lease:
    session: bytes
    deadline: float
    # the ring epoch the page's coverage plan ran under: a resume re-plans
    # under the same ring so pagination never straddles two placements; a
    # retired epoch falls forward to the current ring (cursors are element
    # boundaries, so the page resumes from the same element regardless)
    epoch: Optional[int] = None


@dataclass
class _Session:
    tokens: Set[bytes] = field(default_factory=set)


class _Accounting(ClusterSession):
    """The cluster-session hook feeding admission control from IoStats."""

    def __init__(self, service: "BigsetService"):
        self._svc = service

    def observe_query(self, plan, result: QueryResult) -> None:
        self._svc._window_bytes += result.stats.bytes_read
        self._svc.pages_served += 1

    def observe_mutation(self, delta) -> None:
        self._svc.mutations_applied += 1


class BigsetService:
    """One service front-end over one :class:`BigsetCluster`.

    ``clock`` is injectable (monotonic seconds) so tests drive lease expiry
    and budget-window refills deterministically.
    """

    def __init__(
        self,
        cluster: BigsetCluster,
        config: Optional[ServiceConfig] = None,
        clock: Callable[[], float] = time.monotonic,  # bigset-lint-torch: disable=BS001 -- default for the *injectable* lease/budget clock; tests inject a fake
        tracer: Optional[Tracer] = None,
        metrics: Optional[MetricsRegistry] = None,
    ):
        self.cluster = cluster
        self.config = config or ServiceConfig()
        self._clock = clock
        self._acct = _Accounting(self)
        self._sessions: Dict[bytes, _Session] = {ANON_SESSION: _Session()}
        self._leases: Dict[bytes, _Lease] = {}
        self._lease_seq = 0  # nonce: identical cursors get distinct tokens
        self._window_start = clock()
        self._window_bytes = 0
        # observability: the tracer defaults to the CLUSTER's, so serve
        # spans and cluster/replica/network spans land in one tree; the
        # registry is the node-wide joined view the ``stats`` op snapshots
        self.tracer = tracer or getattr(cluster, "tracer", None) or \
            NULL_TRACER
        self.metrics = metrics or MetricsRegistry()
        self._session_stats: Dict[bytes, Dict[str, int]] = {}
        # observability counters (benchmarks read these)
        self.pages_served = 0
        self.mutations_applied = 0
        self.rejections = 0

    # -------------------------------------------------------------- transport
    def handle(self, request: bytes) -> bytes:
        """One wire request in, one wire response out (the whole protocol).

        Every decodable request runs inside a ``serve.request`` root span
        (op + final status), so the span trees of everything downstream —
        cluster coordinator, per-replica coverage, storage, kernel,
        network, read repair — hang off one serve-layer root per request.
        Request latency lands in the ``serve.request_seconds`` histogram,
        driven by the injectable service clock (deterministic in tests).
        """
        try:
            op, body = self._decode_request(request)
        except ServiceError as e:
            self.metrics.counter("serve.requests_undecodable").inc()
            return msgpack.packb([WIRE_VERSION, STATUS_ERROR,
                                  {"error": e.kind, "message": str(e)}])
        t0 = self._clock()
        with self.tracer.span("serve.request", op=op) as sp:
            try:
                status, out = self._dispatch(op, body)
            except Backpressure as bp:
                self.rejections += 1
                self.metrics.counter("serve.rejections").inc()
                status, out = STATUS_RETRY, {
                    "reason": bp.reason, "retry_after": bp.retry_after}
            except ServiceError as e:
                status, out = STATUS_ERROR, {
                    "error": e.kind, "message": str(e)}
            except (PlanError, LeaseError, query_cursor.CursorError) as e:
                kind = ("plan" if isinstance(e, PlanError)
                        else "lease" if isinstance(e, LeaseError)
                        else "cursor")
                status, out = STATUS_ERROR, {
                    "error": kind, "message": str(e)}
            sp.set(status=status)
        self.metrics.counter("serve.requests").inc()
        self.metrics.counter(f"serve.requests.{op}").inc()
        self.metrics.histogram("serve.request_seconds").observe(
            self._clock() - t0)
        return msgpack.packb([WIRE_VERSION, status, out])

    def _decode_request(self, request: bytes) -> Tuple[str, dict]:
        try:
            envelope = msgpack.unpackb(request)
        except Exception as e:
            raise ServiceError("request", f"undecodable request: {e}") from None
        if not (isinstance(envelope, (list, tuple)) and len(envelope) == 3):
            raise ServiceError("request", f"malformed envelope: {envelope!r}")
        version, op, body = envelope
        if version != WIRE_VERSION:
            raise ServiceError("request", f"unsupported wire version {version!r}")
        if not isinstance(op, str) or not isinstance(body, dict):
            raise ServiceError("request", "envelope needs a str op and map body")
        return op, body

    def _dispatch(self, op: str, body: dict) -> Tuple[str, dict]:
        if op == "open_session":
            return STATUS_OK, self._open_session()
        if op == "close_session":
            return STATUS_OK, self._close_session(body)
        if op == "query":
            return STATUS_OK, self._query(body)
        if op == "insert":
            return STATUS_OK, self._insert(body)
        if op == "remove":
            return STATUS_OK, self._remove(body)
        if op == "batch":
            return STATUS_OK, self._batch(body)
        if op == "stats":
            return STATUS_OK, self._stats(body)
        raise ServiceError("request", f"unknown op {op!r}")

    # --------------------------------------------------------------- sessions
    def _open_session(self) -> dict:
        # unguessable: the id is the session's only credential — a
        # predictable one would let any client close (or probe) a
        # neighbor's session and destroy its cursor leases
        sid = b"s" + secrets.token_hex(16).encode()  # bigset-lint-torch: disable=BS001 -- the session id is a credential: unguessability beats replayability, and nothing downstream branches on its value
        self._sessions[sid] = _Session()
        return {"session": sid}

    def _close_session(self, body: dict) -> dict:
        sid = body.get("session", ANON_SESSION)
        sess = self._sessions.pop(sid, None)
        if sess is None:
            raise ServiceError("session", f"unknown session {sid!r}")
        for token in sess.tokens:
            self._leases.pop(token, None)
        self._session_stats.pop(sid, None)
        if sid == ANON_SESSION:  # the anon session is a fixture: recreate
            self._sessions[ANON_SESSION] = _Session()
        return {"closed": True, "released": len(sess.tokens)}

    def _session(self, body: dict) -> Tuple[bytes, _Session]:
        sid = body.get("session", ANON_SESSION)
        sess = self._sessions.get(sid)
        if sess is None:
            raise ServiceError("session", f"unknown session {sid!r}")
        return sid, sess

    # -------------------------------------------------------------- admission
    def _sweep(self, now: float) -> None:
        dead = [t for t, l in self._leases.items() if l.deadline <= now]
        for token in dead:
            lease = self._leases.pop(token)
            sess = self._sessions.get(lease.session)
            if sess is not None:
                sess.tokens.discard(token)

    def _admit(self, now: float, resuming: bool) -> None:
        """Admission control: raise :class:`Backpressure` instead of working.

        The byte budget is a window counter fed by ``_Accounting`` from
        per-query IoStats; once spent, queries are rejected until the
        window rolls.  The page budget bounds *outstanding* cursors — a
        resume never counts against it (it replaces its own lease), so
        backpressure can never strand a paginated scan midway.
        """
        if now - self._window_start >= self.config.budget_window:
            self._window_start = now
            self._window_bytes = 0
        if self._window_bytes >= self.config.byte_budget:
            remaining = self.config.budget_window - (now - self._window_start)
            raise Backpressure("byte_budget", max(remaining, 0.001))
        if not resuming and len(self._leases) >= self.config.max_open_cursors:
            raise Backpressure("open_cursors", self.config.retry_after)

    # ----------------------------------------------------------------- query
    def _query(self, body: dict) -> dict:
        sid, sess = self._session(body)
        wire_plan = body.get("plan")
        if not isinstance(wire_plan, bytes):
            raise ServiceError("request", "query needs a wire-encoded plan")
        plan = plan_from_wire(wire_plan)
        if getattr(plan, "cursor", None) is not None:
            # a raw executor cursor inside the plan would bypass lease
            # binding, expiry, AND admission accounting — pagination over
            # the wire goes through the lease token, full stop
            raise ServiceError(
                "request", "resume via the lease token, not plan.cursor")
        plan = self._cap_page(plan)
        now = self._clock()
        self._sweep(now)

        token = body.get("cursor")
        pinned: Optional[int] = None
        if token is not None:
            plan = self._resume(plan, token, sid, now)
            pinned = self._leases[token].epoch
        self._admit(now, resuming=token is not None)

        # cursor leases pin the ring epoch their plan ran under; a fresh
        # query plans under the current ring.  ring_for resolves a retired
        # or unknown pinned epoch forward, and the *resolved* epoch is what
        # the next page's lease pins.
        ring_epoch = self.cluster.ring_for(pinned).epoch
        r = self._quorum(body)
        repair = bool(body.get("repair", True))
        res = self.cluster.query(plan, r=r, repair=repair, session=self._acct,
                                 ring_epoch=ring_epoch)
        lift_query_stats(self.metrics, res.stats)
        self._note(sid, pages=1, bytes_read=res.stats.bytes_read,
                   elements=res.stats.elements_emitted,
                   kernel_launches=res.stats.kernel_launches)

        out = self._result_to_wire(res)
        if token is not None:
            self._release(token)
        if res.cursor is not None:
            out["cursor"] = self._mint(sid, sess, res.cursor, now,
                                       epoch=ring_epoch)
        return out

    def _cap_page(self, plan: Plan) -> Plan:
        cap = self.config.max_page_size
        if getattr(plan, "page_size", None) is not None and plan.page_size > cap:
            return replace(plan, page_size=cap)
        if getattr(plan, "limit", None) is not None and plan.limit > cap:
            return replace(plan, limit=cap)
        return plan

    def _resume(self, plan: Plan, token, sid: bytes, now: float) -> Plan:
        """Swap a lease token for the raw cursor it wraps, renewing it.

        Validation order matters: binding (is this your token?) before
        liveness (is it still leased?) before admission — so a rejected
        page both renews its lease and leaves it resumable.
        """
        if not isinstance(token, bytes):
            raise ServiceError("request", "cursor must be a lease token")
        raw = unwrap_lease(token, sid)
        lease = self._leases.get(token)
        if lease is None or lease.session != sid:
            raise LeaseError("cursor lease expired or unknown")
        lease.deadline = now + self.config.lease_ttl  # any valid touch renews
        try:
            return replace(plan, cursor=raw)
        except TypeError:
            raise PlanError(
                f"plan {type(plan).__name__} does not paginate") from None

    def _mint(self, sid: bytes, sess: _Session, raw_cursor: bytes,
              now: float, epoch: Optional[int] = None) -> bytes:
        self._lease_seq += 1
        token = wrap_lease(sid, raw_cursor, nonce=self._lease_seq)
        self._leases[token] = _Lease(sid, now + self.config.lease_ttl,
                                     epoch=epoch)
        sess.tokens.add(token)
        return token

    def _release(self, token: bytes) -> None:
        lease = self._leases.pop(token, None)
        if lease is not None:
            sess = self._sessions.get(lease.session)
            if sess is not None:
                sess.tokens.discard(token)

    # ----------------------------------------------------------------- stats
    def _note(self, sid: bytes, **deltas: int) -> None:
        """Accumulate per-session usage (the ``stats`` op's session view)."""
        acc = self._session_stats.setdefault(sid, {})
        for k, v in deltas.items():
            acc[k] = acc.get(k, 0) + v

    def _stats(self, body: dict) -> dict:
        """Metrics snapshot: the whole stack joined into one response.

        ``node`` lifts every layer's stat struct — storage IoStats
        (cluster-wide), anti-entropy ledger, simulated-network wire
        counters, Pallas dispatch ledger, serve admission state — into the
        uniformly named registry and snapshots it.  ``session`` is the
        calling session's own usage.  Like every response, the envelope is
        msgpack: a remote dashboard needs nothing but this op.
        """
        sid, _sess = self._session(body)
        reg = self.metrics
        lift_io_stats(reg, self.cluster.io_stats())
        if hasattr(self.cluster, "ae_stats"):
            lift_ae_stats(reg, self.cluster.ae_stats())
        lift_network(reg, self.cluster.net)
        lift_dispatch_stats(reg)
        reg.gauge("serve.pages_served").set(self.pages_served)
        reg.gauge("serve.mutations_applied").set(self.mutations_applied)
        reg.gauge("serve.open_cursors").set(len(self._leases))
        reg.gauge("serve.sessions").set(len(self._sessions))
        out = {"node": reg.snapshot(),
               "session": dict(self._session_stats.get(sid, {}))}
        if hasattr(self.cluster, "ring_state"):
            ring = self.cluster.ring_state()
            reg.gauge("cluster.ring_epoch").set(ring["epoch"])
            out["node"] = reg.snapshot()
            out["ring"] = ring
        return out

    def _result_to_wire(self, res: QueryResult) -> dict:
        out: dict = {
            "entries": [[el, dots_to_wire(dots)] for el, dots in res.entries],
            "cursor": None,
            "stats": dict(vars(res.stats)),
        }
        if res.present is not None:
            out["present"] = res.present
        if res.count is not None:
            out["count"] = res.count
        if res.index_entries is not None:
            out["index_entries"] = [
                [ik, el, dots_to_wire(dots)]
                for ik, el, dots in res.index_entries]
        return out

    # ----------------------------------------------------- request validation
    # every remote-controlled scalar is checked here so a malformed request
    # becomes an ``error`` response, never an exception escaping handle()
    def _coordinator(self, body: dict) -> int:
        c = body.get("coordinator", 0)
        if not isinstance(c, int) or not 0 <= c < self.cluster.n:
            raise ServiceError(
                "request",
                f"coordinator must be an int in [0, {self.cluster.n})")
        return c

    def _quorum(self, body: dict) -> Optional[int]:
        r = body.get("r", self.config.default_r)
        # quorum sizes are bounded by the ring's replication factor (== n
        # under the degenerate full-replication ring), not the vnode count
        max_r = getattr(getattr(self.cluster, "ring", None), "factor",
                        self.cluster.n)
        if r is not None and (
                not isinstance(r, int) or not 1 <= r <= max_r):
            raise ServiceError(
                "request", f"r must be an int in [1, {max_r}]")
        return r

    @staticmethod
    def _value(raw) -> bytes:
        if not isinstance(raw, bytes):
            raise ServiceError("request", "value must be bytes")
        return raw

    # ------------------------------------------------------------- write path
    def _insert(self, body: dict) -> dict:
        set_name, element = self._set_element(body)
        self._note(body.get("session", ANON_SESSION), mutations=1)
        delta = self.cluster.add(
            set_name, element,
            coordinator=self._coordinator(body),
            ctx=dots_from_wire(body.get("ctx")),
            value=self._value(body.get("value", b"")),
            session=self._acct)
        return {"element": element, "dot": dots_to_wire([delta.dot])[0]}

    def _remove(self, body: dict) -> dict:
        set_name, element = self._set_element(body)
        self._note(body.get("session", ANON_SESSION), mutations=1)
        ctx = body.get("ctx")
        delta = self.cluster.remove(
            set_name, element,
            coordinator=self._coordinator(body),
            ctx=dots_from_wire(ctx) if ctx is not None else None,
            session=self._acct)
        return {"removed": delta is not None,
                "ctx": dots_to_wire(delta.ctx) if delta is not None else []}

    def _batch(self, body: dict) -> dict:
        set_name = body.get("set")
        ops = body.get("ops")
        if not isinstance(set_name, bytes) or not isinstance(ops, list):
            raise ServiceError("request", "batch needs a set and an op list")
        coordinator = self._coordinator(body)
        parsed: List[Tuple] = []
        for op in ops:
            if not (isinstance(op, (list, tuple)) and len(op) >= 2):
                raise ServiceError("request", f"malformed batch op {op!r}")
            kind, element = op[0], op[1]
            if not isinstance(element, bytes):
                raise ServiceError("request", "batch elements must be bytes")
            if kind == "add":
                value = self._value(op[2]) if len(op) > 2 else b""
                ctx = dots_from_wire(op[3]) if len(op) > 3 else ()
                parsed.append(("add", element, value, ctx))
            elif kind == "remove":
                ctx = dots_from_wire(op[2]) if len(op) > 2 else None
                parsed.append(("remove", element, ctx))
            else:
                raise ServiceError("request", f"unknown batch op {kind!r}")
        self._note(body.get("session", ANON_SESSION), mutations=len(parsed))
        deltas = self.cluster.mutate(
            set_name, parsed, coordinator=coordinator, session=self._acct)
        results = []
        for delta in deltas:
            if delta is None:
                results.append({"removed": False})
            elif hasattr(delta, "dot"):
                results.append({"dot": dots_to_wire([delta.dot])[0]})
            else:
                results.append({"removed": True, "ctx": dots_to_wire(delta.ctx)})
        return {"results": results}

    @staticmethod
    def _set_element(body: dict) -> Tuple[bytes, bytes]:
        set_name, element = body.get("set"), body.get("element")
        if not isinstance(set_name, bytes) or not isinstance(element, bytes):
            raise ServiceError("request", "mutation needs bytes set and element")
        return set_name, element


# -------------------------------------------------------------------- client
@dataclass
class Page:
    """One decoded query response page."""

    entries: List[Tuple[bytes, DotList]]
    cursor: Optional[bytes]        # lease token; more pages exist iff not None
    stats: dict                    # per-page QueryStats (ints, plus the join
                                   # "strategy" the planner executed)
    present: Optional[bool] = None
    count: Optional[int] = None
    index_entries: Optional[List[Tuple[bytes, bytes, DotList]]] = None

    @property
    def members(self) -> List[bytes]:
        return [el for el, _ in self.entries]


class BigsetClient:
    """Thin wire-speaking client: every call round-trips through
    :meth:`BigsetService.handle` bytes, exactly as a remote client would.

    Pagination state is one lease token; :meth:`pages` iterates a paginated
    plan to exhaustion, backing off on ``retry`` responses via the
    injectable ``sleep`` (tests pass a fake-clock advancer).
    """

    def __init__(self, service: BigsetService):
        self._service = service
        self._session: Optional[bytes] = None

    # ------------------------------------------------------------- transport
    _ERROR_TYPES = {
        "plan": PlanError,
        "lease": LeaseError,
        "cursor": query_cursor.CursorError,
    }

    def _call(self, op: str, body: dict) -> dict:
        response = self._service.handle(
            msgpack.packb([WIRE_VERSION, op, body]))
        version, status, out = msgpack.unpackb(response)
        if version != WIRE_VERSION:
            raise ServiceError("response", f"wire version {version!r}")
        if status == STATUS_RETRY:
            raise Backpressure(out["reason"], out["retry_after"])
        if status == STATUS_ERROR:
            # re-hydrate the typed errors the service serialized, so client
            # code catches the same exceptions an in-process caller would
            exc = self._ERROR_TYPES.get(out["error"])
            if exc is not None:
                raise exc(out["message"])
            raise ServiceError(out["error"], out["message"])
        return out

    @property
    def session(self) -> bytes:
        if self._session is None:
            self._session = self._call("open_session", {})["session"]
        return self._session

    def close(self) -> None:
        if self._session is not None:
            self._call("close_session", {"session": self._session})
            self._session = None

    # ---------------------------------------------------------------- queries
    def query(self, plan: Plan, r: Optional[int] = None,
              cursor: Optional[bytes] = None) -> Page:
        """One page.  Raises :class:`Backpressure` on admission rejection —
        the cursor (ours or the one passed in) stays valid for a retry."""
        body = {"plan": plan_to_wire(plan), "session": self.session}
        if r is not None:
            body["r"] = r
        if cursor is not None:
            body["cursor"] = cursor
        out = self._call("query", body)
        return Page(
            entries=[(el, dots_from_wire(dots))
                     for el, dots in out["entries"]],
            cursor=out.get("cursor"),
            stats=out.get("stats", {}),
            present=out.get("present"),
            count=out.get("count"),
            index_entries=[
                (ik, el, dots_from_wire(dots))
                for ik, el, dots in out["index_entries"]]
            if out.get("index_entries") is not None else None,
        )

    def pages(self, plan: Plan, r: Optional[int] = None,
              sleep: Callable[[float], None] = time.sleep,
              max_retries: int = 64):
        """Iterate every page of a paginated plan, riding out backpressure."""
        cursor = None
        while True:
            retries = 0
            while True:
                try:
                    page = self.query(plan, r=r, cursor=cursor)
                    break
                except Backpressure as bp:
                    retries += 1
                    if retries > max_retries:
                        raise
                    sleep(bp.retry_after)
            yield page
            cursor = page.cursor
            if cursor is None:
                return

    def stats(self) -> dict:
        """Node-wide + this-session metrics snapshot (the ``stats`` op).

        ``out["node"]`` is the registry snapshot — uniformly named
        ``storage.* / antientropy.* / net.* / kernels.* / serve.* /
        query.*`` metrics; ``out["session"]`` is this session's usage.
        """
        return self._call("stats", {"session": self.session})

    def membership(self, set_name: bytes, element: bytes,
                   r: Optional[int] = None) -> Tuple[bool, List[List]]:
        """(present, wire ctx) — the ctx feeds straight into :meth:`remove`."""
        from ..query.plan import Membership

        page = self.query(Membership(set_name, element), r=r)
        ctx = dots_to_wire(page.entries[0][1]) if page.entries else []
        return bool(page.present), ctx

    # -------------------------------------------------------------- mutations
    def insert(self, set_name: bytes, element: bytes, value: bytes = b"",
               ctx: Optional[List[List]] = None) -> List:
        body = {"set": set_name, "element": element, "value": value,
                "session": self.session}
        if ctx:
            body["ctx"] = ctx
        return self._call("insert", body)["dot"]

    def remove(self, set_name: bytes, element: bytes,
               ctx: Optional[List[List]] = None) -> bool:
        body = {"set": set_name, "element": element, "session": self.session}
        if ctx is not None:
            body["ctx"] = ctx
        return self._call("remove", body)["removed"]

    def batch(self, set_name: bytes, ops: List[List]) -> List[dict]:
        return self._call("batch", {"set": set_name, "ops": ops,
                                    "session": self.session})["results"]
