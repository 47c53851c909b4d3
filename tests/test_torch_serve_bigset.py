"""The reference's serve-layer cases (``tests/test_serve_bigset.py``), held
against JAX.

Each case drives the same workload through both packages' services
(:mod:`torch_sides`), asserts what the reference case asserts on each, and
asserts equal answers: page entries, per-page stats, plan wire bytes,
response envelopes, minted dots and the raw cursor inside every lease
token.  Session ids are random by design (a session id is a credential),
so a lease token is compared by what it wraps: its cursor and nonce.  The
port runs on the CPU.
"""
import base64

import msgpack
import pytest
from hypothesis import given, settings, strategies as st

from torch_sides import both, cluster_state

S = b"srvset"
T = b"srvset2"
ELEMS = [b"a", b"b", b"c", b"d", b"e", b"f", b"g", b"h", b"i", b"j"]

ops_st = st.lists(
    st.tuples(
        st.sampled_from(["add", "rem"]),
        st.integers(0, 2),
        st.sampled_from(ELEMS),
    ),
    max_size=24,
)


def make_service(P, n=3, config=None):
    """Service over a fresh cluster with a test-controlled clock."""
    cluster = P.BigsetCluster(n)
    clk = [0.0]
    service = P.BigsetService(cluster, config, clock=lambda: clk[0])
    return cluster, service, P.BigsetClient(service), clk


def apply_ops(cluster, ops, set_name=S):
    for op, coord, el in ops:
        if op == "add":
            cluster.add(set_name, el, coordinator=coord)
        else:
            cluster.remove(set_name, el, coordinator=coord)


def lease_of(token):
    """What a lease token wraps, without the session it is bound to."""
    if token is None:
        return None
    _version, _sid, cursor, nonce = msgpack.unpackb(
        base64.urlsafe_b64decode(token)[:-4])
    return cursor, nonce


def view(page):
    """A page with its lease token replaced by what the token wraps."""
    return (page.entries, lease_of(page.cursor), page.stats, page.present,
            page.count, page.index_entries)


def call(P, service, op, body):
    raw = service.handle(msgpack.packb([P.WIRE_VERSION, op, body]))
    return msgpack.unpackb(raw)


# ---------------------------------------------------------------- wire codec
def wire_plans(P):
    return [
        P.Membership(S, b"x"),
        P.Range(S, start=b"a", end=b"z", limit=10),
        P.Range(S, cursor=b"tok"),
        P.Count(S, start=b"b"),
        P.Scan(S, page_size=7),
        P.Join("intersect", S, T, limit=3),
        P.Join("union", S, T),
        P.Join("difference", S, T, cursor=b"tok"),
        P.IndexLookup(S, b"idx", b"key", limit=2),
        P.IndexRange(S, b"idx", start=b"a", end=b"m", limit=5, cursor=b"tok"),
    ]


class TestPlanWire:
    def test_roundtrip_every_shape(self):
        def case(P):
            out = []
            for plan in wire_plans(P):
                wire = P.plan_to_wire(plan)
                assert P.plan_from_wire(wire) == plan
                out.append(wire)
            return out
        both(case)

    @given(st.binary(max_size=12), st.binary(max_size=12),
           st.integers(1, 1000))
    @settings(max_examples=40)
    def test_roundtrip_property(self, set_name, start, limit):
        def case(P):
            plan = P.Range(set_name or b"s", start=start or None, limit=limit)
            wire = P.plan_to_wire(plan)
            assert P.plan_from_wire(wire) == plan
            return wire
        both(case)

    def test_malformed_envelopes(self):
        def case(P):
            out = []
            for blob in (
                    b"\xffnot-msgpack",
                    msgpack.packb(["nope"]),
                    msgpack.packb([99, "scan", {"set_name": S}]),
                    msgpack.packb([1, "explode", {}]),
                    msgpack.packb([1, "scan", {"set_name": S, "hacker": 1}]),
                    msgpack.packb([1, "scan", {"set_name": S,
                                               "page_size": -4}])):
                with pytest.raises(P.PlanError) as err:
                    P.plan_from_wire(blob)
                out.append(err.value)
            return out
        both(case)

    def test_invalid_plan_never_encodes(self):
        def case(P):
            with pytest.raises(P.PlanError) as err:
                P.plan_to_wire(P.Scan(S, page_size=0))
            return err.value
        both(case)


# -------------------------------------------------------------------- leases
class TestLeases:
    def test_wrap_roundtrip_and_binding(self):
        def case(P):
            tok = P.wrap_lease(b"sess1", b"cursor-bytes")
            assert P.unwrap_lease(tok, b"sess1") == b"cursor-bytes"
            with pytest.raises(P.LeaseError) as e1:
                P.unwrap_lease(tok, b"sess2")
            corrupt = bytearray(tok)
            corrupt[5] = (corrupt[5] + 1) % 128
            with pytest.raises(P.LeaseError) as e2:
                P.unwrap_lease(bytes(corrupt), b"sess1")
            return tok, e1.value, e2.value
        both(case)

    def test_lease_expiry(self):
        def case(P):
            _, service, client, clk = make_service(
                P, config=P.ServiceConfig(lease_ttl=10.0))
            client.batch(S, [["add", el] for el in ELEMS])
            page = client.query(P.Scan(S, page_size=3))
            clk[0] += 11.0  # idle past the ttl
            with pytest.raises(P.LeaseError) as err:
                client.query(P.Scan(S, page_size=3), cursor=page.cursor)
            assert not service._leases
            return view(page), err.value
        both(case)

    def test_foreign_session_refused(self):
        def case(P):
            _, service, client, _ = make_service(P)
            client.batch(S, [["add", el] for el in ELEMS])
            page = client.query(P.Scan(S, page_size=3))
            other = P.BigsetClient(service)
            assert other.session != client.session
            with pytest.raises(P.LeaseError) as err:
                other.query(P.Scan(S, page_size=3), cursor=page.cursor)
            rest = client.query(P.Scan(S, page_size=100), cursor=page.cursor)
            assert page.members + rest.members == sorted(ELEMS)
            return view(page), err.value, view(rest)
        both(case)

    def test_close_session_releases_leases(self):
        def case(P):
            _, service, client, _ = make_service(
                P, config=P.ServiceConfig(max_open_cursors=1))
            client.batch(S, [["add", el] for el in ELEMS])
            first = client.query(P.Scan(S, page_size=2))
            fresh = P.BigsetClient(service)
            with pytest.raises(P.Backpressure) as bp:
                fresh.query(P.Scan(S, page_size=2))
            assert bp.value.reason == "open_cursors"
            client.close()
            again = fresh.query(P.Scan(S, page_size=2))
            assert again.members == ELEMS[:2]
            return (view(first), bp.value.reason, bp.value.retry_after,
                    view(again))
        both(case)

    def test_plan_embedded_cursor_is_refused(self):
        def case(P):
            _, service, client, _ = make_service(P)
            client.batch(S, [["add", el] for el in ELEMS])
            page = client.query(P.Scan(S, page_size=3))
            raw_cursor = P.unwrap_lease(page.cursor, client.session)
            with pytest.raises(P.ServiceError) as err:
                client.query(P.Scan(S, page_size=3, cursor=raw_cursor))
            assert err.value.kind == "request"
            with pytest.raises(P.ServiceError) as err2:
                client.query(P.Range(S, cursor=raw_cursor))
            rest = client.query(P.Scan(S, page_size=100), cursor=page.cursor)
            assert page.members + rest.members == sorted(ELEMS)
            return raw_cursor, err.value, err2.value, view(rest)
        both(case)

    def test_identical_scans_hold_independent_leases(self):
        def case(P):
            _, service, client, _ = make_service(P)
            client.batch(S, [["add", el] for el in ELEMS])
            a = client.query(P.Scan(S, page_size=2))
            b = client.query(P.Scan(S, page_size=2))
            assert a.members == b.members and a.cursor != b.cursor
            a2 = client.query(P.Scan(S, page_size=2), cursor=a.cursor)
            b2 = client.query(P.Scan(S, page_size=2), cursor=b.cursor)
            assert a2.members == b2.members == sorted(ELEMS)[2:4]
            return [view(p) for p in (a, b, a2, b2)]
        both(case)

    def test_session_ids_are_not_guessable(self):
        def case(P):
            _, service, client, _ = make_service(P)
            other = P.BigsetClient(service)
            assert client.session != other.session
            assert len(client.session) >= 16  # a credential, not a counter
            return len(client.session), len(other.session)
        both(case)

    def test_rejected_touch_renews_lease(self):
        def case(P):
            _, service, client, clk = make_service(
                P, config=P.ServiceConfig(byte_budget=1, budget_window=20.0,
                                          lease_ttl=10.0))
            client.batch(S, [["add", el] for el in ELEMS])
            page = client.query(P.Scan(S, page_size=2))  # t=0
            waits = []
            for t in (6.0, 12.0):  # each rejected touch renews the lease
                clk[0] = t
                with pytest.raises(P.Backpressure) as bp:
                    client.query(P.Scan(S, page_size=2), cursor=page.cursor)
                waits.append(bp.value.retry_after)
            clk[0] = 21.0  # window rolled at t=20; the lease is alive
            rest = client.query(P.Scan(S, page_size=100), cursor=page.cursor)
            assert page.members + rest.members == sorted(ELEMS)
            return view(page), waits, view(rest)
        both(case)


# -------------------------------------------------------------- backpressure
class TestBackpressure:
    def test_rejection_is_observable_on_the_wire(self):
        def case(P):
            _, service, client, clk = make_service(
                P, config=P.ServiceConfig(byte_budget=1, budget_window=5.0))
            client.batch(S, [["add", el] for el in ELEMS])
            client.query(P.Scan(S, page_size=2))  # spends the budget
            raw = service.handle(msgpack.packb([P.WIRE_VERSION, "query", {
                "plan": P.plan_to_wire(P.Scan(S, page_size=2)),
                "session": client.session}]))
            version, status, body = msgpack.unpackb(raw)
            assert (version, status) == (P.WIRE_VERSION, P.STATUS_RETRY)
            assert body["reason"] == "byte_budget"
            assert 0 < body["retry_after"] <= 5.0
            assert service.rejections == 1
            return raw
        both(case)

    def test_rejection_preserves_cursor_and_resume_is_exact(self):
        def case(P):
            _, service, client, clk = make_service(
                P, config=P.ServiceConfig(byte_budget=1, budget_window=5.0,
                                          lease_ttl=1e9))
            client.batch(S, [["add", el] for el in ELEMS])
            one_shot = client.query(P.Scan(S, page_size=100)).members
            clk[0] += 5.0
            page = client.query(P.Scan(S, page_size=3))
            got = list(page.members)
            cursor = page.cursor
            rejections, pages = 0, [view(page)]
            while cursor is not None:
                try:
                    page = client.query(P.Scan(S, page_size=3), cursor=cursor)
                except P.Backpressure as bp:
                    rejections += 1
                    clk[0] += bp.retry_after  # back off, retry the same token
                    continue
                got.extend(page.members)
                pages.append(view(page))
                cursor = page.cursor
            assert rejections > 0, "budget never engaged; test is vacuous"
            assert got == one_shot
            return pages, rejections, service.rejections
        both(case)

    def test_budget_window_refills(self):
        def case(P):
            _, service, client, clk = make_service(
                P, config=P.ServiceConfig(byte_budget=1, budget_window=2.0))
            client.batch(S, [["add", el] for el in ELEMS])
            first = client.query(P.Count(S))
            with pytest.raises(P.Backpressure) as bp:
                client.query(P.Count(S))
            clk[0] += 2.0
            again = client.query(P.Count(S))
            assert again.count == len(ELEMS)
            return view(first), bp.value.retry_after, view(again)
        both(case)

    def test_mutations_bypass_read_budget(self):
        def case(P):
            _, service, client, clk = make_service(
                P, config=P.ServiceConfig(byte_budget=1, budget_window=1e9))
            client.query(P.Count(S))
            with pytest.raises(P.Backpressure) as bp:
                client.query(P.Count(S))
            dot = client.insert(S, b"still-writable")
            assert dot
            return bp.value.reason, dot
        both(case)


# --------------------------------------------------- pagination exactness
class TestServePagination:
    @given(ops_st, st.integers(1, 7))
    @settings(max_examples=20, deadline=None)
    def test_paged_scan_equals_one_shot_under_backpressure(self, ops, page):
        def case(P):
            cluster, service, client, clk = make_service(
                P, config=P.ServiceConfig(byte_budget=600, budget_window=1.0,
                                          lease_ttl=1e9))
            apply_ops(cluster, ops)
            one_shot = cluster.query(P.Scan(S, page_size=10_000), r=3)

            def advance(seconds):
                clk[0] += seconds + 1e-3

            entries, pages = [], []
            for pg in client.pages(P.Scan(S, page_size=page), r=3,
                                   sleep=advance):
                entries.extend(pg.entries)
                pages.append(view(pg))
            assert [e for e, _ in entries] == one_shot.members
            assert {e: frozenset(d) for e, d in entries} == {
                e: frozenset(d) for e, d in one_shot.entries}
            return one_shot, pages, service.rejections, cluster_state(cluster)
        both(case)

    @given(ops_st, st.integers(1, 5))
    @settings(max_examples=10, deadline=None)
    def test_index_pagination_through_service(self, ops, page):
        def case(P):
            cluster, service, client, clk = make_service(P)
            cluster.register_index(S, P.by_element_suffix(1))
            apply_ops(cluster, ops)
            one_shot = cluster.query(P.IndexRange(S, b"element_suffix:1"), r=2)
            got, pages = [], []
            for pg in client.pages(P.IndexRange(S, b"element_suffix:1",
                                                limit=page), r=2):
                assert pg.index_entries is not None
                got.extend(pg.index_entries)
                pages.append(view(pg))
            assert [(ik, el) for ik, el, _ in got] == [
                (ik, el) for ik, el, _ in one_shot.index_entries]
            return one_shot, pages
        both(case)


# ------------------------------------------------------------ write path
class TestWritePath:
    def test_insert_returns_minted_dot(self):
        def case(P):
            cluster, _, client, _ = make_service(P)
            dot = client.insert(S, b"x")
            assert dot == ["vnode0", 1, 1]  # one dot rides as [actor, c, c]
            dot2 = client.insert(S, b"x")
            assert dot2 == ["vnode0", 2, 2]
            return dot, dot2, cluster_state(cluster)
        both(case)

    def test_membership_ctx_round_trips_into_remove(self):
        def case(P):
            cluster, _, client, _ = make_service(P)
            client.batch(S, [["add", b"x"], ["add", b"y"]])
            present, ctx = client.membership(S, b"x", r=3)
            assert present and ctx
            removed = client.remove(S, b"x", ctx=ctx)
            assert removed
            for actor in cluster.actors:
                assert cluster.vnodes[actor].value(S) == {b"y"}
            return present, ctx, removed, cluster_state(cluster)
        both(case)

    def test_stale_ctx_remove_loses_to_concurrent_readd(self):
        def case(P):
            cluster, _, client, _ = make_service(P)
            client.insert(S, b"x")
            _, stale_ctx = client.membership(S, b"x")
            client.insert(S, b"x")  # a concurrent re-add mints a fresh dot
            client.remove(S, b"x", ctx=stale_ctx)
            present, ctx = client.membership(S, b"x")
            assert present  # add-wins: only the observed dot was removed
            assert ctx == [["vnode0", 2, 2]]
            return stale_ctx, present, ctx, cluster_state(cluster)
        both(case)

    def test_legacy_per_dot_ctx_still_decodes(self):
        def case(P):
            cluster, _, client, _ = make_service(P)
            client.insert(S, b"x")
            removed = client.remove(S, b"x", ctx=[["vnode0", 1]])
            assert removed
            for actor in cluster.actors:
                assert cluster.vnodes[actor].value(S) == set()
            return cluster_state(cluster)
        both(case)

    def test_contiguous_ctx_coalesces_on_the_wire(self):
        def case(P):
            cluster, _, client, _ = make_service(P)
            for _ in range(10):
                client.insert(S, b"x")
            _, ctx = client.membership(S, b"x", r=3)
            assert ctx == [["vnode0", 1, 10]]
            assert client.remove(S, b"x", ctx=ctx)
            return ctx, cluster_state(cluster)
        both(case)

    def test_batch_remove_observes_earlier_add(self):
        def case(P):
            cluster, _, client, _ = make_service(P)
            results = client.batch(S, [
                ["add", b"keep"],
                ["add", b"tmp"],
                ["remove", b"tmp"],
                ["remove", b"never-there"],
            ])
            assert "dot" in results[0] and "dot" in results[1]
            assert results[2]["removed"] is True
            assert results[3]["removed"] is False
            assert cluster.value(S, r=3) == {b"keep"}
            return results, cluster_state(cluster)
        both(case)

    def test_values_ride_inserts(self):
        def case(P):
            cluster, _, client, _ = make_service(P)
            client.insert(S, b"doc", value=b"payload")
            vn = cluster.vnodes[cluster.actors[0]]
            values = [v for _, _, v in vn.fold_values(S)]
            assert values == [b"payload"]
            return values, cluster_state(cluster)
        both(case)


# ------------------------------------------------------------ wire errors
class TestWireErrors:
    def test_error_taxonomy(self):
        def case(P):
            _, service, client, _ = make_service(P)
            out = []
            for op, body, kind in (
                    ("explode", {}, "request"),
                    ("query", {"plan": b"garbage"}, "plan"),
                    ("query", {"plan": P.plan_to_wire(P.Scan(S)),
                               "session": b"who?"}, "session"),
                    ("query", {"plan": P.plan_to_wire(P.Scan(S)),
                               "cursor": b"not-a-lease"}, "lease")):
                response = call(P, service, op, body)
                _v, status, out_body = response
                assert status == P.STATUS_ERROR and out_body["error"] == kind
                out.append(response)
            return out
        both(case)

    def test_bad_envelopes(self):
        def case(P):
            _, service, _, _ = make_service(P)
            out = []
            for raw in (b"\xff\xff", msgpack.packb("hi"),
                        msgpack.packb([2, "query", {}]),
                        msgpack.packb([1, 42, {}])):
                response = service.handle(raw)
                _, status, body = msgpack.unpackb(response)
                assert status == P.STATUS_ERROR and body["error"] == "request"
                out.append(response)
            return out
        both(case)

    def test_malformed_scalars_become_error_responses(self):
        def case(P):
            _, service, _, _ = make_service(P, n=3)
            bad = [
                ("insert", {"set": S, "element": b"x", "coordinator": 7}),
                ("insert", {"set": S, "element": b"x", "coordinator": "zzz"}),
                ("insert", {"set": S, "element": b"x", "value": "not-bytes"}),
                ("insert", {"set": S, "element": b"x", "ctx": [["a"]]}),
                ("remove", {"set": S, "element": b"x", "coordinator": -1}),
                ("batch", {"set": S, "ops": [["add", "not-bytes"]]}),
                ("batch", {"set": S, "ops": [["add", b"x", 123]]}),
                ("query", {"plan": P.plan_to_wire(P.Scan(S)), "r": 99}),
                ("query", {"plan": P.plan_to_wire(P.Scan(S)), "r": "two"}),
            ]
            out = []
            for op, body in bad:
                response = call(P, service, op, body)
                _, status, body_out = response
                assert (status == P.STATUS_ERROR
                        and body_out["error"] == "request"), (op, body,
                                                              body_out)
                out.append(response)
            return out
        both(case)

    def test_cursor_on_non_paginating_plan(self):
        def case(P):
            _, service, client, _ = make_service(P)
            client.batch(S, [["add", b"x"], ["add", b"y"]])
            page = client.query(P.Scan(S, page_size=1))
            assert page.cursor is not None
            with pytest.raises(P.PlanError) as err:
                client.query(P.Membership(S, b"x"), cursor=page.cursor)
            return view(page), err.value
        both(case)

    def test_page_size_is_capped(self):
        def case(P):
            _, service, client, _ = make_service(
                P, config=P.ServiceConfig(max_page_size=3))
            client.batch(S, [["add", el] for el in ELEMS])
            page = client.query(P.Scan(S, page_size=10_000))
            assert len(page.entries) == 3 and page.cursor is not None
            return view(page)
        both(case)


# ---------------------------------------------------------- IO acceptance
class TestServeIo:
    def test_scan_page_io_is_o_page_not_o_n(self):
        """Each page of a 100k-element Scan through the service reads
        O(page + causal metadata) bytes on both packages, the same bytes
        page by page."""
        def case(P):
            n = 100_000
            page_size = 256
            cluster = P.BigsetCluster(1)
            vn = P.BigsetVnode(cluster.actors[0],
                               P.LsmStore(memtable_limit=1 << 20))
            cluster.vnodes[cluster.actors[0]] = vn
            for i in range(n):
                vn.coordinate_insert(S, b"%08d" % i)
            vn.store.flush()

            meter = vn.store.meter()
            assert sum(1 for _ in vn.fold(S)) == n
            fold_bytes = meter.delta().bytes_read

            client = P.BigsetClient(P.BigsetService(cluster))
            seen, worst_page, stats = 0, 0, []
            for page in client.pages(P.Scan(S, page_size=page_size), r=1):
                assert len(page.entries) <= page_size
                seen += len(page.entries)
                worst_page = max(worst_page, page.stats["bytes_read"])
                stats.append(page.stats)
            assert seen == n
            assert worst_page * 20 < fold_bytes, (worst_page, fold_bytes)
            assert worst_page < 64 * 1024, worst_page
            return fold_bytes, stats
        both(case)


class TestJoinStrategyOnTheWire:
    def test_per_page_stats_surface_planner_choice(self):
        def case(P):
            cluster = P.BigsetCluster(3)
            for i in range(400):
                cluster.add(T, b"%05d" % i, coordinator=i % 3)
            for i in range(0, 400, 40):
                cluster.add(S, b"%05d" % i, coordinator=i % 3)
            client = P.BigsetClient(P.BigsetService(cluster))
            expected = [b"%05d" % i for i in range(0, 400, 40)]

            auto = client.query(P.Join("intersect", S, T))
            assert auto.stats["strategy"] == "gallop"
            assert auto.members == expected
            forced = client.query(P.Join("intersect", S, T,
                                         strategy="zipper"))
            assert forced.stats["strategy"] == "zipper"
            assert forced.entries == auto.entries
            assert auto.stats["keys_scanned"] < forced.stats["keys_scanned"]
            count = client.query(P.Count(S))
            assert count.stats["strategy"] == ""
            return view(auto), view(forced), view(count)
        both(case)

    def test_lease_cursor_resumes_across_strategies(self):
        def case(P):
            cluster = P.BigsetCluster(3)
            for el in ELEMS:
                cluster.add(S, el, coordinator=0)
                cluster.add(T, el, coordinator=0)
            client = P.BigsetClient(P.BigsetService(cluster))
            first = client.query(P.Join("union", S, T, limit=4,
                                        strategy="zipper"))
            rest = client.query(P.Join("union", S, T, strategy="gallop"),
                                cursor=first.cursor)
            assert first.members + rest.members == sorted(ELEMS)
            return view(first), view(rest)
        both(case)
