"""The reference's query cases (``tests/test_query.py``), held against JAX.

Every case builds the same seeded workload through both packages
(:mod:`torch_sides`), asserts what the reference case asserts on each, and
asserts that both give equal answers: members, dots, cursors, clocks,
``QueryStats`` (bytes read, seeks, keys scanned, batches, kernel launches
and rows) and, where the case has a cluster, its network traffic,
anti-entropy ledger and stores.  The port runs on the CPU.
"""
import pytest
from hypothesis import given, settings, strategies as st

from torch_sides import JAX, PORT, both, cluster_state, plain

S = b"qset"
T = b"qset2"
ELEMS = [b"a", b"b", b"c", b"d", b"e", b"f", b"g", b"h", b"i", b"j"]

ops_st = st.lists(
    st.tuples(
        st.sampled_from(["add", "rem"]),
        st.integers(0, 2),
        st.sampled_from(ELEMS),
    ),
    max_size=24,
)


def apply_ops(cluster, ops, set_name=S):
    for op, coord, el in ops:
        if op == "add":
            cluster.add(set_name, el, coordinator=coord)
        else:
            cluster.remove(set_name, el, coordinator=coord)


def entries_of(orswot):
    return {e: frozenset(ds) for e, ds in orswot.entries.items()}


def result_entries(res):
    return {e: frozenset(ds) for e, ds in res.entries}


# ----------------------------------------------------------------- cursors
class TestCursors:
    def test_roundtrip(self):
        def case(P):
            tok = P.encode_cursor(b"scope", b"elem")
            assert P.decode_cursor(tok, b"scope") == (b"elem", False)
            tok2 = P.encode_cursor(b"scope", b"elem", inclusive=True)
            assert P.decode_cursor(tok2, b"scope") == (b"elem", True)
            return tok, tok2
        both(case)

    def test_scope_mismatch(self):
        def case(P):
            tok = P.encode_cursor(b"scope-a", b"elem")
            with pytest.raises(P.CursorError) as err:
                P.decode_cursor(tok, b"scope-b")
            return tok, err.value
        both(case)

    def test_corruption(self):
        def case(P):
            with pytest.raises(P.CursorError) as e1:
                P.decode_cursor(b"!!not-base64!!", b"s")
            tok = bytearray(P.encode_cursor(b"s", b"elem"))
            tok[4] = (tok[4] + 1) % 128
            with pytest.raises(P.CursorError) as e2:
                P.decode_cursor(bytes(tok), b"s")
            return e1.value, bytes(tok), e2.value
        both(case)

    def test_scope_components_are_delimited(self):
        def case(P):
            cursor_scope = P.mod("query.plan").cursor_scope
            a, b = cursor_scope(P.Range(b"a:b")), cursor_scope(
                P.Range(b"a", start=b"b:"))
            assert a != b
            c, d = cursor_scope(P.Scan(b"s")), cursor_scope(P.Range(b"s"))
            assert c != d
            return a, b, c, d
        both(case)

    def test_plan_validation(self):
        def case(P):
            out = []
            for plan in (P.Join("bogus", S, T),
                         P.Range(S, start=b"z", end=b"a"),
                         P.Scan(S, page_size=0)):
                with pytest.raises(P.PlanError) as err:
                    P.validate(plan)
                out.append(err.value)
            return out
        both(case)


# ---------------------------------------------------------------- executor
class TestExecutor:
    @given(ops_st, st.integers(1, 5))
    @settings(max_examples=40, deadline=None)
    def test_cursor_resumption_equals_one_shot(self, ops, page):
        def case(P):
            c = P.BigsetCluster(3)
            apply_ops(c, ops)
            out = []
            for a in c.actors:
                ex = P.QueryExecutor(c.vnodes[a])
                one_shot = ex.execute(P.Range(S))
                paged, cur, pages = [], None, []
                for _ in range(64):  # bounded: must terminate
                    r = ex.execute(P.Scan(S, page_size=page, cursor=cur))
                    paged.extend(r.entries)
                    pages.append(r)
                    cur = r.cursor
                    if cur is None:
                        break
                assert paged == one_shot.entries
                out.append((one_shot, pages))
            return out, cluster_state(c)
        both(case)

    @given(ops_st, st.integers(0, 2**31 - 1))
    @settings(max_examples=40, deadline=None)
    def test_matches_orswot_truth_under_concurrency(self, ops, seed):
        """Partial, reordered replication: every replica's query results
        equal that replica's materialised ORSWOT, on both packages."""
        def case(P):
            net = P.Network(seed=seed, reorder=True)
            c = P.BigsetCluster(3, net=net, sync=False)
            apply_ops(c, ops)
            for _ in range(net.pending() // 2):  # deliver half the deltas
                net.deliver_one(c._handle)
            out = []
            for a in c.actors:
                vn = c.vnodes[a]
                truth = vn.read_full(S)
                ex = P.QueryExecutor(vn)
                scan = ex.execute(P.Range(S))
                assert result_entries(scan) == entries_of(truth)
                count = ex.execute(P.Count(S))
                assert count.count == len(truth.entries)
                probes = []
                for el in ELEMS[:3]:
                    r = ex.execute(P.Membership(S, el))
                    assert r.present == (el in truth.entries)
                    if r.present:
                        assert frozenset(r.entries[0][1]) == truth.entries[el]
                    probes.append(r)
                out.append((truth, scan, count, probes))
            return out, cluster_state(c)
        both(case)

    @given(ops_st)
    @settings(max_examples=30, deadline=None)
    def test_bounded_range(self, ops):
        def case(P):
            c = P.BigsetCluster(3)
            apply_ops(c, ops)
            vn = c.vnodes[c.actors[0]]
            ex = P.QueryExecutor(vn)
            truth = sorted(vn.value(S))
            r1 = ex.execute(P.Range(S, start=b"c", end=b"g"))
            assert r1.members == [e for e in truth if b"c" <= e < b"g"]
            r2 = ex.execute(P.Range(S, limit=2))
            assert r2.members == truth[:2]
            assert (r2.cursor is not None) == (len(truth) > 2)
            return r1, r2
        both(case)

    def test_limit_zero_cursor_makes_progress(self):
        def case(P):
            vn = P.BigsetVnode("a")
            for el in ELEMS:
                vn.coordinate_insert(S, el)
            ex = P.QueryExecutor(vn)
            r = ex.execute(P.Range(S, limit=0))
            assert r.members == [] and r.cursor is not None
            r2 = ex.execute(P.Range(S, limit=3, cursor=r.cursor))
            assert r2.members == sorted(ELEMS)[:3]
            return r, r2
        both(case)


# ------------------------------------------------------------------- joins
class TestJoins:
    @given(ops_st, ops_st, st.integers(1, 4))
    @settings(max_examples=40, deadline=None)
    def test_join_kinds_match_set_algebra(self, ops_l, ops_r, page):
        def case(P):
            c = P.BigsetCluster(3)
            apply_ops(c, ops_l, S)
            apply_ops(c, ops_r, T)
            vn = c.vnodes[c.actors[0]]
            ex = P.QueryExecutor(vn)
            left, right = vn.value(S), vn.value(T)
            expected = {
                "intersect": left & right,
                "union": left | right,
                "difference": left - right,
            }
            out = []
            for kind, exp in expected.items():
                whole = ex.execute(P.Join(kind, S, T))
                assert whole.members == sorted(exp), kind
                paged, cur, pages = [], None, []
                for _ in range(64):
                    r = ex.execute(P.Join(kind, S, T, limit=page, cursor=cur))
                    paged.extend(r.members)
                    pages.append(r)
                    cur = r.cursor
                    if cur is None:
                        break
                assert paged == sorted(exp), f"paged {kind}"
                out.append((whole, pages))
            return out
        both(case)


# -------------------------------------------------------- batched dot-seen
clock_st = st.lists(st.tuples(st.integers(0, 3), st.integers(1, 200)),
                    max_size=30)
dots_st = st.lists(st.tuples(st.integers(0, 5), st.integers(1, 260)),
                   max_size=60)


def make_clock(P, pairs):
    return P.Clock.zero().add_dots(P.Dot(f"vnode{a}", c) for a, c in pairs)


def make_dots(P, pairs):
    return [P.Dot(f"vnode{a}", c) for a, c in pairs]


class TestBatchVisibility:
    @given(clock_st, dots_st)
    @settings(max_examples=60, deadline=None)
    def test_batched_agrees_with_scalar(self, ts_pairs, dot_pairs):
        def case(P):
            tombstone, dots = make_clock(P, ts_pairs), make_dots(P, dot_pairs)
            vis = P.BatchVisibility(tombstone, min_batch=1)
            batched = list(vis.seen_mask(dots))
            scalar = [tombstone.seen(d) for d in dots]
            assert batched == scalar
            return [bool(b) for b in batched]
        both(case)

    def test_pallas_path_agrees_with_scalar(self):
        """The JAX package's Pallas kernel in interpret mode and the port's
        filter on the CPU, on the same tombstone and dots."""
        def dots(P):
            return ([P.Dot("vnode0", c) for c in range(1, 80)]
                    + [P.Dot("vnode1", c) for c in range(1, 80)]
                    + [P.Dot("stranger", 3)])

        def tombstone(P):
            return P.Clock.zero().add_dots(
                [P.Dot("vnode0", c) for c in range(1, 40)]
                + [P.Dot("vnode1", c) for c in (2, 5, 70)])

        ts = tombstone(JAX)
        want = list(JAX.BatchVisibility(ts, use_pallas=True, interpret=True,
                                        min_batch=1).seen_mask(dots(JAX)))
        assert want == [ts.seen(d) for d in dots(JAX)]
        tts = tombstone(PORT)
        got = list(PORT.BatchVisibility(tts, min_batch=1).seen_mask(dots(PORT)))
        assert got == [tts.seen(d) for d in dots(PORT)]
        assert [bool(b) for b in got] == [bool(b) for b in want]

    def test_executor_batched_path_on_survivor_mix(self):
        """A set big enough to cross the batching threshold, with removes."""
        def case(P):
            vn = P.BigsetVnode("a")
            for i in range(400):
                vn.coordinate_insert(S, b"%05d" % i)
            for i in range(0, 400, 3):
                _, ctx = vn.is_member(S, b"%05d" % i)
                vn.coordinate_remove(S, ctx)
            truth = vn.value(S)
            res = P.QueryExecutor(vn).execute(P.Range(S))
            assert res.members == sorted(truth)
            assert res.stats.batches >= 1
            return res
        res = both(case)
        assert res.stats.kernel_launches > 0


# -------------------------------------------------------------- cluster path
class TestClusterQuery:
    @given(ops_st)
    @settings(max_examples=30, deadline=None)
    def test_quorum_query_equals_quorum_read(self, ops):
        def case(P):
            c = P.BigsetCluster(3)
            apply_ops(c, ops)
            truth = c.read(S, r=3)
            res = c.query(P.Range(S), r=3, repair=False)
            assert result_entries(res) == entries_of(truth)
            count = c.query(P.Count(S), r=3, repair=False)
            assert count.count == len(truth.entries)
            return truth, res, count, cluster_state(c)
        both(case)

    def test_read_repair_replays_missing_deltas(self):
        def case(P):
            c = P.BigsetCluster(3, sync=False)
            for i in range(30):
                c.add(S, b"x%03d" % i, coordinator=0)
            # partition vnode2: it misses every delta
            c.net.queue = [m for m in c.net.queue if m.dst != "vnode2"]
            c.net.deliver_all(c._handle)
            straggler = c.vnodes["vnode2"]
            assert len(straggler.value(S)) == 0
            res = c.query(P.Range(S), r=3)
            c.settle()  # deliver the repair deltas
            assert res.members == sorted(b"x%03d" % i for i in range(30))
            assert len(straggler.value(S)) == 30
            return res, cluster_state(c)
        both(case)

    def test_read_repair_preserves_values(self):
        """Repaired element-keys must carry the stored payload, not b''."""
        def case(P):
            c = P.BigsetCluster(3, sync=False)
            for i in range(8):
                delta = c.vnodes["vnode0"].coordinate_insert(
                    S, b"k%d" % i, value=b"payload-%d" % i)
                c._replicate("vnode0", delta, delta.size_bytes())
            c.net.queue = [m for m in c.net.queue if m.dst != "vnode2"]
            c.net.deliver_all(c._handle)
            res = c.query(P.Range(S), r=3)
            c.settle()
            repaired = {e: v for e, _d, v in c.vnodes["vnode2"].fold_values(S)}
            assert repaired == {b"k%d" % i: b"payload-%d" % i
                                for i in range(8)}
            return res, repaired, cluster_state(c)
        both(case)

    def test_executor_join_snapshots_clock(self):
        def case(P):
            c = P.BigsetCluster(3)
            apply_ops(c, [("add", 0, b"a")], S)
            apply_ops(c, [("add", 1, b"b")], T)
            vn = c.vnodes[c.actors[0]]
            res = P.QueryExecutor(vn).execute(P.Join("union", S, T))
            assert res.clock == vn.read_clock(S).join(vn.read_clock(T))
            return res
        both(case)

    def test_store_seek_bounds_and_limit(self):
        def case(P):
            store = P.LsmStore(memtable_limit=4)
            for i in range(20):
                store.put(b"k%02d" % i, b"v%02d" % i)
            got = list(store.seek(b"k05", b"k15", limit=4))
            assert got == [(b"k%02d" % i, b"v%02d" % i) for i in range(5, 9)]
            tail = [k for k, _ in store.seek(b"k18")]
            assert tail == [b"k18", b"k19"]
            return got, tail, store.stats
        both(case)

    def test_quorum_membership_and_join(self):
        def case(P):
            c = P.BigsetCluster(3)
            for i in range(40):
                c.add(S, b"e%03d" % i, coordinator=i % 3)
                if i % 2 == 0:
                    c.add(T, b"e%03d" % i, coordinator=i % 3)
            hit = c.query(P.Membership(S, b"e001"), r=3)
            assert hit.present and hit.entries[0][0] == b"e001"
            miss = c.query(P.Membership(S, b"zzz"), r=3)
            assert not miss.present
            r = c.query(P.Join("intersect", S, T), r=3)
            assert r.members == sorted(c.value(S, r=3) & c.value(T, r=3))
            return hit, miss, r, cluster_state(c)
        both(case)


# --------------------------------------------------------- IO acceptance
class TestQueryIo:
    def test_range_io_is_o_result_not_o_n(self):
        """Range over a 100k-element bigset reads O(result + causal
        metadata) bytes on both packages, and the same bytes."""
        def case(P):
            n = 100_000
            vn = P.BigsetVnode("a", P.LsmStore(memtable_limit=1 << 20))
            for i in range(n):
                vn.coordinate_insert(S, b"%08d" % i)
            vn.store.flush()  # one sorted run: queries are a bisect + scan
            ex = P.QueryExecutor(vn)

            meter = vn.store.meter()
            full = sum(1 for _ in vn.fold(S))
            fold_bytes = meter.delta().bytes_read
            assert full == n

            res = ex.execute(P.Range(S, start=b"%08d" % (n // 2), limit=100))
            assert len(res.members) == 100
            range_bytes = res.stats.bytes_read
            assert range_bytes * 100 < fold_bytes, (range_bytes, fold_bytes)
            assert range_bytes < 64 * 1024, range_bytes

            probe = ex.execute(P.Membership(S, b"%08d" % 12345))
            assert probe.present
            assert probe.stats.bytes_read < 4 * 1024, probe.stats.bytes_read
            return fold_bytes, res, probe
        both(case)

    def test_cluster_query_io_sublinear(self):
        def case(P):
            card = 4000
            c = P.BigsetCluster(3)
            for i in range(card):
                c.add(S, b"%06d" % i, coordinator=i % 3)
            c.compact_all()
            res = c.query(P.Range(S, start=b"%06d" % 100, limit=20), r=3)
            assert len(res.members) == 20
            assert res.stats.bytes_read < 48 * 1024, res.stats.bytes_read
            return res, cluster_state(c)
        both(case)


def test_sides_are_the_two_packages():
    """The harness itself: each side resolves to its own package, and the
    port's entry points are bound to the CPU."""
    assert JAX.BigsetVnode.__module__ == "repro.core.bigset"
    assert PORT.BigsetVnode.__module__ == "repro_torch.core.bigset"
    assert PORT.BigsetCluster.keywords == {"device": "cpu"}
    assert plain(JAX.Clock.zero().add_dots([JAX.Dot("a", 1)])) == plain(
        PORT.Clock.zero().add_dots([PORT.Dot("a", 1)]))
