"""The reference's secondary-index cases (``tests/test_index.py``), held
against JAX.

Each case runs the same workload through both packages
(:mod:`torch_sides`), asserts what the reference case asserts on each, and
asserts equal answers: index entries, members, dots, cursors,
``QueryStats``, storage write counts and, for clusters, the network
traffic, anti-entropy ledger and stores.  The port runs on the CPU.
"""
import msgpack
import pytest
from hypothesis import given, settings, strategies as st

from torch_sides import both, cluster_state

S = b"iset"
ELEMS = [b"ant", b"bee", b"cat", b"cow", b"dog", b"eel", b"fox", b"gnu"]

ops_st = st.lists(
    st.tuples(
        st.sampled_from(["add", "rem"]),
        st.integers(0, 2),
        st.sampled_from(ELEMS),
    ),
    max_size=24,
)


def head(P):
    """An index on the first element byte: a coarse, collision-rich
    extractor that groups many elements under one index key."""
    return P.IndexSpec(b"head", lambda el, v: (el[:1],))


def apply_ops(cluster, ops, set_name=S):
    for op, coord, el in ops:
        if op == "add":
            cluster.add(set_name, el, coordinator=coord, value=b"v:" + el)
        else:
            cluster.remove(set_name, el, coordinator=coord)


def index_truth(vn, spec, set_name=S):
    """Brute force: (index_key, element) groups with their surviving dots."""
    dots_of = {}
    groups = set()
    for el, dot, v in vn.fold_values(set_name):
        dots_of.setdefault(el, set()).add(dot)
        for ik in spec.keys(el, v):
            groups.add((ik, el))
    return sorted(
        (ik, el, tuple(sorted(dots_of[el]))) for ik, el in groups)


# ------------------------------------------------------------ posting truth
class TestIndexCorrectness:
    @given(ops_st)
    @settings(max_examples=40, deadline=None)
    def test_index_scan_matches_extractor_truth(self, ops):
        def case(P):
            spec = head(P)
            c = P.BigsetCluster(3)
            c.register_index(S, spec)
            apply_ops(c, ops)
            out = []
            for a in c.actors:
                vn = c.vnodes[a]
                res = P.QueryExecutor(vn).execute(P.IndexRange(S, spec.name))
                assert res.index_entries == index_truth(vn, spec)
                out.append(res)
            return out, cluster_state(c)
        both(case)

    @given(ops_st, st.integers(0, 2**31 - 1))
    @settings(max_examples=30, deadline=None)
    def test_under_partial_reordered_replication(self, ops, seed):
        def case(P):
            spec = head(P)
            net = P.Network(seed=seed, reorder=True)
            c = P.BigsetCluster(3, net=net, sync=False)
            c.register_index(S, spec)
            apply_ops(c, ops)
            for _ in range(net.pending() // 2):
                net.deliver_one(c._handle)
            out = []
            for a in c.actors:
                vn = c.vnodes[a]
                res = P.QueryExecutor(vn).execute(P.IndexRange(S, spec.name))
                assert res.index_entries == index_truth(vn, spec)
                out.append(res)
            return out, cluster_state(c)
        both(case)

    @given(ops_st)
    @settings(max_examples=25, deadline=None)
    def test_backfill_equals_write_path(self, ops):
        def case(P):
            spec = head(P)
            before, after = P.BigsetCluster(3), P.BigsetCluster(3)
            before.register_index(S, spec)
            apply_ops(before, ops)
            apply_ops(after, ops)
            after.register_index(S, spec)
            out = []
            for a in before.actors:
                r_b = P.QueryExecutor(before.vnodes[a]).execute(
                    P.IndexRange(S, spec.name))
                r_a = P.QueryExecutor(after.vnodes[a]).execute(
                    P.IndexRange(S, spec.name))
                assert r_b.index_entries == r_a.index_entries
                out.append((r_b.index_entries, r_a.index_entries))
            return out
        both(case)

    def test_reregistration_replaces_extractor_postings(self):
        def case(P):
            vn = P.BigsetVnode("a")
            vn.register_index(S, P.IndexSpec(b"i", lambda el, v: (
                b"OLD-" + el[:1],)))
            vn.coordinate_insert(S, b"ant", value=b"x")
            vn.coordinate_insert(S, b"bee", value=b"y")
            vn.register_index(S, P.IndexSpec(b"i", lambda el, v: (
                b"NEW-" + el[:1],)))
            res = P.QueryExecutor(vn).execute(P.IndexRange(S, b"i"))
            assert [(ik, el) for ik, el, _ in res.index_entries] == [
                (b"NEW-a", b"ant"), (b"NEW-b", b"bee")]
            before = vn.store.stats.snapshot()
            again = vn.register_index(
                S, P.IndexSpec(b"i", lambda el, v: (b"NEW-" + el[:1],)))
            assert again == 0
            assert vn.store.stats.delta(before).bytes_written == 0
            return res, vn.store.stats
        both(case)

    def test_multi_valued_and_field_extractors(self):
        def case(P):
            vn = P.BigsetVnode("a")
            vn.register_index(S, P.IndexSpec(b"tags",
                                             lambda el, v: v.split(b",")))
            vn.register_index(S, P.by_field(b"color"))
            vn.coordinate_insert(S, b"e1", value=b"hot,new")
            vn.coordinate_insert(
                b"docs", b"d1", value=msgpack.packb({b"color": b"red"}))
            vn.register_index(b"docs", P.by_field(b"color"))
            ex = P.QueryExecutor(vn)
            hot = ex.execute(P.IndexLookup(S, b"tags", b"hot"))
            new = ex.execute(P.IndexLookup(S, b"tags", b"new"))
            red = ex.execute(P.IndexLookup(b"docs", b"field:color", b"red"))
            assert hot.members == [b"e1"]
            assert new.members == [b"e1"]
            assert red.members == [b"d1"]
            return hot, new, red
        both(case)

    def test_plan_validation(self):
        def case(P):
            out = []
            for plan in (P.IndexLookup(S, b"", b"k"),
                         P.IndexRange(S, b"i", start=b"z", end=b"a"),
                         P.IndexRange(S, b"i", limit=-1)):
                with pytest.raises(P.PlanError) as err:
                    P.validate(plan)
                out.append(err.value)
            return out
        both(case)


# ----------------------------------------------------- liveness == dot life
class TestPostingLiveness:
    def test_remove_hides_posting_without_index_write(self):
        def case(P):
            spec = head(P)
            c = P.BigsetCluster(3)
            c.register_index(S, spec)
            for el in ELEMS:
                c.add(S, el, value=b"v:" + el)
            vn = c.vnodes["vnode1"]  # not the coordinator
            lo, hi = P.index_range(S, spec.name)

            def postings():
                return [k for k, _ in vn.store.seek(lo, hi)]

            before = postings()
            w_before = vn.store.stats.snapshot()
            c.remove(S, b"cat", coordinator=2)
            w = vn.store.stats.delta(w_before)
            assert postings() == before
            assert w.bytes_written < 300, w.bytes_written
            res = P.QueryExecutor(vn).execute(
                P.IndexLookup(S, spec.name, b"c"))
            assert res.members == [b"cow"]
            vn.compact()
            after = postings()
            assert len(after) == len(before) - 1
            assert vn.store.get(P.element_key(
                S, b"cat", P.Dot("vnode0", 3))) is None
            res2 = P.QueryExecutor(vn).execute(
                P.IndexLookup(S, spec.name, b"c"))
            assert res2.members == [b"cow"]
            return before, w, res, after, res2, cluster_state(c)
        both(case)

    @given(ops_st)
    @settings(max_examples=20, deadline=None)
    def test_compaction_never_changes_results(self, ops):
        def case(P):
            spec = head(P)
            c = P.BigsetCluster(3)
            c.register_index(S, spec)
            apply_ops(c, ops)
            out = []
            for a in c.actors:
                vn = c.vnodes[a]
                ex = P.QueryExecutor(vn)
                pre = ex.execute(P.IndexRange(S, spec.name))
                vn.compact()
                post = ex.execute(P.IndexRange(S, spec.name))
                assert post.index_entries == pre.index_entries
                ts = vn.read_tombstone(S)
                lo, hi = P.index_range(S, spec.name)
                for k, _ in vn.store.seek(lo, hi):
                    *_rest, dot = P.decode_posting_key(k)
                    assert not ts.seen(dot)
                out.append((pre, post))
            return out, cluster_state(c)
        both(case)

    def test_cursor_resumes_across_compaction(self):
        def case(P):
            spec = head(P)
            vn = P.BigsetVnode("a", P.LsmStore(memtable_limit=16))
            vn.register_index(S, spec)
            for i in range(60):
                vn.coordinate_insert(S, b"%c%03d" % (97 + i % 5, i))
            for i in range(0, 60, 4):
                _, ctx = vn.is_member(S, b"%c%03d" % (97 + i % 5, i))
                vn.coordinate_remove(S, ctx)
            ex = P.QueryExecutor(vn)
            one_shot = ex.execute(P.IndexRange(S, spec.name)).index_entries
            paged, cur, pages = [], None, []
            for _ in range(64):
                r = ex.execute(P.IndexRange(S, spec.name, limit=7, cursor=cur))
                paged.extend(r.index_entries)
                pages.append(r)
                cur = r.cursor
                vn.compact()  # compact between every page
                if cur is None:
                    break
            assert paged == one_shot
            return pages
        both(case)

    @given(ops_st, st.integers(1, 5))
    @settings(max_examples=25, deadline=None)
    def test_paged_equals_one_shot(self, ops, page):
        def case(P):
            spec = head(P)
            c = P.BigsetCluster(3)
            c.register_index(S, spec)
            apply_ops(c, ops)
            ex = P.QueryExecutor(c.vnodes["vnode0"])
            one_shot = ex.execute(P.IndexRange(S, spec.name)).index_entries
            paged, cur, pages = [], None, []
            for _ in range(64):
                r = ex.execute(P.IndexRange(S, spec.name, limit=page,
                                            cursor=cur))
                paged.extend(r.index_entries)
                pages.append(r)
                cur = r.cursor
                if cur is None:
                    break
            assert paged == one_shot
            return pages
        both(case)

    def test_limit_zero_cursor_makes_progress(self):
        def case(P):
            spec = head(P)
            vn = P.BigsetVnode("a")
            vn.register_index(S, spec)
            for el in ELEMS:
                vn.coordinate_insert(S, el)
            ex = P.QueryExecutor(vn)
            r = ex.execute(P.IndexRange(S, spec.name, limit=0))
            assert r.entries == [] and r.cursor is not None
            r2 = ex.execute(P.IndexRange(S, spec.name, limit=3,
                                         cursor=r.cursor))
            assert r2.members == sorted(ELEMS)[:3]
            return r, r2
        both(case)


# ------------------------------------------------------------- cluster path
class TestClusterIndexQuery:
    @given(ops_st)
    @settings(max_examples=20, deadline=None)
    def test_quorum_index_equals_local_truth(self, ops):
        def case(P):
            spec = head(P)
            c = P.BigsetCluster(3)
            c.register_index(S, spec)
            apply_ops(c, ops)
            res = c.query(P.IndexRange(S, spec.name), r=3, repair=False)
            assert res.index_entries == index_truth(c.vnodes["vnode0"], spec)
            return res, cluster_state(c)
        both(case)

    def test_read_repair_rebuilds_missing_postings(self):
        def case(P):
            spec = head(P)
            c = P.BigsetCluster(3, sync=False)
            c.register_index(S, spec)
            for i in range(24):
                c.add(S, b"x%03d" % i, coordinator=0, value=b"p%d" % i)
            c.net.queue = [m for m in c.net.queue if m.dst != "vnode2"]
            c.net.deliver_all(c._handle)
            straggler = c.vnodes["vnode2"]
            assert len(straggler.value(S)) == 0
            res = c.query(P.IndexLookup(S, spec.name, b"x"), r=3)
            c.settle()
            assert res.members == [b"x%03d" % i for i in range(24)]
            local = P.QueryExecutor(straggler).execute(
                P.IndexLookup(S, spec.name, b"x"))
            assert local.members == [b"x%03d" % i for i in range(24)]
            assert {v for _e, _d, v in straggler.fold_values(S)} == {
                b"p%d" % i for i in range(24)}
            return res, local, cluster_state(c)
        both(case)

    def test_quorum_keeps_concurrent_dots_across_index_keys(self):
        def case(P):
            c = P.BigsetCluster(3, sync=False)
            c.register_index(S, P.by_value())
            d1 = c.vnodes["vnode0"].coordinate_insert(S, b"el", value=b"v1")
            d2 = c.vnodes["vnode0"].coordinate_insert(S, b"el", value=b"v2")
            c.vnodes["vnode1"].replica_insert(d2)  # vnode1 never sees d1
            res = c.query(P.IndexLookup(S, b"value", b"v1"), r=2,
                          repair=False)
            truth = c.query(P.Range(S), r=2, repair=False)
            assert res.entries == truth.entries
            assert set(res.entries[0][1]) == {d1.dot, d2.dot}
            return res, truth, d1, d2
        both(case)

    def test_antientropy_sync_rebuilds_value_postings(self):
        def case(P):
            a, b = P.BigsetVnode("a"), P.BigsetVnode("b")
            for vn in (a, b):
                vn.register_index(S, P.by_value())
            for i in range(12):
                a.coordinate_insert(S, b"e%02d" % i,
                                    value=b"bucket%d" % (i % 3))
            synced = P.sync(a, b, S)
            got = P.QueryExecutor(b).execute(
                P.IndexLookup(S, b"value", b"bucket1"))
            assert got.members == [b"e%02d" % i for i in range(12)
                                   if i % 3 == 1]
            c = P.BigsetCluster(3)
            c.vnodes["vnode0"], c.vnodes["vnode1"] = a, b
            res = c.query(P.IndexRange(S, b"value"), r=2, repair=False)
            assert res.index_entries == index_truth(a, P.by_value())
            return synced, got, res
        both(case)


# ------------------------------------------------- satellite: redelivery
class TestRedeliveryIdempotence:
    @given(ops_st)
    @settings(max_examples=30, deadline=None)
    def test_redelivered_deltas_are_byte_idempotent(self, ops):
        def case(P):
            a = P.BigsetVnode("a")
            b = P.BigsetVnode("b", P.LsmStore(memtable_limit=1 << 20))
            b.register_index(S, head(P))
            deltas = []
            for op, _c, el in ops:
                if op == "add":
                    deltas.append(a.coordinate_insert(S, el, value=b"v:" + el))
                else:
                    present, ctx = a.is_member(S, el)
                    if present:
                        deltas.append(a.coordinate_remove(S, ctx))
            for d in deltas:
                if isinstance(d, P.InsertDelta):
                    b.replica_insert(d)
                else:
                    b.replica_remove(d)
            before = b.store.stats.snapshot()
            size = b.store.approximate_bytes()
            for d in deltas:
                if isinstance(d, P.InsertDelta):
                    assert b.replica_insert(d) is False
                else:
                    b.replica_remove(d)
            delta = b.store.stats.delta(before)
            assert delta.bytes_written == 0, delta
            assert delta.num_writes == 0, delta
            assert b.store.approximate_bytes() == size
            return deltas, delta, size
        both(case)

    def test_fresh_ctx_still_writes(self):
        def case(P):
            a, b = P.BigsetVnode("a"), P.BigsetVnode("b")
            d1 = a.coordinate_insert(S, b"x")
            _, ctx = a.is_member(S, b"x")
            d2 = a.coordinate_insert(S, b"x", ctx=ctx)  # replace
            b.replica_insert(d2)  # the replace arrives first
            assert b.replica_insert(d1) is False
            assert b.value(S) == {b"x"}
            folded = list(b.fold(S))
            assert len(folded) == 1
            return d1, d2, folded
        both(case)


# ----------------------------------------- satellite: stats + decode errors
class TestStatsAndDecode:
    def test_count_reports_emitted(self):
        def case(P):
            c = P.BigsetCluster(3)
            for el in ELEMS:
                c.add(S, el)
            ex = P.QueryExecutor(c.vnodes["vnode0"])
            r = ex.execute(P.Count(S))
            assert r.count == len(ELEMS)
            assert r.stats.elements_emitted == len(ELEMS)
            rc = c.query(P.Count(S), r=3)
            assert rc.stats.elements_emitted == len(ELEMS)
            return r, rc
        both(case)

    def test_membership_miss_records_probe(self):
        def case(P):
            c = P.BigsetCluster(3)
            c.add(S, b"ant")
            ex = P.QueryExecutor(c.vnodes["vnode0"])
            hit = ex.execute(P.Membership(S, b"ant"))
            miss = ex.execute(P.Membership(S, b"zzz"))
            assert hit.stats.keys_probed == 1
            assert miss.stats.keys_probed == 1
            quorum = c.query(P.Membership(S, b"zzz"), r=3)
            assert quorum.stats.keys_probed == 3
            return hit, miss, quorum
        both(case)

    def test_decode_element_key_rejects_other_kinds(self):
        def case(P):
            spec = head(P)
            vn = P.BigsetVnode("a")
            vn.register_index(S, spec)
            vn.coordinate_insert(S, b"ant")
            errors = []
            for fn, key in (
                    (P.decode_element_key, P.clock_key(S)),
                    (P.decode_element_key, P.posting_key(
                        S, spec.name, b"a", b"ant", P.Dot("a", 1))),
                    (P.decode_posting_key, P.element_key(
                        S, b"ant", P.Dot("a", 1)))):
                with pytest.raises(ValueError) as err:
                    fn(key)
                errors.append((key, err.value))
            k = P.element_key(S, b"ant", P.Dot("a", 1))
            assert P.decode_element_key(k) == (S, b"ant", P.Dot("a", 1))
            return errors, k
        both(case)


# ------------------------------------------------------------ IO acceptance
class TestIndexIo:
    def test_index_scan_io_is_o_matches_not_o_n(self):
        def case(P):
            n = 100_000
            vn = P.BigsetVnode("a", P.LsmStore(memtable_limit=1 << 20))
            vn.register_index(S, P.by_element_suffix(3))
            for i in range(n):
                vn.coordinate_insert(S, b"%08d" % i)
            vn.store.flush()
            ex = P.QueryExecutor(vn)

            meter = vn.store.meter()
            assert sum(1 for _ in vn.fold(S)) == n
            fold_bytes = meter.delta().bytes_read

            res = ex.execute(P.IndexLookup(S, b"element_suffix:3", b"042"))
            assert len(res.members) == 100
            assert res.members == [b"%05d042" % i for i in range(100)]
            assert res.stats.bytes_read * 20 < fold_bytes, (
                res.stats.bytes_read, fold_bytes)
            assert res.stats.bytes_read < 64 * 1024, res.stats.bytes_read

            rng = ex.execute(P.IndexRange(S, b"element_suffix:3",
                                          start=b"042", end=b"044"))
            assert len(rng.members) == 200
            assert rng.stats.bytes_read < 128 * 1024, rng.stats.bytes_read
            return fold_bytes, res, rng
        both(case)

    def test_cluster_index_io_sublinear(self):
        def case(P):
            card = 3000
            c = P.BigsetCluster(3)
            c.register_index(S, P.by_element_suffix(2))
            for i in range(card):
                c.add(S, b"%06d" % i, coordinator=i % 3)
            c.compact_all()
            res = c.query(P.IndexLookup(S, b"element_suffix:2", b"42"), r=3)
            assert len(res.members) == 30
            assert res.stats.bytes_read < 96 * 1024, res.stats.bytes_read
            return res, cluster_state(c)
        both(case)
