"""The reference's join-planner cases (``tests/test_planner.py``), held
against JAX.

Each case runs the same workload through both packages
(:mod:`torch_sides`), asserts what the reference case asserts on each, and
asserts equal answers: the chooser's verdicts, entries, cursors and
``QueryStats`` (strategy, keys scanned, bytes read) page by page.  The
port runs on the CPU.
"""
import pytest
from hypothesis import given, settings, strategies as st

from torch_sides import JAX, PORT, both, cluster_state

S = b"plsmall"
B = b"plbig"
ELEMS = [b"a", b"b", b"c", b"d", b"e", b"f", b"g", b"h", b"i", b"j"]
KINDS = ("intersect", "union", "difference")
STRATEGIES = (None, "zipper", "gallop")

ops_st = st.lists(
    st.tuples(
        st.sampled_from(["add", "rem"]),
        st.integers(0, 2),
        st.sampled_from(ELEMS),
    ),
    max_size=20,
)


def apply_ops(cluster, ops, set_name):
    for op, coord, el in ops:
        if op == "add":
            cluster.add(set_name, el, coordinator=coord)
        else:
            cluster.remove(set_name, el, coordinator=coord)


def skew(P):
    return P.SideStats(10, 300), P.SideStats(100_000, 3_000_000)


# ------------------------------------------------------------------ chooser
class TestChooser:
    def test_balanced_sides_zipper(self):
        def case(P):
            c = P.choose_join("intersect", P.SideStats(100, 3000),
                              P.SideStats(100, 3000))
            assert c.strategy == P.ZIPPER
            return c
        both(case)

    def test_skewed_intersect_gallops_either_direction(self):
        def case(P):
            small, big = skew(P)
            left_small = P.choose_join("intersect", small, big)
            assert left_small.strategy == P.GALLOP
            assert left_small.drive == "left"
            right_small = P.choose_join("intersect", big, small)
            assert right_small.strategy == P.GALLOP
            assert right_small.drive == "right"
            return left_small, right_small
        both(case)

    def test_difference_only_drives_left(self):
        def case(P):
            small, big = skew(P)
            c = P.choose_join("difference", small, big)
            assert c.strategy == P.GALLOP and c.drive == "left"
            rev = P.choose_join("difference", big, small)
            assert rev.strategy == P.ZIPPER
            return c, rev
        both(case)

    def test_union_never_gallops(self):
        def case(P):
            small, big = skew(P)
            gallop_drive = P.mod("query.planner").gallop_drive
            assert gallop_drive("union", small, big) is None
            auto = P.choose_join("union", small, big)
            assert auto.strategy == P.ZIPPER
            forced = P.choose_join("union", small, big, forced=P.GALLOP)
            assert forced.strategy == P.ZIPPER
            return auto, forced
        both(case)

    def test_forced_strategy_honored(self):
        def case(P):
            small, big = skew(P)
            z = P.choose_join("intersect", small, big, forced=P.ZIPPER)
            assert z.strategy == P.ZIPPER
            g = P.choose_join("intersect", P.SideStats(5, 100),
                              P.SideStats(5, 100), forced=P.GALLOP)
            assert g.strategy == P.GALLOP
            return z, g
        both(case)

    def test_empty_sides(self):
        def case(P):
            c = P.choose_join("intersect", P.SideStats(0, 0),
                              P.SideStats(0, 0))
            assert c.strategy == P.ZIPPER
            return c
        both(case)

    def test_strategy_validation_and_wire(self):
        def case(P):
            with pytest.raises(P.PlanError) as err:
                P.validate(P.Join("intersect", S, B, strategy="bogus"))
            plan = P.Join("intersect", S, B, limit=3, strategy="gallop")
            wire = P.plan_to_wire(plan)
            assert P.plan_from_wire(wire) == plan
            old = P.plan_to_wire(P.Join("union", S, B))
            assert P.plan_from_wire(old).strategy is None
            return err.value, wire, old
        both(case)

    def test_side_stats_reads_run_statistics(self):
        def case(P):
            vn = P.BigsetVnode("a", P.LsmStore(memtable_limit=1 << 20))
            for i in range(50):
                vn.coordinate_insert(S, b"%04d" % i)
            mem = P.side_stats(vn.store, S)
            assert mem.keys == 50 and mem.bytes > 0
            vn.store.flush()
            flushed = P.side_stats(vn.store, S)
            assert flushed.keys == 50
            none = P.side_stats(vn.store, b"no-such-set")
            assert none.keys == 0
            return mem, flushed, none
        both(case)


# ------------------------------------------------------- strategy equivalence
class TestEquivalence:
    @given(ops_st, ops_st)
    @settings(max_examples=25, deadline=None)
    def test_gallop_equals_zipper_all_kinds(self, ops_l, ops_r):
        def case(P):
            c = P.BigsetCluster(3)
            apply_ops(c, ops_l, S)
            apply_ops(c, ops_r, B)
            for i in range(40):
                c.add(B, b"z%03d" % i, coordinator=i % 3)
            vn = c.vnodes[c.actors[0]]
            ex = P.QueryExecutor(vn)
            left, right = vn.value(S), vn.value(B)
            expected = {
                "intersect": left & right,
                "union": left | right,
                "difference": left - right,
            }
            out = []
            for kind in KINDS:
                results = [ex.execute(P.Join(kind, S, B, strategy=strat))
                           for strat in STRATEGIES]
                for res in results:
                    assert res.members == sorted(expected[kind]), kind
                    assert res.entries == results[0].entries, kind
                out.append(results)
            return out
        both(case)

    @given(ops_st, ops_st, st.integers(1, 4))
    @settings(max_examples=25, deadline=None)
    def test_cursor_cuts_reassemble_single_domain(self, ops_l, ops_r, page):
        def case(P):
            c = P.BigsetCluster(3)
            apply_ops(c, ops_l, S)
            apply_ops(c, ops_r, B)
            for i in range(12):
                c.add(B, b"y%02d" % i, coordinator=i % 3)
            vn = c.vnodes[c.actors[0]]
            ex = P.QueryExecutor(vn)
            left_truth = vn.read_full(S).entries
            right_truth = vn.read_full(B).entries
            out = []
            for kind in KINDS:
                uncut = ex.execute(P.Join(kind, S, B)).entries
                for strat in STRATEGIES:
                    paged, cur, pages = [], None, []
                    for _ in range(64):
                        r = ex.execute(P.Join(kind, S, B, limit=page,
                                              cursor=cur, strategy=strat))
                        paged.extend(r.entries)
                        pages.append(r)
                        cur = r.cursor
                        if cur is None:
                            break
                    assert paged == uncut, (kind, strat)
                    out.append(pages)
                for el, dots in uncut:
                    domain = left_truth.get(el) or right_truth.get(el)
                    assert frozenset(dots) == domain, (kind, el)
            return out
        both(case)

    def test_cursor_minted_under_one_strategy_resumes_under_other(self):
        def case(P):
            c = P.BigsetCluster(1)
            for i in range(8):
                c.add(S, b"s%02d" % i, coordinator=0)
                c.add(B, b"s%02d" % i, coordinator=0)
            ex = P.QueryExecutor(c.vnodes[c.actors[0]])
            first = ex.execute(P.Join("intersect", S, B, limit=3,
                                      strategy="zipper"))
            rest = ex.execute(P.Join("intersect", S, B, limit=99,
                                     cursor=first.cursor, strategy="gallop"))
            assert first.members + rest.members == [b"s%02d" % i
                                                    for i in range(8)]
            return first, rest
        both(case)


# --------------------------------------------------------------- acceptance
def _skewed_vnode(P):
    """100-element set vs 100k-element superset, flushed to one run."""
    n = 100_000
    vn = P.BigsetVnode("a", P.LsmStore(memtable_limit=1 << 20))
    for i in range(n):
        vn.coordinate_insert(B, b"%08d" % i)
    for i in range(0, n, 1000):  # 100 elements, all in B
        vn.coordinate_insert(S, b"%08d" % i)
    vn.store.flush()
    return vn


@pytest.fixture(scope="module")
def skewed_vnodes():
    return {side: _skewed_vnode(side) for side in (JAX, PORT)}


class TestAcceptance:
    def test_planner_gallop_intersect_bounded_io(self, skewed_vnodes):
        def case(P, vn):
            ex = P.QueryExecutor(vn)
            res = ex.execute(P.Join("intersect", S, B))
            assert res.stats.strategy == "gallop"
            assert res.members == [b"%08d" % i for i in range(0, 100_000, 1000)]
            assert res.stats.keys_scanned <= 4 * 100, res.stats.keys_scanned
            rev = ex.execute(P.Join("intersect", B, S))
            assert rev.stats.strategy == "gallop"
            assert rev.stats.keys_scanned <= 4 * 100, rev.stats.keys_scanned
            assert rev.members == res.members
            return res, rev
        both(lambda P: case(P, skewed_vnodes[P]))

    def test_all_kinds_identical_at_scale(self, skewed_vnodes):
        def case(P, vn):
            ex = P.QueryExecutor(vn)
            out = []
            for kind in KINDS:
                z = ex.execute(P.Join(kind, S, B, strategy="zipper", limit=500))
                g = ex.execute(P.Join(kind, S, B, strategy="gallop", limit=500))
                assert z.entries == g.entries, kind
                out.append((z, g))
            return out
        both(lambda P: case(P, skewed_vnodes[P]))

    def test_zipper_seek_reflects_skip(self, skewed_vnodes):
        def case(P, vn):
            ex = P.QueryExecutor(vn)
            res = ex.execute(P.Join("intersect", S, B, strategy="zipper"))
            assert res.members == [b"%08d" % i for i in range(0, 100_000, 1000)]
            assert res.stats.keys_scanned < 100_000 // 20, (
                res.stats.keys_scanned)
            return res
        both(lambda P: case(P, skewed_vnodes[P]))

    def test_gallop_difference_bounded_io(self, skewed_vnodes):
        def case(P, vn):
            ex = P.QueryExecutor(vn)
            res = ex.execute(P.Join("difference", S, B))
            assert res.stats.strategy == "gallop"
            assert res.members == []  # S is a subset of B
            assert res.stats.keys_scanned <= 4 * 100, res.stats.keys_scanned
            return res
        both(lambda P: case(P, skewed_vnodes[P]))


# ------------------------------------------------------------- quorum gallop
class TestQuorumGallop:
    @staticmethod
    def build(P, sync=True):
        c = P.BigsetCluster(3, sync=sync)
        for i in range(2000):
            c.add(B, b"%06d" % i, coordinator=i % 3)
        for i in range(0, 2000, 100):
            c.add(S, b"%06d" % i, coordinator=i % 3)
        return c

    def test_quorum_strategy_and_equivalence(self):
        def case(P):
            c = self.build(P)
            out = []
            for kind in KINDS:
                auto = c.query(P.Join(kind, S, B), r=3, repair=False)
                z = c.query(P.Join(kind, S, B, strategy="zipper"), r=3,
                            repair=False)
                assert auto.entries == z.entries, kind
                if kind == "union":
                    assert auto.stats.strategy == "zipper"
                else:
                    assert auto.stats.strategy == "gallop"
                out.append((auto, z))
            skewed = c.query(P.Join("intersect", S, B), r=3, repair=False)
            full = c.query(P.Join("intersect", S, B, strategy="zipper"), r=3,
                           repair=False)
            assert skewed.stats.keys_scanned < full.stats.keys_scanned
            return out, skewed, full, cluster_state(c)
        both(case)

    def test_gallop_probe_read_repairs(self):
        """A replica missing big-side deltas gets the probed element-keys
        replayed: repair rides the gallop workload, on both packages."""
        def case(P):
            c = P.BigsetCluster(3, sync=False)
            for i in range(200):
                c.add(B, b"%06d" % i, coordinator=0)
            for i in range(0, 200, 40):
                c.add(S, b"%06d" % i, coordinator=0)
            c.net.queue = [m for m in c.net.queue if m.dst != "vnode2"]
            c.net.deliver_all(c._handle)
            straggler = c.vnodes["vnode2"]
            assert len(straggler.value(B)) == 0
            res = c.query(P.Join("intersect", S, B), r=3)
            c.settle()
            expected = [b"%06d" % i for i in range(0, 200, 40)]
            assert res.stats.strategy == "gallop"
            assert res.members == expected
            assert sorted(straggler.value(S)) == expected
            assert sorted(straggler.value(B)) == expected
            return res, cluster_state(c)
        both(case)
