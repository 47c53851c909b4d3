"""The reference's anti-entropy cases (``tests/test_antientropy.py``),
held against JAX.

Each case runs the same seeded workload through both packages
(:mod:`torch_sides`) — pairwise syncs, handoff, scheduled ticks under
drop, dup and reorder — asserts what the reference case asserts on each,
and asserts that both give equal replica values, sync replies,
``AntiEntropyStats``, ``Network`` traffic and stores.  The port runs on
the CPU.
"""
import pytest
from hypothesis import given, settings, strategies as st

from torch_sides import both, cluster_state, store_digest

S = b"s"
ELEMS = [b"a1", b"b2", b"c3", b"d4"]

op_st = st.tuples(
    st.sampled_from(["add", "rem"]), st.integers(0, 2), st.sampled_from(ELEMS)
)
ops_st = st.lists(op_st, max_size=20)


def run_ops(big, ops):
    for kind, coord, elem in ops:
        if kind == "add":
            _, ctx = big.vnodes[big.actors[coord]].is_member(S, elem)
            big.add(S, elem, coord, ctx)
        else:
            big.remove(S, elem, coord)


def ring_gossip(sync_fn, vns, rounds=2):
    """Rounds of ring gossip over three vnodes; every reply, in order."""
    replies = []
    for _ in range(rounds):
        replies.append(sync_fn(vns[0], vns[1], S))
        replies.append(sync_fn(vns[1], vns[2], S))
        replies.append(sync_fn(vns[2], vns[0], S))
    return replies


def vnode_state(vn):
    return vn.value(S), vn.read_clock(S), store_digest(vn.store)


class TestSync:
    def test_basic_bidirectional(self):
        def case(P):
            a, b = P.BigsetVnode("a"), P.BigsetVnode("b")
            a.coordinate_insert(S, b"x")
            b.coordinate_insert(S, b"y")
            reply = P.sync(a, b, S)
            assert a.value(S) == b.value(S) == {b"x", b"y"}
            return reply, vnode_state(a), vnode_state(b)
        both(case)

    def test_removal_propagates_after_compaction(self):
        def case(P):
            a, b = P.BigsetVnode("a"), P.BigsetVnode("b")
            d = a.coordinate_insert(S, b"x")
            b.replica_insert(d)
            _, ctx = a.is_member(S, b"x")
            a.coordinate_remove(S, ctx)
            a.compact()
            assert a.read_tombstone(S).is_zero()
            reply = P.sync(b, a, S)
            assert b.value(S) == set()
            return reply, vnode_state(a), vnode_state(b)
        both(case)

    def test_no_resurrection(self):
        def case(P):
            a, b = P.BigsetVnode("a"), P.BigsetVnode("b")
            d = a.coordinate_insert(S, b"x")
            b.replica_insert(d)
            _, ctx = a.is_member(S, b"x")
            a.coordinate_remove(S, ctx)
            a.compact()
            reply = P.sync(a, b, S)  # stale b syncs with a
            assert a.value(S) == set() and b.value(S) == set()
            return reply, vnode_state(a), vnode_state(b)
        both(case)

    def test_concurrent_adds_both_survive(self):
        def case(P):
            a, b = P.BigsetVnode("a"), P.BigsetVnode("b")
            a.coordinate_insert(S, b"x")
            b.coordinate_insert(S, b"x")
            reply = P.sync(a, b, S)
            assert a.value(S) == b.value(S) == {b"x"}
            folded = list(a.fold(S))
            assert len(folded) == 2
            return reply, folded, vnode_state(a), vnode_state(b)
        both(case)

    @given(ops_st)
    @settings(max_examples=40, deadline=None)
    def test_pairwise_sync_converges(self, ops):
        def case(P):
            big = P.BigsetCluster(3, sync=False)  # ops never replicated
            run_ops(big, ops)
            big.net.queue.clear()  # drop ALL replication traffic
            vns = list(big.vnodes.values())
            replies = ring_gossip(P.sync, vns)
            vals = [vn.value(S) for vn in vns]
            assert vals[0] == vals[1] == vals[2]
            return replies, [vnode_state(vn) for vn in vns]
        both(case)

    @given(ops_st, st.integers(0, 2**32 - 1))
    @settings(max_examples=30, deadline=None)
    def test_converges_under_drop_dup_reorder(self, ops, seed):
        def case(P):
            net = P.Network(seed=seed, drop_prob=0.3, dup_prob=0.3,
                            reorder=True)
            big = P.BigsetCluster(3, net=net, sync=False)
            run_ops(big, ops)
            big.settle()  # deliver what survived (reordered, duplicated)
            vns = list(big.vnodes.values())
            replies = ring_gossip(P.sync, vns)
            assert vns[0].value(S) == vns[1].value(S) == vns[2].value(S)
            return replies, cluster_state(big)
        both(case)


class TestHandoff:
    def test_handoff_to_empty_vnode(self):
        def case(P):
            a = P.BigsetVnode("a")
            for e in ELEMS:
                a.coordinate_insert(S, e)
            _, ctx = a.is_member(S, ELEMS[0])
            a.coordinate_remove(S, ctx)
            fresh = P.BigsetVnode("z")
            moved = P.handoff(a, fresh, S)
            assert fresh.value(S) == a.value(S) == set(ELEMS[1:])
            return moved, vnode_state(fresh)
        both(case)

    def test_handoff_idempotent(self):
        def case(P):
            a = P.BigsetVnode("a")
            a.coordinate_insert(S, b"x")
            fresh = P.BigsetVnode("z")
            assert P.handoff(a, fresh, S) == 1
            assert P.handoff(a, fresh, S) == 0  # second transfer: no writes
            assert fresh.value(S) == {b"x"}
            return vnode_state(fresh), fresh.store.stats
        both(case)


class TestTombstoneHygiene:
    def test_trim_unbacked_tombstone_dots(self):
        def case(P):
            a, b = P.BigsetVnode("a"), P.BigsetVnode("b")
            d = a.coordinate_insert(S, b"x")
            b.replica_insert(d)
            _, ctx = b.is_member(S, b"x")
            b.coordinate_remove(S, ctx)
            b.compact()
            assert b.read_tombstone(S).is_zero()
            trimmed = P.trim_tombstone(b, S)
            assert b.read_tombstone(S).is_zero()
            return trimmed, vnode_state(b)
        both(case)

    def test_survivors_digest_compresses(self):
        def case(P):
            vn = P.BigsetVnode("a")
            for i in range(100):
                vn.coordinate_insert(S, b"e%03d" % i)
            dig = P.survivors_digest(vn, S)
            assert dig.base == {"a": 100} and not dig.cloud
            return dig
        both(case)


def pair(P, n=400, bucket_limit=64):
    a = P.BigsetVnode("a", digest_bucket_limit=bucket_limit)
    b = P.BigsetVnode("b", digest_bucket_limit=bucket_limit)
    for i in range(n):
        b.replica_insert(a.coordinate_insert(S, b"e%05d" % i))
    return a, b


class TestDigestSync:
    """The digest ladder: skip-when-converged at O(causal metadata), fold
    only diverged subranges otherwise, same convergence as the full fold."""

    def test_converged_round_zero_element_folds(self):
        def case(P):
            a, b = pair(P)
            warm = P.sync(a, b, S)
            seeks = (a.store.stats.num_seeks, b.store.stats.num_seeks)
            r1 = P.sync_pull(a, b, S)
            r2 = P.sync_pull(b, a, S)
            assert r1.skipped and r2.skipped
            assert r1.keys_scanned == 0 == r2.keys_scanned
            assert (a.store.stats.num_seeks, b.store.stats.num_seeks) == seeks
            return warm, r1, r2, seeks
        both(case)

    def test_diverged_sync_scans_only_diverged_subranges(self):
        def case(P):
            a, b = pair(P, n=2000, bucket_limit=64)
            k = 20
            for i in range(k):
                a.coordinate_insert(S, b"zz%04d" % i)
            reply = P.build_digest_reply(
                a, S, b.read_clock(S), P.survivors_digest(b, S))
            assert len(reply.missing) == k
            assert reply.keys_scanned < 2000 // 4
            synced = P.sync(a, b, S)
            assert a.value(S) == b.value(S)
            after = P.sync_pull(b, a, S)
            assert after.skipped
            return reply, synced, after, vnode_state(b)
        both(case)

    def test_sync_converges_removals_without_resurrect(self):
        def case(P):
            a, b = pair(P, n=50)
            _, ctx = a.is_member(S, b"e00007")
            a.coordinate_remove(S, ctx)
            a.compact()
            reply = P.sync(a, b, S)
            assert a.value(S) == b.value(S)
            assert b"e00007" not in b.value(S)
            return reply, vnode_state(a), vnode_state(b)
        both(case)

    @given(ops_st)
    @settings(max_examples=25, deadline=None)
    def test_digest_sync_equals_full_sync(self, ops):
        def case(P):
            def converge(sync_fn):
                big = P.BigsetCluster(3, sync=False)
                run_ops(big, ops)
                big.net.queue.clear()
                vns = list(big.vnodes.values())
                replies = ring_gossip(sync_fn, vns)
                return [vn.value(S) for vn in vns], replies
            digest_vals, digest_replies = converge(P.sync)
            full_vals, full_replies = converge(P.full_sync)
            assert digest_vals == full_vals
            assert digest_vals[0] == digest_vals[1] == digest_vals[2]
            return digest_vals, digest_replies, full_replies
        both(case)


class TestScheduledAntiEntropy:
    def test_non_quorum_replica_converges_via_ticks(self):
        def case(P):
            big = P.BigsetCluster(3, sync=False)
            for e in ELEMS:
                big.add(S, e)
            big.remove(S, ELEMS[0])
            big.net.queue.clear()          # replicas 1, 2 saw nothing
            res = big.query(P.Range(S, None, None), r=2)  # read repair
            big.settle()
            assert big.ae_stats().repair_hits > 0
            assert big.vnodes["vnode2"].value(S) == frozenset()
            for _ in range(4):
                big.tick()
                big.settle()
            expect = set(ELEMS[1:])
            assert all(vn.value(S) == expect for vn in big.vnodes.values())
            assert big.ae_stats().keys_shipped >= len(expect)
            return res, cluster_state(big)
        both(case)

    def test_repair_hits_feed_and_decay(self):
        def case(P):
            big = P.BigsetCluster(3, sync=False)
            big.add(S, b"x")
            big.net.queue.clear()
            big.query(P.Range(S, None, None), r=2)
            big.settle()
            hot = big.scheduler.hot_pairs()
            assert hot and hot[0][0] == S and hot[0][1] == ("vnode0",
                                                            "vnode1")
            first = big.scheduler.next_rounds(budget=1)
            assert first == [(S, "vnode0", "vnode1")]
            for _ in range(8):  # quiescent: no new hits, scores cool off
                big.scheduler.next_rounds(budget=0)
            assert not big.scheduler.hot_pairs()
            return hot, first, cluster_state(big)
        both(case)

    def test_converged_cluster_ticks_are_digest_only(self):
        def case(P):
            big = P.BigsetCluster(3)
            for e in ELEMS:
                big.add(S, e)
            big.tick()
            before = [big.vnodes[a].store.stats.num_seeks for a in big.actors]
            big.tick(budget=3)
            s = big.ae_stats()
            assert s.rounds_skipped > 0
            assert [big.vnodes[a].store.stats.num_seeks
                    for a in big.actors] == before
            assert s.keys_scanned == 0
            return before, cluster_state(big)
        both(case)

    @given(ops_st, st.integers(0, 2**32 - 1))
    @settings(max_examples=25, deadline=None)
    def test_ticks_converge_under_drop_dup_reorder(self, ops, seed):
        def case(P):
            net = P.Network(seed=seed, drop_prob=0.25, dup_prob=0.25,
                            reorder=True)
            big = P.BigsetCluster(3, net=net, sync=False)
            run_ops(big, ops)
            big.settle()
            for _ in range(14):
                big.tick(budget=3)
                big.settle()
            vns = list(big.vnodes.values())
            assert vns[0].value(S) == vns[1].value(S) == vns[2].value(S)
            return cluster_state(big)
        both(case)


class TestSyncPathBugfixes:
    def test_deliver_all_raises_on_budget_with_leftovers(self):
        def case(P):
            net = P.Network()
            for i in range(5):
                net.send("a", "b", i, 8)
            with pytest.raises(P.DeliveryBudget) as err:
                net.deliver_all(lambda m: None, max_steps=3)
            assert net.pending() == 2  # leftovers stay queued
            return err.value, net.pending(), net.bytes_sent
        both(case)

    def test_repair_skips_dot_without_donor_payload(self):
        def case(P):
            big = P.BigsetCluster(3, sync=False)
            d = big.add(S, b"x", value=b"payload")
            big.net.queue.clear()
            # the donor's key vanishes between stream and repair
            big.vnodes["vnode0"].store.delete(P.element_key(S, b"x", d.dot))
            clocks = [big.vnodes[a].read_clock(S) for a in big.actors]
            per_stream = [frozenset([d.dot]), None, None]
            big._repair(S, b"x", [d.dot], per_stream, clocks, big.actors)
            assert big.net.pending() == 0          # nothing fabricated
            assert big.ae_stats().repair_no_donor == 1
            return cluster_state(big)
        both(case)

    def test_apply_reply_skips_trim_when_tombstone_unchanged(self):
        def case(P):
            a, b = P.BigsetVnode("a"), P.BigsetVnode("b")
            b.replica_insert(a.coordinate_insert(S, b"x"))
            calls = []
            orig_put = b.store.put

            def counting_put(key, value):
                calls.append(key)
                return orig_put(key, value)

            b.store.put = counting_put
            reply = P.full_sync(a, b, S)  # converged: tombstones untouched
            assert calls == []
            return reply, vnode_state(b)
        both(case)
