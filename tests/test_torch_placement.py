"""The reference's placement cases (``tests/test_placement.py``), held
against JAX.

Each case runs the same seeded workload — drop, dup and reorder on the
simulated network, ring changes, crashes and restarts — through both
packages' clusters (:mod:`torch_sides`), asserts what the reference case
asserts on each, and asserts that both give equal query results,
``Network`` traffic (``bytes_sent`` and message counts),
``AntiEntropyStats``, ``ring_state()``, ring deltas and stores.  The port
runs on the CPU.

The heal case (ROADMAP C6) delivers what its ticks sent (``settle()``),
then ticks whole sweeps until every partition's owners agree, on both
clusters: forty one-round ticks cannot visit every (partition, pair)
round of a partitioned ring, let alone retry the ones the network drops.
"""
import pytest
from hypothesis import given, settings, strategies as st

from torch_sides import both, cluster_state

S = b"users"
ACTORS8 = [f"v{i}" for i in range(8)]


def elems(n, prefix=b"el"):
    return [prefix + b"%05d" % i for i in range(n)]


def sweep_budget(c):
    """Rounds in one sweep over every (partition, owner pair)."""
    f = c.ring.factor
    return c.ring.n_partitions * f * (f - 1) // 2


def owners_agree(c, set_name):
    """Every partition's owners hold the same elements and set clock."""
    for pid in c.ring.partitions():
        pset = c.ring.storage_set(set_name, pid)
        seen = {(frozenset(c.vnodes[a].value(pset)),
                 c.vnodes[a].read_clock(pset).iter_runs())
                for a in c.ring.owners(pid)}
        if len(seen) > 1:
            return False
    return True


def heal(c, set_name, cap=100):
    """Whole anti-entropy sweeps, each delivered, until the owners agree;
    returns the sweeps it took."""
    for sweeps in range(cap):
        if owners_agree(c, set_name):
            return sweeps
        c.tick(budget=sweep_budget(c))
        c.settle()
    raise AssertionError(f"owners still disagree after {cap} sweeps")


# --------------------------------------------------------------- ring units
class TestRing:
    def test_placement_is_deterministic(self):
        def case(P):
            r1 = P.Ring.build(ACTORS8, factor=3, seed=7)
            r2 = P.Ring.build(list(ACTORS8), factor=3, seed=7)
            assert r1 == r2
            assert all(r1.owners(p) == r2.owners(p) for p in r1.partitions())
            assert r1.partition(S, b"x") == r2.partition(S, b"x")
            return r1, r1.partition(S, b"x")
        both(case)

    def test_seed_changes_placement(self):
        def case(P):
            a = P.Ring.build(ACTORS8, factor=3, seed=0)
            b = P.Ring.build(ACTORS8, factor=3, seed=1)
            assert any(a.owners(p) != b.owners(p) for p in a.partitions())
            return a, b
        both(case)

    def test_owners_and_fallbacks_partition_the_actors(self):
        def case(P):
            ring = P.Ring.build(ACTORS8, factor=3)
            out = []
            for pid in ring.partitions():
                owners, rest = ring.owners(pid), ring.fallbacks(pid)
                assert len(owners) == 3
                assert not set(owners) & set(rest)
                assert set(owners) | set(rest) == set(ACTORS8)
                out.append((owners, rest))
            return out
        both(case)

    def test_minimal_movement_on_join(self):
        def case(P):
            old = P.Ring.build(ACTORS8, factor=3)
            new = old.with_actors(ACTORS8 + ["v8"])
            delta = old.delta_to(new)
            assert delta.old_epoch == 0 and delta.new_epoch == 1
            assert 0 < len(delta.moves) < P.DEFAULT_PARTITIONS
            for move in delta.moves:
                assert move.joined == ("v8",)
                assert len(move.left) == 1
                assert set(move.survivors()) == set(move.old_owners) - set(
                    move.left)
            assert len(delta.moves) <= P.DEFAULT_PARTITIONS // 2
            return delta
        both(case)

    def test_unmoved_partitions_keep_owner_order(self):
        def case(P):
            old = P.Ring.build(ACTORS8, factor=3)
            new = old.with_actors(ACTORS8 + ["v8"])
            moved = set(old.delta_to(new).moved_pids())
            for pid in old.partitions():
                if pid not in moved:
                    assert old.owners(pid) == new.owners(pid)
            return sorted(moved), new
        both(case)

    def test_full_ring_is_degenerate(self):
        def case(P):
            ring = P.Ring.full(["a", "b", "c"])
            assert ring.full_replication and ring.n_partitions == 1
            assert ring.partition(S, b"anything") == 0
            assert ring.owners(0) == ("a", "b", "c")  # ORDER preserved
            assert ring.storage_set(S, 0) == S        # passthrough
            assert ring.write_quorum() == 2
            return ring
        both(case)

    def test_pset_codec_round_trips(self):
        def case(P):
            pset = P.partition_set(S, 37)
            assert P.split_partition_set(pset) == (S, 37)
            assert P.split_partition_set(S) == (S, None)
            assert pset.startswith(S + b"\x00")
            return pset
        both(case)

    def test_coverage_minimises_vnode_footprint(self):
        def case(P):
            ring = P.Ring.build(ACTORS8, factor=3)
            cover = P.plan_coverage(ring, S, ACTORS8, r=2)
            assert len(cover.assignments) == P.DEFAULT_PARTITIONS
            assert all(len(actors) == 2 for _p, _s, actors
                       in cover.assignments)
            for pid, pset, actors in cover.assignments:
                assert set(actors) <= set(ring.owners(pid))
                assert pset == ring.storage_set(S, pid)
            return cover
        both(case)

    def test_coverage_raises_vnode_down_with_payload(self):
        def case(P):
            ring = P.Ring.build(ACTORS8, factor=3)
            victims = ring.owners(0)[:2]
            live = [a for a in ACTORS8 if a not in victims]
            with pytest.raises(P.VnodeDown) as err:
                P.plan_coverage(ring, S, live, r=2, pids=[0])
            assert err.value.vnode in victims
            assert err.value.set_name == S
            return err.value, err.value.vnode
        both(case)

    def test_coverage_rejects_r_above_factor(self):
        def case(P):
            ring = P.Ring.build(ACTORS8, factor=3)
            with pytest.raises(ValueError) as err:
                P.plan_coverage(ring, S, ACTORS8, r=4, pids=[0])
            assert "replication factor" in str(err.value)
            return err.value
        both(case)


# ------------------------------------------- partitioned == unpartitioned
def apply_ops(cluster, ops):
    for kind, i, coord in ops:
        el = b"el%02d" % i
        if kind == "add":
            cluster.add(S, el, coordinator=coord % cluster.n, value=b"v" + el)
        else:
            cluster.remove(S, el, coordinator=coord % cluster.n)


def apply_ops_ctx(cluster, ops):
    """Ops with client-provided remove contexts (paper §4.3.2): the ctx is
    the dots of the element's own prior adds, so the outcome is pure set
    algebra — identical on any topology under any delivery."""
    ctxs = {}
    for kind, i, coord in ops:
        el = b"el%02d" % i
        if kind == "add":
            d = cluster.add(S, el, coordinator=coord % cluster.n,
                            value=b"v" + el)
            ctxs.setdefault(el, []).append(d.dot)
        else:
            ctx = ctxs.pop(el, None)
            if ctx:
                cluster.remove(S, el, coordinator=coord % cluster.n, ctx=ctx)


ops_st = st.lists(
    st.tuples(st.sampled_from(["add", "remove"]), st.integers(0, 24),
              st.integers(0, 7)),
    min_size=1, max_size=40)


class TestPartitionedEquivalence:
    @given(ops_st, st.integers(0, 2**31 - 1))
    @settings(max_examples=25, deadline=None)
    def test_results_match_unpartitioned_under_faults(self, ops, seed):
        def case(P):
            full = P.BigsetCluster(
                3, net=P.Network(seed=seed, dup_prob=0.2, reorder=True))
            part = P.BigsetCluster(
                ring=P.Ring.build(ACTORS8, factor=3),
                net=P.Network(seed=seed, dup_prob=0.2, reorder=True))
            apply_ops(full, ops)
            apply_ops(part, ops)
            full.settle()
            part.settle()
            fr = full.query(P.Scan(S, page_size=100), repair=False)
            pr = part.query(P.Scan(S, page_size=100), repair=False)
            assert pr.members == fr.members
            assert pr.count == fr.count
            pc = part.query(P.Count(S), repair=False)
            fc = full.query(P.Count(S), repair=False)
            assert pc.count == fc.count
            probes = []
            for i in (0, 7, 19):
                el = b"el%02d" % i
                pm = part.query(P.Membership(S, el), repair=False)
                fm = full.query(P.Membership(S, el), repair=False)
                assert pm.present == fm.present
                probes.append((pm, fm))
            return (fr, pr, fc, pc, probes, cluster_state(full),
                    cluster_state(part))
        both(case)

    @given(ops_st, st.integers(0, 2**31 - 1))
    @settings(max_examples=15, deadline=None)
    def test_dropped_deltas_heal_via_quorum_and_ticks(self, ops, seed):
        """Drops leave replicas divergent; anti-entropy converges the
        partitioned cluster to the fault-free unpartitioned oracle, on
        both packages and to the same state (ROADMAP C6: the ticks'
        traffic is delivered, and sweeps run until the owners agree)."""
        def case(P):
            oracle = P.BigsetCluster(3)
            part = P.BigsetCluster(
                ring=P.Ring.build(ACTORS8, factor=3),
                net=P.Network(seed=seed, drop_prob=0.3, reorder=True),
                sync=False)
            apply_ops_ctx(oracle, ops)
            apply_ops_ctx(part, ops)
            part.settle()
            for _ in range(40):
                part.tick()
            part.settle()  # deliver the anti-entropy the ticks sent
            sweeps = heal(part, S)
            truth = oracle.query(P.Range(S), repair=False)
            got = part.query(P.Range(S), repair=False)
            assert got.members == truth.members
            return got, sweeps, cluster_state(part)
        both(case)

    def test_pagination_boundaries_identical(self):
        def case(P):
            full = P.BigsetCluster(3)
            part = P.BigsetCluster(ring=P.Ring.build(ACTORS8, factor=3))
            for el in elems(30):
                full.add(S, el)
                part.add(S, el)
            cur_f = cur_p = None
            pages = []
            for _ in range(10):
                pf = full.query(P.Scan(S, page_size=7, cursor=cur_f))
                pp = part.query(P.Scan(S, page_size=7, cursor=cur_p))
                assert pp.members == pf.members
                assert (pp.cursor is None) == (pf.cursor is None)
                pages.append((pf, pp))
                cur_f, cur_p = pf.cursor, pp.cursor
                if cur_f is None:
                    break
            assert cur_f is None
            return pages, cluster_state(part)
        both(case)

    def test_coverage_surfaced_in_stats(self):
        def case(P):
            part = P.BigsetCluster(ring=P.Ring.build(ACTORS8, factor=3))
            part.add(S, b"x")
            m = part.query(P.Membership(S, b"x"))
            assert m.stats.coverage == "epoch=0;partitions=1;vnodes=2;r=2"
            r = part.query(P.Range(S))
            assert r.stats.coverage == (
                f"epoch=0;partitions={P.DEFAULT_PARTITIONS};vnodes=7;r=2")
            return m, r
        both(case)

    def test_index_queries_fan_in_across_partitions(self):
        def case(P):
            full = P.BigsetCluster(3)
            part = P.BigsetCluster(ring=P.Ring.build(ACTORS8, factor=3))
            spec = P.by_value_prefix(2, name=b"pfx")
            for c in (full, part):
                c.register_index(S, spec)
                for i, el in enumerate(elems(20)):
                    c.add(S, el, value=b"%02d-payload" % (i % 4))
            res_f = full.query(P.IndexLookup(S, b"pfx", b"01"))
            res_p = part.query(P.IndexLookup(S, b"pfx", b"01"))
            assert ([(ik, el) for ik, el, _ in res_p.index_entries]
                    == [(ik, el) for ik, el, _ in res_f.index_entries])
            return res_f, res_p, cluster_state(part)
        both(case)


# ------------------------------------------------------------ ring change
def loaded_cluster(P, n_elems=120, **kw):
    c = P.BigsetCluster(ring=P.Ring.build(ACTORS8, factor=3), **kw)
    for el in elems(n_elems):
        c.add(S, el, value=b"v:" + el)
    return c


def drain(c, ticks=30):
    for _ in range(ticks):
        c.tick(budget=0)
        if not (c.ring_state()["handoffs_pending"]
                or c.ring_state()["retires_pending"]):
            break


class TestHandoff:
    def test_epoch_bump_ships_only_moved_partitions(self):
        def case(P):
            c = loaded_cluster(P)
            before = c.query(P.Scan(S, page_size=500)).members
            shipped0 = c.ae_stats().keys_shipped
            scanned0 = c.ae_stats().keys_scanned
            delta = c.add_vnode("v8")
            moved = set(delta.moved_pids())
            assert {t.pid for t in c._handoffs} <= moved
            assert {t.pid for t in c._retires} <= moved
            drain(c)
            assert c.ring_state()["handoffs_pending"] == 0
            assert c.ring_state()["retires_pending"] == 0
            old = P.Ring.build(ACTORS8, factor=3)
            moved_keys = sum(
                1 for el in elems(120) if old.partition(S, el) in moved)
            assert c.ae_stats().keys_shipped - shipped0 == moved_keys
            assert c.ae_stats().keys_scanned - scanned0 <= (
                2 * moved_keys + len(moved))
            after = c.query(P.Scan(S, page_size=500))
            assert after.members == before
            return delta, moved_keys, after, cluster_state(c)
        both(case)

    def test_leaver_copy_retired_only_after_domination(self):
        def case(P):
            c = loaded_cluster(P)
            delta = c.add_vnode("v8")
            move = next(m for m in delta.moves
                        if any(c.ring.partition(S, el) == m.pid
                               for el in elems(120)))
            pset = c.ring.storage_set(S, move.pid)
            leaver = move.left[0]
            held = P.side_stats(c.vnodes[leaver].store, pset)
            assert held.keys > 0
            drain(c)
            gone = P.side_stats(c.vnodes[leaver].store, pset)
            assert gone.keys == 0
            assert P.side_stats(c.vnodes["v8"].store, pset).keys > 0
            assert c.ae_stats().handoff_retired == len(c._retires)
            return move, held, gone, cluster_state(c)
        both(case)

    def test_epoch_retires_and_cursors_fall_forward(self):
        def case(P):
            c = loaded_cluster(P, n_elems=40)
            page1 = c.query(P.Scan(S, page_size=15), ring_epoch=0)
            c.add_vnode("v8")
            drain(c)
            assert c.ring_state()["serveable_epochs"] == [1]
            page2 = c.query(P.Scan(S, page_size=100, cursor=page1.cursor),
                            ring_epoch=0)
            assert "epoch=1" in page2.stats.coverage
            assert page1.members + page2.members == elems(40)
            return page1, page2, cluster_state(c)
        both(case)

    def test_crash_restart_during_handoff_loses_nothing(self):
        def case(P):
            c = loaded_cluster(P, durable=True)
            c.sync_all()  # acknowledgement barrier: all 120 writes durable
            c.add_vnode("v8")
            c.tick(budget=0)   # partial handoff under way
            c.crash("v8")      # the joiner dies mid-pull
            for _ in range(3):
                c.tick(budget=0)
            rec = c.restart("v8")
            drain(c)
            assert c.ring_state()["handoffs_pending"] == 0
            res = c.query(P.Scan(S, page_size=500))
            assert res.members == elems(120)
            return rec, res, cluster_state(c)
        both(case)

    def test_donor_crash_during_handoff_loses_nothing(self):
        def case(P):
            c = loaded_cluster(P, durable=True)
            c.sync_all()
            delta = c.add_vnode("v8")
            donors = {t.src for t in c._handoffs}
            victim = sorted(donors)[0]
            c.crash(victim)
            for _ in range(5):
                c.tick(budget=0)
            rec = c.restart(victim)
            drain(c, ticks=40)
            assert c.ring_state()["handoffs_pending"] == 0
            assert c.ring_state()["retires_pending"] == 0
            res = c.query(P.Scan(S, page_size=500))
            assert res.members == elems(120)
            assert delta.new_epoch == c.ring.epoch
            return victim, rec, res, cluster_state(c)
        both(case)

    def test_writes_during_handoff_survive(self):
        def case(P):
            c = loaded_cluster(P)
            c.add_vnode("v8")
            c.tick(budget=0)
            late = [b"late%02d" % i for i in range(20)]
            for el in late:
                c.add(S, el)
            drain(c)
            res = c.query(P.Scan(S, page_size=500))
            assert res.members == sorted(elems(120) + late)
            return res, cluster_state(c)
        both(case)


# ------------------------------------------------------- sloppy placement
class TestHintedHandoff:
    def test_write_routes_around_crashed_owner(self):
        def case(P):
            c = P.BigsetCluster(ring=P.Ring.build(ACTORS8, factor=3),
                                durable=True)
            c.add(S, b"seed")
            pref = c.ring.preference_list(S, b"target")
            victim = pref.owners[0]
            c.crash(victim)
            alive = next(i for i, a in enumerate(c.actors) if a != victim)
            c.add(S, b"target", value=b"val", coordinator=alive)
            assert c.ae_stats().hints_recorded == 1
            during = c.query(P.Membership(S, b"target"))
            assert during.present
            rec = c.restart(victim)
            for _ in range(6):
                c.tick(budget=0)
            assert c.ae_stats().hints_resolved == 1
            assert c.ring_state()["hints_pending"] == 0
            pset = c.ring.storage_set(S, pref.pid)
            assert c.vnodes[victim].is_member(pset, b"target")[0]
            fallback = next(a for a in pref.fallbacks
                            if P.side_stats(c.vnodes[a].store, pset).keys == 0)
            assert fallback is not None
            return pref, during, rec, fallback, cluster_state(c)
        both(case)

    def test_vnode_down_when_no_owner_or_fallback(self):
        def case(P):
            actors = ["a", "b", "c"]
            c = P.BigsetCluster(ring=P.Ring.build(actors, factor=3),
                                durable=True)
            c.add(S, b"x", coordinator=1)
            for v in actors[1:]:
                c.crash(v)
            with pytest.raises(P.VnodeDown) as err:
                for i in range(50):
                    c.add(S, b"probe%02d" % i, coordinator=0)
            assert err.value.vnode in actors
            assert err.value.set_name == S
            return err.value, err.value.vnode, cluster_state(c)
        both(case)

    def test_crashed_coordinator_raises_with_payload(self):
        def case(P):
            c = P.BigsetCluster(ring=P.Ring.build(ACTORS8, factor=3),
                                durable=True)
            c.add(S, b"x")
            c.crash(0)
            with pytest.raises(P.VnodeDown) as err:
                c.add(S, b"y", coordinator=0)
            assert err.value.vnode == "v0"
            assert err.value.set_name == S
            return err.value, cluster_state(c)
        both(case)


# ----------------------------------------------------------- storage bound
class TestStoragePartitioning:
    def test_per_vnode_storage_is_fractional(self):
        def case(P):
            n = 400
            c = P.BigsetCluster(ring=P.Ring.build(ACTORS8, factor=3))
            for el in elems(n):
                c.add(S, el, value=b"payload:" + el)
            per_vnode = []
            for a in c.actors:
                keys = sum(P.side_stats(c.vnodes[a].store,
                                        c.ring.storage_set(S, pid)).keys
                           for pid in c.ring.partitions())
                per_vnode.append(keys)
            assert sum(per_vnode) == 3 * n
            assert max(per_vnode) <= 1.6 * (3 * n / 8)
            return per_vnode, cluster_state(c)
        both(case)


# ------------------------------------------------- a reference fault (C11)
class TestRetireStall:
    def test_retire_waits_on_dots_only_the_leaver_holds(self):
        """ROADMAP C11, a reference fault both packages keep.  Handoff
        pulls a moved partition from a surviving owner, and the leaver's
        copy retires only once the joiner's clock descends the leaver's.
        The moved partition's sync pairs no longer include the leaver, so
        a dot that only the leaver holds (its replication lost) never
        reaches the joiner: the retire waits however long the cluster
        ticks, and a quorum read over the new owners misses the element."""
        def case(P):
            ring = P.Ring.build(ACTORS8, factor=3)
            move = ring.delta_to(ring.with_actors(ACTORS8 + ["v8"])).moves[0]
            leaver = move.left[0]
            el = next(e for e in elems(10_000)
                      if ring.partition(S, e) == move.pid)
            c = P.BigsetCluster(ring=ring, sync=False)
            c.add(S, el, coordinator=c.actors.index(leaver))
            c.net.queue.clear()  # the write's replication is lost
            c.add_vnode("v8")
            for _ in range(20):
                c.tick(budget=0)
                c.settle()
            for _ in range(5):
                c.tick(budget=sweep_budget(c))
                c.settle()
            pset = c.ring.storage_set(S, move.pid)
            assert c.ring_state()["handoffs_pending"] == 0
            assert c.ring_state()["retires_pending"] == 1
            assert c.ring_state()["serveable_epochs"] == [0, 1]
            assert c.vnodes[leaver].is_member(pset, el)[0]
            assert not any(c.vnodes[a].is_member(pset, el)[0]
                           for a in move.new_owners)
            read = c.query(P.Membership(S, el), repair=False)
            assert not read.present
            return move, read, cluster_state(c)
        both(case)
