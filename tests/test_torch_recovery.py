"""The reference's durability and crash-recovery cases
(``tests/test_recovery.py``), held against JAX.

Each case runs the same seeded workload through both packages
(:mod:`torch_sides`) — WAL framing, group commit, seeded ``CrashPoint``s at
WAL offsets and file publishes, cluster ``crash`` / ``restart`` and
anti-entropy on lossy networks — asserts what the reference case asserts
on each, and asserts that both give equal ``RecoveryResult``s, recovered
stores, ``AntiEntropyStats``, ``Network`` traffic and ``ring_state()``.
The port runs on the CPU.

At a crash offset that falls exactly on a record's end, the whole record
is durable although the put raised before its acknowledgement, so replay
may restore one batch more than was acknowledged (ROADMAP C1).  The
ported case holds the invariant itself, acknowledged => durable:
``acked <= replayed <= acked + 1``, and the two packages equal.
"""
import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_sides import both, cluster_state, store_digest

S = b"people"


def key(i: int) -> bytes:
    return b"k%04d" % i


def batches_to_wal(P, batches) -> bytes:
    return b"".join(
        P.encode_wal_record(seq, items)
        for seq, items in enumerate(batches, start=1))


# --------------------------------------------------------------------- codec
class TestWalCodec:
    @given(st.lists(
        st.lists(st.tuples(st.binary(max_size=12), st.binary(max_size=24)),
                 max_size=4),
        max_size=6))
    @settings(max_examples=40, deadline=None)
    def test_roundtrip(self, batches):
        def case(P):
            wal = batches_to_wal(P, batches)
            records, torn = P.decode_wal(wal)
            assert torn == 0
            assert [list(r.items) for r in records] == batches
            assert [r.seq for r in records] == list(
                range(1, len(batches) + 1))
            assert sum(r.nbytes for r in records) == len(wal)
            return wal, records
        both(case)

    @given(st.integers(min_value=0, max_value=600), st.randoms())
    @settings(max_examples=50, deadline=None)
    def test_any_truncation_decodes_to_a_record_prefix(self, cut, rng):
        batches = [
            [(bytes([rng.randrange(256)]) * rng.randrange(1, 8),
              bytes([rng.randrange(256)]) * rng.randrange(0, 12))
             for _ in range(rng.randrange(3))]
            for _ in range(rng.randrange(1, 8))
        ]

        def case(P):
            wal = batches_to_wal(P, batches)
            full, _ = P.decode_wal(wal)
            at = min(cut, len(wal))
            records, torn = P.decode_wal(wal[:at])
            assert records == full[:len(records)]
            consumed = sum(r.nbytes for r in records)
            assert consumed <= at and torn == at - consumed
            if torn == 0 and at == len(wal):
                assert len(records) == len(full)
            return wal, records, torn
        both(case)

    def test_corrupt_byte_stops_replay_at_the_frame(self):
        def case(P):
            wal = batches_to_wal(P, [[(b"a", b"1")], [(b"b", b"2")],
                                     [(b"c", b"3")]])
            first, _ = P.decode_wal(wal)
            pos = first[0].nbytes + first[1].nbytes - 1
            bad = wal[:pos] + bytes([wal[pos] ^ 0xFF]) + wal[pos + 1:]
            records, torn = P.decode_wal(bad)
            assert [r.seq for r in records] == [1]
            assert torn == len(wal) - first[0].nbytes
            return records, torn
        both(case)


# --------------------------------------------------------------------- store
def fresh_recover(P, media, **kw):
    store = P.LsmStore(media=media, **kw)
    return store, store.recover()


def recovered(store, res):
    """A recovery's result and what it rebuilt."""
    return res, store_digest(store), store.commit_seq, store.stats


class TestDurableStore:
    def test_group_commit_issues_fewer_fsyncs_than_batches(self):
        def case(P):
            media = P.DurableMedia()
            store = P.LsmStore(media=media, group_depth=8)
            for i in range(20):
                store.put(key(i), b"v")
            assert store.stats.num_fsyncs == 2        # 20 batches, depth 8
            assert store.commit_seq == 16             # acked = fsynced prefix
            store.sync()
            assert store.stats.num_fsyncs == 3 and store.commit_seq == 20
            assert media.wal_fsyncs == 3
            return store.stats, media.wal
        both(case)

    def test_volatile_store_has_no_wal_accounting(self):
        def case(P):
            store = P.LsmStore()
            for i in range(50):
                store.put(key(i), b"v")
            assert store.commit_seq == 50
            assert store.stats.bytes_wal == 0
            assert store.stats.num_fsyncs == 0
            return store.stats
        both(case)

    @given(st.integers(min_value=1, max_value=10),
           st.integers(min_value=1, max_value=40))
    @settings(max_examples=30, deadline=None)
    def test_acked_prefix_survives_an_unsynced_crash(self, depth, n):
        def case(P):
            media = P.DurableMedia()
            store = P.LsmStore(media=media, group_depth=depth)
            for i in range(n):
                store.put(key(i), b"v%d" % i)
            acked = store.commit_seq
            assert n - acked < depth
            media.crash()
            again, res = fresh_recover(P, media, group_depth=depth)
            assert res.batches_replayed + res.batches_skipped == acked
            assert res.torn_bytes == 0
            for i in range(n):
                expected = b"v%d" % i if i < acked else None
                assert again.get(key(i)) == expected
            assert again.commit_seq == acked == again._seq
            return acked, recovered(again, res)
        both(case)

    @given(st.integers(min_value=0, max_value=4000))
    @settings(max_examples=30, deadline=None)
    def test_crash_at_arbitrary_wal_offset(self, offset):
        """A seeded kill point at any byte of the log, the same offset on
        both packages: replay restores every acknowledged batch and at
        most the one whose put raised (ROADMAP C1), and both replay the
        same batches."""
        def case(P):
            media = P.DurableMedia()
            media.schedule_crash(P.CrashPoint(wal_bytes=offset))
            store = P.LsmStore(media=media, group_depth=1)
            acked = 0
            crashed = False
            for i in range(40):
                try:
                    store.put(key(i), b"v%d" % i)
                    acked = store.commit_seq
                except P.CrashError:
                    crashed = True
                    break
            media.crash()
            again, res = fresh_recover(P, media)
            assert acked <= res.batches_replayed <= acked + 1
            if crashed:
                assert len(media.wal) <= offset   # truncated at the kill point
            for i in range(40):
                expected = b"v%d" % i if i < res.batches_replayed else None
                assert again.get(key(i)) == expected
            return acked, crashed, recovered(again, res)
        both(case)

    def test_empty_wal_recovers_to_an_empty_store(self):
        def case(P):
            store, res = fresh_recover(P, P.DurableMedia())
            assert res.batches_replayed == res.batches_skipped == 0
            assert res.segments == 0 and res.torn_bytes == 0
            assert len(store) == 0 and store.commit_seq == 0
            store.put(b"a", b"1")
            assert store.get(b"a") == b"1"
            return recovered(store, res)
        both(case)

    def test_torn_final_record_is_discarded(self):
        def case(P):
            media = P.DurableMedia()
            store = P.LsmStore(media=media, group_depth=100)
            for i in range(10):
                store.put(key(i), b"v%d" % i)
            media.schedule_crash(P.CrashPoint(
                wal_bytes=len(media.wal) + media.wal_pending() - 5))
            with pytest.raises(P.CrashError):
                store.sync()
            media.crash()
            again, res = fresh_recover(P, media)
            assert res.torn_bytes > 0
            assert res.batches_replayed == 9          # record 10 was torn
            assert again.get(key(8)) == b"v8"
            assert again.get(key(9)) is None
            return recovered(again, res)
        both(case)

    def test_wal_records_below_horizon_replay_idempotently(self):
        def case(P):
            media = P.DurableMedia()
            store = P.LsmStore(media=media, group_depth=1, memtable_limit=6)
            for i in range(10):                       # flush at batch 6
                store.put(key(i), b"v%d" % i)
            media.crash()
            again, res = fresh_recover(P, media)
            assert res.segments == 1 and res.horizon == 6
            assert res.batches_skipped == 5
            assert res.batches_replayed == 4
            assert again.stats.bytes_recovered == res.bytes_replayed
            for i in range(10):
                assert again.get(key(i)) == b"v%d" % i
            second, res2 = fresh_recover(P, media)
            assert res2 == res
            assert dict(second.scan()) == dict(again.scan())
            return recovered(again, res), recovered(second, res2)
        both(case)

    def test_crash_before_flush_segment_publishes(self):
        def case(P):
            media = P.DurableMedia()
            store = P.LsmStore(media=media, group_depth=100)
            for i in range(4):
                store.put(key(i), b"v%d" % i)
            store.sync()                              # acked: 4
            for i in range(4, 8):
                store.put(key(i), b"v%d" % i)         # unsynced tail
            media.schedule_crash(P.CrashPoint(file_writes=1))
            with pytest.raises(P.CrashError):
                store.flush()                         # dies writing the run
            media.crash()
            again, res = fresh_recover(P, media)
            assert res.segments == 0
            assert res.batches_replayed == 4
            assert again.get(key(3)) == b"v3"
            assert again.get(key(4)) is None
            return recovered(again, res)
        both(case)

    def test_crash_between_segment_and_manifest(self):
        def case(P):
            media = P.DurableMedia()
            store = P.LsmStore(media=media, group_depth=100)
            for i in range(4):
                store.put(key(i), b"v%d" % i)
            store.sync()
            media.schedule_crash(P.CrashPoint(file_writes=2))
            with pytest.raises(P.CrashError):
                store.flush()                         # manifest dies
            media.crash()
            again, res = fresh_recover(P, media)
            assert res.segments == 0
            assert res.batches_replayed == 4
            assert dict(again.scan()) == {key(i): b"v%d" % i
                                          for i in range(4)}
            return recovered(again, res)
        both(case)

    def test_mid_compaction_crash_preserves_precompaction_state(self):
        def case(P):
            media = P.DurableMedia()
            store = P.LsmStore(media=media, group_depth=1)
            for i in range(10):
                store.put(key(i), b"v%d" % i)
            store.flush()                             # 2 publishes
            for i in range(10, 15):
                store.put(key(i), b"v%d" % i)
            before = dict(store.scan())
            media.schedule_crash(P.CrashPoint(file_writes=3))
            with pytest.raises(P.CrashError):
                store.compact()
            media.crash()
            again, res = fresh_recover(P, media)
            assert dict(again.scan()) == before
            assert res.segments == 2
            return recovered(again, res)
        both(case)

    def test_crash_on_wal_reset_after_compaction_manifest(self):
        def case(P):
            media = P.DurableMedia()
            store = P.LsmStore(media=media, group_depth=1)
            for i in range(8):
                store.put(key(i), b"v%d" % i)
            before = dict(store.scan())
            media.schedule_crash(P.CrashPoint(file_writes=5))
            with pytest.raises(P.CrashError):
                store.compact()
            media.crash()
            again, res = fresh_recover(P, media)
            assert res.segments == 1
            assert res.batches_replayed == 0
            assert res.batches_skipped == 8 and res.bytes_replayed == 0
            assert dict(again.scan()) == before
            return recovered(again, res)
        both(case)

    def test_recover_guards(self):
        def case(P):
            with pytest.raises(P.WalError) as e1:
                P.LsmStore().recover()                # no durable media
            media = P.DurableMedia()
            store = P.LsmStore(media=media)
            store.put(b"a", b"1")
            with pytest.raises(P.WalError) as e2:
                store.recover()                       # not a fresh store
            return e1.value, e2.value
        both(case)

    def test_legacy_clock_payloads_roundtrip_through_recovery(self):
        def case(P):
            legacy_clock = msgpack.packb({"b": [["a", 2]],
                                          "c": [["a", [4, 5]]]})
            legacy_ts = msgpack.packb({"b": [], "c": [["a", [4]]]})
            media = P.DurableMedia()
            old = P.LsmStore(media=media)
            old.put(P.clock_key(S), legacy_clock)
            old.put(P.tombstone_key(S), legacy_ts)
            old.put(P.element_key(S, b"x", P.Dot("a", 2)), b"")
            old.put(P.element_key(S, b"z", P.Dot("a", 5)), b"")
            old.sync()
            media.crash()

            store, res = fresh_recover(P, media)
            assert res.batches_replayed == 4 and res.torn_bytes == 0
            vn = P.BigsetVnode("b", store)
            assert vn.value(S) == {b"x", b"z"}
            clk = P.Clock.from_obj(msgpack.unpackb(store.get(P.clock_key(S)),
                                                   strict_map_key=False))
            assert clk.seen(P.Dot("a", 5)) and not clk.seen(P.Dot("a", 3))

            vn.coordinate_insert(S, b"w")
            upgraded = msgpack.unpackb(store.get(P.clock_key(S)),
                                       strict_map_key=False)
            assert "r" in upgraded and "c" not in upgraded
            store.sync()
            media.crash()
            store2, res2 = fresh_recover(P, media)
            assert P.BigsetVnode("b", store2).value(S) == {b"w", b"x", b"z"}
            return recovered(store, res), clk, upgraded, recovered(store2,
                                                                   res2)
        both(case)


# ------------------------------------------------------------------- cluster
def run_writes(clusters, lo, hi, coordinators=(0, 1, 2)):
    for i in range(lo, hi):
        c = coordinators[i % len(coordinators)]
        for cluster in clusters:
            cluster.add(S, key(i), coordinator=c, value=b"v%d" % i)


def heal(big, ctrl, ticks: int = 80) -> int:
    """Tick until every replica matches the control cluster; returns ticks."""
    for t in range(ticks):
        if all(big.vnodes[a].value(S) == ctrl.vnodes[a].value(S)
               for a in big.actors):
            return t
        big.tick()
        big.settle()
    raise AssertionError("anti-entropy did not heal within budget")


class TestClusterCrashRecovery:
    def test_kill_mid_batch_restart_heal_matches_no_crash_run(self):
        def case(P):
            big = P.BigsetCluster(3, durable=True, group_depth=4)
            ctrl = P.BigsetCluster(3, durable=True, group_depth=4)
            run_writes([big, ctrl], 0, 30)
            media = big.media["vnode0"]
            media.schedule_crash(P.CrashPoint(
                wal_bytes=len(media.wal) + media.wal_pending() + 40))
            crashed_at = None
            for i in range(30, 40):
                try:
                    big.add(S, key(i), coordinator=0, value=b"v%d" % i)
                except P.CrashError:
                    crashed_at = i
                    break
            assert crashed_at is not None
            big.crash(0)
            run_writes([ctrl], 30, crashed_at)
            run_writes([big, ctrl], crashed_at + 1, 40, coordinators=(1, 2))
            ctrl.add(S, key(crashed_at), coordinator=1,
                     value=b"v%d" % crashed_at)
            big.add(S, key(crashed_at), coordinator=1,
                    value=b"v%d" % crashed_at)

            rec = big.restart(0)
            assert rec.batches_replayed > 0
            ticks = heal(big, ctrl)
            stats = big.ae_stats()
            assert stats.keys_shipped >= 1
            scanned_after_heal = stats.keys_scanned
            skipped_before = stats.rounds_skipped
            big.tick()
            assert big.ae_stats().keys_scanned == scanned_after_heal
            assert big.ae_stats().rounds_skipped > skipped_before
            for a in big.actors:
                assert (dict(big.vnodes[a].store.scan())
                        == dict(ctrl.vnodes[a].store.scan()))
            return crashed_at, rec, ticks, cluster_state(big)
        both(case)

    @given(st.integers(min_value=50, max_value=8000))
    @settings(max_examples=12, deadline=None)
    def test_every_acked_write_survives_restart_before_any_sync(self, offset):
        def case(P):
            big = P.BigsetCluster(3, durable=True, group_depth=1)
            media = big.media["vnode0"]
            media.schedule_crash(P.CrashPoint(wal_bytes=offset))
            acked = []
            for i in range(60):
                try:
                    big.add(S, key(i), coordinator=i % 3, value=b"v%d" % i)
                    acked.append(i)
                except P.CrashError:
                    break
            big.crash(0)
            rec = big.restart(0)
            present = big.vnodes["vnode0"].value(S)
            for i in acked:
                assert key(i) in present, f"acknowledged write {i} lost"
            return acked, rec, present, cluster_state(big)
        both(case)

    @given(st.integers(min_value=0, max_value=2 ** 32 - 1))
    @settings(max_examples=10, deadline=None)
    def test_recovery_plus_digest_sync_converges_on_lossy_networks(self,
                                                                   seed):
        def case(P):
            net = P.Network(seed=seed, drop_prob=0.25, dup_prob=0.25,
                            reorder=True)
            big = P.BigsetCluster(3, net=net, sync=False, durable=True,
                                  group_depth=4)
            run_writes([big], 0, 24)
            big.settle()
            big.crash(0)
            run_writes([big], 24, 32, coordinators=(1, 2))
            big.settle()
            rec = big.restart(0)
            for _ in range(20):
                big.tick(budget=3)
                big.settle()
            vns = [big.vnodes[a] for a in big.actors]
            assert vns[0].value(S) == vns[1].value(S) == vns[2].value(S)
            assert vns[0].value(S) == {key(i) for i in range(32)}
            return rec, cluster_state(big)
        both(case)

    def test_restart_under_traffic_with_nonquorum_crash(self):
        def case(P):
            big = P.BigsetCluster(3, durable=True, group_depth=4)
            ctrl = P.BigsetCluster(3, durable=True, group_depth=4)
            run_writes([big, ctrl], 0, 12)
            big.crash(2)                              # outside the quorum
            crashed_rounds_before = big.ae_stats().rounds_crashed
            scans = []
            for i in range(12, 24):
                for cluster in (big, ctrl):
                    cluster.add(S, key(i), coordinator=i % 2,
                                value=b"v%d" % i)
                if i % 4 == 0:
                    big.tick()
                    res = big.query(P.Scan(S, page_size=50))
                    assert len(res.entries) == i + 1
                    scans.append(res)
            assert big.ae_stats().rounds_crashed > crashed_rounds_before
            with pytest.raises(P.VnodeDown) as err:
                big.add(S, b"down", coordinator=2)
            rec = big.restart(2)
            assert rec.batches_replayed > 0
            ticks = heal(big, ctrl)
            for a in big.actors:
                assert big.vnodes[a].value(S) == ctrl.vnodes[a].value(S)
            return scans, err.value, rec, ticks, cluster_state(big)
        both(case)

    def test_crashed_replica_drops_queued_traffic(self):
        def case(P):
            big = P.BigsetCluster(3, sync=False, durable=True, group_depth=1)
            big.add(S, b"x")                          # replication queued
            dropped_before = big.net.msgs_dropped
            big.crash(1)
            big.settle()                              # vnode1's copy is lost
            assert big.net.msgs_dropped > dropped_before
            rec = big.restart(1)
            assert big.vnodes["vnode1"].value(S) == set()
            big.tick()
            big.settle()
            assert big.vnodes["vnode1"].value(S) == {b"x"}
            return rec, cluster_state(big)
        both(case)

    def test_recovery_span_reports_replay(self):
        def case(P):
            tracer = P.Tracer()
            big = P.BigsetCluster(3, durable=True, group_depth=2,
                                  tracer=tracer)
            run_writes([big], 0, 10)
            big.crash(0)
            rec = big.restart(0)
            spans = [s for s in tracer.spans if s.name == "storage.recover"]
            assert len(spans) == 1
            attrs = spans[0].attrs
            assert attrs["actor"] == "vnode0"
            assert attrs["batches_replayed"] == rec.batches_replayed
            assert attrs["torn_bytes"] == rec.torn_bytes
            return rec, attrs, len(tracer.spans)
        both(case)

    def test_fault_api_guards(self):
        def case(P):
            volatile = P.BigsetCluster(3)
            with pytest.raises(RuntimeError) as e1:
                volatile.crash(0)
            big = P.BigsetCluster(3, durable=True)
            with pytest.raises(RuntimeError) as e2:
                big.restart(0)                        # not crashed
            big.crash(0)
            big.crash(0)                              # idempotent
            with pytest.raises(P.VnodeDown) as e3:
                big.query(P.Scan(S, page_size=10), r=3)  # no quorum
            rec = big.restart(0)
            assert "vnode0" in big.vnodes
            return e1.value, e2.value, e3.value, rec, cluster_state(big)
        both(case)

    def test_restarted_vnode_reregisters_indexes(self):
        def case(P):
            big = P.BigsetCluster(3, durable=True, group_depth=1)
            spec = P.by_value_prefix(1)
            big.register_index(S, spec)
            run_writes([big], 0, 8)
            big.crash(0)
            rec = big.restart(0)
            res = big.query(P.IndexLookup(S, spec.name, b"v"), r=3)
            assert len(res.entries) == 8
            big.add(S, b"zz", coordinator=0, value=b"v99")
            res2 = big.query(P.IndexLookup(S, spec.name, b"v"), r=3)
            assert len(res2.entries) == 9
            return rec, res, res2, cluster_state(big)
        both(case)
