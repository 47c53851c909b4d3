"""The port's membership CRDT and elastic assignment against the JAX
package's, on the CPU.

Every case of ``tests/test_membership.py`` runs as a scenario on both
packages: the case's own assertions hold on the port, and what it observes
(member views, incarnations as ``(actor, counter)`` pairs, data-parallel
groups, rings, assignments) equals the JAX package's under the same seeded
gossip, drops and reorders included.
"""
import types

import pytest
from hypothesis import given, settings, strategies as st

import repro.cluster.membership as jax_membership
import repro.cluster.placement as jax_placement
import repro.cluster.sim as jax_sim
import repro.runtime.elastic as jax_elastic
import repro_torch.cluster.membership as membership
import repro_torch.cluster.placement as placement
import repro_torch.cluster.sim as sim
import repro_torch.runtime.elastic as elastic


def _pkg(mem, place, simm, ela):
    return types.SimpleNamespace(
        GossipCluster=mem.GossipCluster, MembershipView=mem.MembershipView,
        Ring=place.Ring, Network=simm.Network,
        ElasticController=ela.ElasticController,
        derive_assignment=ela.derive_assignment)


PORT = _pkg(membership, placement, sim, elastic)
JAX = _pkg(jax_membership, jax_placement, jax_sim, jax_elastic)


def _inc(dots):
    return sorted((d.actor, d.counter) for d in dots)


def _views(c):
    return {nid: v.members() for nid, v in c.nodes.items()}


def _ring(r):
    return (tuple(r.actors), r.factor)


def _assignment(a):
    return (a.epoch, a.hosts, a.batch_slices)


def same_on_both(scenario, *args):
    """Run ``scenario`` on the port (its assertions included) and on the
    JAX package; what it returns must be equal."""
    got = scenario(PORT, *args)
    assert got == scenario(JAX, *args)
    return got


# ------------------------------------------------------------ membership
def test_bootstrap_converges():
    def run(M):
        c = M.GossipCluster(5)
        c.settle()
        assert c.converged()
        assert c.views()[0] == frozenset(f"node{i}" for i in range(5))
        return _views(c)
    same_on_both(run)


def test_leave_propagates():
    def run(M):
        c = M.GossipCluster(4)
        c.settle()
        c.node_leaves("node2")
        c.settle()
        assert c.converged()
        assert "node2" not in c.views()[0]
        return _views(c)
    same_on_both(run)


def test_eject_straggler():
    def run(M):
        c = M.GossipCluster(4)
        c.settle()
        c.eject("node0", "node3")
        c.settle()
        assert "node3" not in c.views()[0]
        return _views(c)
    same_on_both(run)


def test_rejoin_after_eject_wins():
    """Add-wins: a node re-joining concurrently with its ejection stays."""
    def run(M):
        c = M.GossipCluster(3)
        c.settle()
        eject_delta = c.nodes["node0"].leave("node2")
        rejoin_delta = c.nodes["node2"].join()
        for nid in c.nodes:
            c.nodes[nid].apply(eject_delta)
            c.nodes[nid].apply(rejoin_delta)
        assert all("node2" in v for v in c.views())
        return _views(c), _inc(c.nodes["node1"].incarnation("node2"))
    same_on_both(run)


@given(st.lists(st.tuples(st.sampled_from(["join", "leave"]),
                          st.integers(0, 5)), max_size=12),
       st.integers(0, 2**31 - 1))
@settings(max_examples=40, deadline=None)
def test_converges_under_lossy_gossip(events, seed):
    def run(M):
        net = M.Network(seed=seed, drop_prob=0.4, reorder=True)
        c = M.GossipCluster(3, net=net)
        c.settle()
        extant = {f"node{i}" for i in range(3)}
        for kind, i in events:
            nid = f"xnode{i}"
            if kind == "join" and nid not in extant:
                c.node_joins(nid)
                extant.add(nid)
            elif kind == "leave" and nid in extant:
                c.node_leaves(nid)
                extant.discard(nid)
        c.settle()
        c.anti_entropy_round()   # repairs dropped deltas
        c.anti_entropy_round()
        assert c.converged()
        return _views(c), net.bytes_sent
    same_on_both(run)


# ----------------------------------------------------------- incarnation
def test_rejoin_bumps_incarnation():
    def run(M):
        v = M.MembershipView("a")
        v.apply(v.join())
        inc1 = v.incarnation("a")
        v.apply(v.leave())
        assert v.incarnation("a") == ()
        v.apply(v.join())
        inc2 = v.incarnation("a")
        assert inc2 != inc1
        # the new incarnation causally follows the ejected one
        assert max(d.counter for d in inc2) > max(d.counter for d in inc1)
        return _inc(inc1), _inc(inc2)
    same_on_both(run)


def test_eject_then_rejoin_wins_everywhere():
    def run(M):
        c = M.GossipCluster(3)
        c.settle()
        eject = c.nodes["node0"].leave("node2")
        rejoin = c.nodes["node2"].join()
        c.nodes["node1"].apply(eject)
        c.nodes["node1"].apply(rejoin)
        c.nodes["node0"].apply(rejoin)
        c.nodes["node2"].apply(eject)
        assert c.nodes["node1"].is_member("node2")
        assert c.nodes["node0"].is_member("node2")
        assert c.nodes["node2"].is_member("node2")
        new_inc = c.nodes["node1"].incarnation("node2")
        assert any(d.counter > 1 for d in new_inc)
        return _views(c), _inc(new_inc)
    same_on_both(run)


def test_concurrent_join_leave_converge():
    def run(M):
        a, b = M.MembershipView("a"), M.MembershipView("b")
        b.apply(a.join("seed"))
        da = a.join()
        db = b.join()
        a.apply(db)
        b.apply(da)
        dl = a.leave("seed")
        dj = b.join("seed")
        a.apply(dj)
        b.apply(dl)
        assert a.members() == b.members()
        assert "seed" in a.members()  # add-wins
        return a.members(), _inc(a.incarnation("seed"))
    same_on_both(run)


# ---------------------------------------------------- data-parallel groups
def test_groups_cover_alive_set():
    def run(M):
        c = M.GossipCluster(5)
        c.settle()
        groups = c.nodes["node0"].data_parallel_groups(2)
        flat = [n for g in groups for n in g]
        assert sorted(flat) == sorted(c.nodes["node0"].members())
        assert all(len(g) <= 2 for g in groups)
        return groups
    same_on_both(run)


def test_groups_stable_across_converged_views():
    def run(M):
        c = M.GossipCluster(4)
        c.settle()
        c.node_joins("xnode9")
        c.node_leaves("node1")
        c.settle()
        c.anti_entropy_round()
        assert c.converged()
        expected = c.nodes["node0"].data_parallel_groups(3)
        assert all(v.data_parallel_groups(3) == expected
                   for v in c.nodes.values())
        return expected
    same_on_both(run)


def test_join_perturbs_only_downstream_groups():
    def run(M):
        v = M.MembershipView("a")
        for n in ["a", "b", "c", "d", "e", "f"]:
            v.apply(v.join(n))
        before = v.data_parallel_groups(2)
        v.apply(v.join("zz"))
        after = v.data_parallel_groups(2)
        assert after[:len(before)] == before
        assert after[-1] == ("zz",)
        return before, after
    same_on_both(run)


def test_group_size_validated():
    for M in (PORT, JAX):
        with pytest.raises(ValueError):
            M.MembershipView("a").data_parallel_groups(0)


# ------------------------------------------------------ ring from members
def test_ring_consumes_alive_set():
    def run(M):
        c = M.GossipCluster(5)
        c.settle()
        ring = M.Ring.from_members(c.nodes["node0"], factor=3)
        assert set(ring.actors) == c.nodes["node0"].members()
        assert all(M.Ring.from_members(v, factor=3) == ring
                   for v in c.nodes.values())
        return _ring(ring)
    same_on_both(run)


def test_ring_shrinks_with_membership():
    def run(M):
        c = M.GossipCluster(3)
        c.settle()
        c.node_leaves("node2")
        c.settle()
        ring = M.Ring.from_members(c.nodes["node0"], factor=3)
        assert "node2" not in ring.actors
        assert ring.factor == 2
        return _ring(ring)
    same_on_both(run)


# --------------------------------------------------------------- elastic
def test_assignment_partitions_batch():
    def run(M):
        a = M.derive_assignment(frozenset({"a", "b", "c"}), 8, epoch=1)
        slices = sorted(a.batch_slices.values())
        assert slices[0][0] == 0 and slices[-1][1] == 8
        assert sum(hi - lo for lo, hi in slices) == 8
        return _assignment(a)
    same_on_both(run)


def test_scale_down_reassigns():
    def run(M):
        ctl = M.ElasticController(4, global_batch=8)
        a1 = ctl.current_assignment()
        assert a1.dp_size == 4
        a2 = ctl.fail("node1", detected_by="node0")
        assert a2.dp_size == 3
        assert "node1" not in a2.hosts
        assert sum(hi - lo for lo, hi in a2.batch_slices.values()) == 8
        return _assignment(a1), _assignment(a2)
    same_on_both(run)


def test_scale_up():
    def run(M):
        ctl = M.ElasticController(2, global_batch=6)
        a = ctl.scale_up("node9")
        assert a.dp_size == 3 and "node9" in a.hosts
        return _assignment(a)
    same_on_both(run)
