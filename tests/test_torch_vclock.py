"""The port's dense interval clock against the JAX package's and the
sparse ``Clock``: the same seeded dots through ``repro.core.vclock`` and
``repro_torch.core.vclock`` must give bit-identical run arrays.

Every result is an integer array, so the tolerance is exact equality.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import vclock as jvc
from repro.core.clock import Clock as JClock
from repro.core.dots import Dot as JDot
from repro_torch.core import vclock as tvc
from repro_torch.core.clock import Clock as TClock
from repro_torch.core.dots import Dot as TDot

ACTORS4 = ["a", "b", "c", "d"]
IDX4 = {a: i for i, a in enumerate(ACTORS4)}
SEEDS = range(8)
WIDTH = 40  # run slots per row: no row of these tests needs more


def _dots(rng, hi, n):
    # a fixed count (duplicates included) keeps the JAX side's shapes
    # fixed, so it compiles each op once per test rather than per seed
    return [(int(a), int(c)) for a, c in zip(rng.integers(0, 4, n),
                                             rng.integers(1, hi + 1, n))]


def _pair(dots):
    """(JAX sparse clock, port sparse clock) over the same dots."""
    j = JClock.zero().add_dots(JDot(ACTORS4[a], c) for a, c in dots)
    t = TClock.zero().add_dots(TDot(ACTORS4[a], c) for a, c in dots)
    return j, t


def _dense(pair, n_runs=WIDTH):
    j, t = pair
    return (jvc.from_clock(j, IDX4, 4, n_runs),
            tvc.from_clock(t, IDX4, 4, n_runs, device="cpu"))


def _same(jd, td):
    """Bit-identical run arrays, dtype included."""
    assert td.starts.dtype == torch.int32 and td.ends.dtype == torch.int32
    assert np.array_equal(np.asarray(jd.starts), td.starts.numpy())
    assert np.array_equal(np.asarray(jd.ends), td.ends.numpy())


def _runs(clock):
    return sorted(clock.iter_runs(), key=repr)


class TestTorchVClock:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_dense_seen_matches_jax_and_sparse(self, seed):
        rng = np.random.default_rng(seed)
        dots = _dots(rng, 90, 40)
        pair = _pair(dots)
        jd, td = _dense(pair)
        _same(jd, td)
        probe_a = np.array([a for a, _ in dots] + [0, 1, 2, 3], np.int32)
        probe_c = np.array([c for _, c in dots] + [1, 64, 90, 128], np.int32)
        want_j = np.asarray(jvc.dots_seen(jd, jnp.asarray(probe_a),
                                          jnp.asarray(probe_c)))
        got = tvc.dots_seen(td, torch.from_numpy(probe_a),
                            torch.from_numpy(probe_c))
        assert got.dtype == torch.bool
        assert np.array_equal(got.numpy(), want_j)
        oracle = [pair[1].seen(TDot(ACTORS4[a], int(c)))
                  for a, c in zip(probe_a, probe_c)]
        assert got.tolist() == oracle

    @pytest.mark.parametrize("seed", SEEDS)
    def test_roundtrip_sparse_dense_sparse(self, seed):
        pair = _pair(_dots(np.random.default_rng(100 + seed), 120, 40))
        _jd, td = _dense(pair)
        back = tvc.to_clock(td, ACTORS4)
        assert back == pair[1]
        assert _runs(back) == _runs(pair[0])

    @pytest.mark.parametrize("seed", SEEDS)
    def test_join_subtract_intersect_match_jax(self, seed):
        rng = np.random.default_rng(200 + seed)
        p1 = _pair(_dots(rng, 100, 30))
        p2 = _pair(_dots(rng, 100, 30))
        (ja, ta), (jb, tb) = _dense(p1), _dense(p2)
        for jop, top, sparse in [
            (jvc.join, tvc.join, p1[1].join(p2[1])),
            (jvc.subtract, tvc.subtract, p1[1].subtract_clock(p2[1])),
            (jvc.intersect, tvc.intersect, p1[1].intersect(p2[1])),
        ]:
            got = top(ta, tb)
            _same(jop(ja, jb), got)
            assert tvc.to_clock(got, ACTORS4) == sparse

    @pytest.mark.parametrize("seed", SEEDS)
    def test_add_dots_matches_jax(self, seed):
        rng = np.random.default_rng(300 + seed)
        base = _pair(_dots(rng, 80, 25))
        extra = _dots(rng, 80, 25)
        jd, td = _dense(base)
        ea = np.array([a for a, _ in extra], np.int32)
        ec = np.array([c for _, c in extra], np.int32)
        got = tvc.add_dots(td, torch.from_numpy(ea), torch.from_numpy(ec))
        _same(jvc.add_dots(jd, jnp.asarray(ea), jnp.asarray(ec)), got)
        want = base[1].add_dots(TDot(ACTORS4[a], c) for a, c in extra)
        assert tvc.to_clock(got, ACTORS4) == want

    @pytest.mark.parametrize("seed", SEEDS)
    def test_popcount_base_vv_compact_match_jax(self, seed):
        rng = np.random.default_rng(400 + seed)
        p1, p2 = _pair(_dots(rng, 60, 30)), _pair(_dots(rng, 60, 30))
        (ja, ta), (jb, tb) = _dense(p1, 30), _dense(p2, 30)
        jj, tj = jvc.join(ja, jb), tvc.join(ta, tb)
        assert np.array_equal(np.asarray(jvc.popcount(jj)),
                              tvc.popcount(tj).numpy())
        assert tvc.popcount(tj).dtype == torch.int32
        assert np.array_equal(np.asarray(jvc.base_vv(jj)),
                              tvc.base_vv(tj).numpy())
        _same(jvc.compact(jj), tvc.compact(tj))
        assert int(tvc.popcount(tj).sum()) == p1[1].join(p2[1]).n_events()

    def test_sort_runs_ties_keep_order(self):
        # equal starts, and empties of several shapes: the sort must be
        # stable to land where jnp.argsort (stable) puts them
        starts = np.array([[3, 9, 3, 1, 5, 3], [1, 1, 7, 0, 1, 2]], np.int32)
        ends = np.array([[4, 9, 7, 0, 2, 3], [0, 5, 8, 0, 2, 1]], np.int32)
        rng = np.random.default_rng(7)
        rand_s = rng.integers(0, 5, (4, 64)).astype(np.int32)
        rand_e = rng.integers(0, 5, (4, 64)).astype(np.int32)
        for s, e in [(starts, ends), (rand_s, rand_e)]:
            js, je = jvc.sort_runs(jnp.asarray(s), jnp.asarray(e))
            ts, te = tvc.sort_runs(torch.from_numpy(s), torch.from_numpy(e))
            assert np.array_equal(np.asarray(js), ts.numpy())
            assert np.array_equal(np.asarray(je), te.numpy())

    def test_subtract_is_origin_free(self):
        j1, t1 = _pair([(0, c) for c in range(1, 41)])
        j2, t2 = _pair([(0, c) for c in (2, 9, 40)])
        jd = jvc.subtract(jvc.from_clock(j1, IDX4, 4),
                          jvc.from_clock(j2, IDX4, 4))
        td = tvc.subtract(tvc.from_clock(t1, IDX4, 4, device="cpu"),
                          tvc.from_clock(t2, IDX4, 4, device="cpu"))
        _same(jd, td)
        assert tvc.to_clock(td, ACTORS4) == t1.subtract_clock(t2)
        assert int(tvc.popcount(td).sum()) == 37

    def test_no_window_cap(self):
        dense = tvc.from_clock(TClock(base={"a": 1_000_000}), IDX4, 4,
                               device="cpu")
        assert dense.n_runs == 1
        got = tvc.dots_seen(dense, torch.zeros(3, dtype=torch.int32),
                            torch.tensor([1, 999_999, 1_000_001],
                                         dtype=torch.int32))
        assert got.tolist() == [True, True, False]

    def test_actor_outside_universe_is_unseen(self):
        dense = tvc.from_clock(TClock(base={"a": 10, "d": 10}), IDX4, 4,
                               device="cpu")
        actors = torch.tensor([-1, 0, 3, 4, 99], dtype=torch.int32)
        counters = torch.full((5,), 5, dtype=torch.int32)
        assert tvc.dots_seen(dense, actors, counters).tolist() == [
            False, True, True, False, False]

    def test_from_clock_width_and_device(self):
        pair = _pair([(0, 1), (0, 3), (0, 5), (2, 9)])
        jd, td = _dense(pair, n_runs=5)
        _same(jd, td)
        assert td.device == torch.device("cpu")
        with pytest.raises(ValueError):
            tvc.from_clock(pair[1], IDX4, 4, n_runs=2, device="cpu")
        with pytest.raises(ValueError):
            tvc.join(tvc.zero(2, device="cpu"), tvc.zero(3, device="cpu"))

    def test_densify_100k_contiguous_is_o_runs(self):
        # one (lo, hi) pair per run, however many events the clock covers
        big = TClock(base={"x": 100_000}).add_dots(
            [TDot("x", 100_005), TDot("y", 7)])
        dense = tvc.from_clock(big, {"x": 0, "y": 1}, 2, device="cpu")
        assert dense.starts.numel() <= 4
        assert int(tvc.popcount(dense).sum()) == 100_002
        assert tvc.to_clock(dense, ["x", "y"]) == big

    def test_subtract_origin_free_across_bases(self):
        s1 = TClock(base={"x": 50}).add_dots([TDot("x", 60)])
        s2 = TClock(base={"x": 10}).add_dots(
            [TDot("x", 20), TDot("x", 21), TDot("x", 60)])
        diff = tvc.subtract(tvc.from_clock(s1, {"x": 0}, 1, device="cpu"),
                            tvc.from_clock(s2, {"x": 0}, 1, device="cpu"))
        assert tvc.to_clock(diff, ["x"]) == s1.subtract_clock(s2)
        assert int(tvc.popcount(diff).sum()) == 50 - 10 - 2
