"""The port's ``dot_seen`` (plain version and wrapper, on the CPU) against
the JAX package's reference, its Pallas kernel in interpret mode, and the
sparse ``Clock``.

The CUDA kernel itself runs only on a card; ``chip_smoke.py`` holds it
against the same plain version there.  Results are booleans, so the
tolerance is exact equality.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import vclock as jvc
from repro.core.clock import Clock as JClock
from repro.core.dots import Dot as JDot
from repro.kernels.dot_seen import dot_seen_pallas, dot_seen_ref as jax_ref
from repro_torch.core.clock import Clock as TClock
from repro_torch.core.dots import Dot as TDot
from repro_torch.core.vclock import DenseClock
from repro_torch.interop import dense_clock_from_numpy
from repro_torch.kernels.dot_seen import (DISPATCHES, DispatchStats, dot_seen,
                                          dot_seen_ref)


def _random_clock(n_actors, n_runs, hi, rng):
    """The same random canonical clock in both packages, plus the sparse
    port clock as the oracle."""
    names = [f"v{i}" for i in range(n_actors)]
    n_dots = n_actors * n_runs * 2
    pairs = [(names[int(a)], int(c)) for a, c in zip(
        rng.integers(0, n_actors, n_dots), rng.integers(1, hi, n_dots))]
    jsparse = JClock.zero().add_dots(JDot(a, c) for a, c in pairs)
    tsparse = TClock.zero().add_dots(TDot(a, c) for a, c in pairs)
    idx = {a: i for i, a in enumerate(names)}
    jd = jvc.from_clock(jsparse, idx, n_actors)
    td = dense_clock_from_numpy(np.asarray(jd.starts), np.asarray(jd.ends),
                                device="cpu")
    return jd, td, tsparse, names


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.int32))


class TestTorchDotSeen:
    @pytest.mark.parametrize("n_actors,n_runs,n_dots,block_n", [
        (4, 8, 64, 32),
        (16, 32, 1000, 256),
        (128, 16, 4096, 1024),
        (3, 2, 17, 64),     # ragged: the Pallas pad path
    ])
    def test_matches_jax_ref_pallas_and_sparse(self, n_actors, n_runs,
                                               n_dots, block_n):
        rng = np.random.default_rng(n_actors * 1000 + n_dots)
        jd, td, sparse, names = _random_clock(n_actors, n_runs,
                                              n_runs * 40, rng)
        actors = rng.integers(0, n_actors, n_dots).astype(np.int32)
        counters = rng.integers(1, n_runs * 40 + 80, n_dots).astype(np.int32)
        want = np.asarray(jax_ref(jd.starts, jd.ends, jnp.asarray(actors),
                                  jnp.asarray(counters)))
        pallas = np.asarray(dot_seen_pallas(
            jd.starts, jd.ends, jnp.asarray(actors), jnp.asarray(counters),
            block_n=block_n, interpret=True))
        ref = dot_seen_ref(td.starts, td.ends, _t(actors), _t(counters))
        got = dot_seen(td, _t(actors), _t(counters))
        assert got.dtype == torch.bool and got.device.type == "cpu"
        assert np.array_equal(ref.numpy(), want)
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(got.numpy(), pallas)
        oracle = [sparse.seen(TDot(names[a], int(c)))
                  for a, c in zip(actors, counters)]
        assert got.tolist() == oracle

    def test_counters_above_2_24_match_jax_ref_and_sparse(self):
        # the Pallas kernel's f32 gather is exact only below 2^24; the
        # port compares int32s, so it is held to the jnp reference and the
        # sparse clock over the whole int32 range
        top = 2**31 - 1
        starts = np.array([[1, 2**24 + 1, top - 5], [1, 1, 1]], np.int32)
        ends = np.array([[100, 2**24 + 3, top], [2**30, 0, 0]], np.int32)
        actors = np.array([0, 0, 0, 0, 0, 0, 1, 1, 1], np.int32)
        counters = np.array([2**24, 2**24 + 1, 2**24 + 3, 2**24 + 4,
                             top, top - 6, 2**30, 2**30 + 1, 1], np.int32)
        want = np.asarray(jax_ref(jnp.asarray(starts), jnp.asarray(ends),
                                  jnp.asarray(actors), jnp.asarray(counters)))
        got = dot_seen(DenseClock(_t(starts), _t(ends)), _t(actors),
                       _t(counters))
        assert np.array_equal(got.numpy(), want)
        sparse = TClock(runs={"p": [(1, 100), (2**24 + 1, 2**24 + 3),
                                    (top - 5, top)], "q": [(1, 2**30)]})
        oracle = [sparse.seen(TDot("pq"[a], int(c)))
                  for a, c in zip(actors, counters)]
        assert got.tolist() == oracle == [False, True, True, False, True,
                                          False, True, False, True]

    def test_actor_outside_universe_is_unseen(self):
        rng = np.random.default_rng(5)
        jd, td, sparse, names = _random_clock(4, 8, 200, rng)
        actors = rng.integers(-4, 8, 256).astype(np.int32)
        counters = rng.integers(0, 240, 256).astype(np.int32)
        got = dot_seen(td, _t(actors), _t(counters)).numpy()
        inside = (actors >= 0) & (actors < 4)
        assert not got[~inside].any()
        want = np.asarray(jax_ref(jd.starts, jd.ends,
                                  jnp.asarray(actors[inside]),
                                  jnp.asarray(counters[inside])))
        assert np.array_equal(got[inside], want)

    def test_ledger_counts_launches_and_rows(self):
        _jd, td, _s, _n = _random_clock(3, 4, 100, np.random.default_rng(9))
        before = DISPATCHES.snapshot()
        for n in (17, 512, 1024):
            dot_seen(td, torch.zeros(n, dtype=torch.int32),
                     torch.ones(n, dtype=torch.int32))
        delta = DISPATCHES.delta(before)
        assert isinstance(delta, DispatchStats)
        # CPU tensors run the plain version: no CUDA kernel launch
        assert vars(delta) == {"launches": 3, "rows": 17 + 512 + 1024,
                               "kernel_launches": 0}

    def test_rejects_bad_arguments(self):
        _jd, td, _s, _n = _random_clock(3, 4, 100, np.random.default_rng(1))
        a = torch.zeros(8, dtype=torch.int32)
        c = torch.ones(8, dtype=torch.int32)
        with pytest.raises(TypeError):
            dot_seen(td, a.long(), c)
        with pytest.raises(ValueError):
            dot_seen(td, torch.zeros(16, dtype=torch.int32)[::2], c)
        with pytest.raises(ValueError):
            dot_seen(td, a, torch.ones(9, dtype=torch.int32))
        with pytest.raises(ValueError):
            dot_seen(DenseClock(td.starts, td.ends[:, :1].contiguous()), a, c)
        with pytest.raises(ValueError):  # devices disagree
            dot_seen(td, a.to("meta"), c.to("meta"))
        with pytest.raises(ValueError):  # no kernel for this device
            dot_seen(DenseClock(td.starts.to("meta"), td.ends.to("meta")),
                     a.to("meta"), c.to("meta"))


# ------------------------------------------------ the CUDA kernel's geometry
@pytest.mark.parametrize("n_actors,n_runs,n_dots", [
    (1, 2000, 1024),      # the serve path: staged
    (64, 4096, 1 << 20),  # the stress shape: rows read from global memory
    (3, 1, 17), (5, 3, 300), (2, 12, 257), (7, 31, 1037), (1, 33, 8),
    (200, 33, 1000), (4, 0, 5),
])
def test_kernel_plan_covers_every_dot_and_run_once(n_actors, n_runs,
                                                   n_dots):
    from repro_torch.kernels.dot_seen.kernel import (DOTS_PER_BLOCK,
                                                     STAGE_INTS, THREADS,
                                                     UNROLL, plan)
    p = plan(n_actors, n_runs, n_dots)
    assert DOTS_PER_BLOCK * 32 == THREADS
    assert p.staged == (2 * n_actors * n_runs <= STAGE_INTS)
    # dot of each (block, thread), as the kernel computes it
    blk, tid = np.meshgrid(np.arange(p.blocks), np.arange(THREADS),
                           indexing="ij")
    dots = blk * DOTS_PER_BLOCK + tid // 32
    lane = tid % 32
    first = dots[lane == 0]
    assert np.array_equal(np.sort(first[first < n_dots]), np.arange(n_dots))
    # runs of one warp: r = base + u * 32 + lane, base in steps of U * 32
    runs = [base + u * 32 + g
            for base in range(0, n_runs, UNROLL * 32)
            for u in range(UNROLL) for g in range(32)]
    assert sorted(r for r in runs if r < n_runs) == list(range(n_runs))


def test_kernel_module_builds_nothing_on_import():
    from repro_torch.kernels.dot_seen import kernel as dk
    assert dk.library.cache_info().currsize == 0
    assert dk.SOURCE.is_file() and dk.SOURCE.suffix == ".cu"
