"""The port's clock-lattice ops (``join``, ``subtract``, ``intersect``,
``popcount``; plain versions and wrappers, on the CPU) against the JAX
package's reference, its Pallas kernels in interpret mode, the sparse
``Clock`` and a small interval-set oracle written here.

The CUDA kernels run only on a card; ``chip_smoke.py`` and the ``gpu``
tests hold them against the same plain versions there.  Results are
integers, so every comparison is exact equality.

For counters in ``[0, 2**31 - 1]`` the port equals the JAX package bit for
bit, but for one place: JAX's ``sort_runs`` keys empty slots at
``2**31 - 1``, so a run that starts there can land among the empty slots
(ROADMAP C9), where the port keeps every row canonical; there the port is
held to JAX's rows sorted canonically.  At ``-2**31`` the JAX reference
computes its candidate edges in int32 and wraps, dropping runs (ROADMAP
C8); the port computes them in int64, so there it is held to the
interval-set oracle alone.

A merge's canonical row (sorted maximal runs, empty ``(1, 0)`` slots last)
is a function of the two sets alone; the CUDA merge writes it directly,
and (g) holds the plain version to that here.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch
from hypothesis import given, settings, strategies as st

from repro.core import vclock as jvc
from repro.kernels.clock_ops import ops as jops
from repro_torch.core import vclock as tvc
from repro_torch.core.clock import Clock as TClock
from repro_torch.core.dots import Dot as TDot
from repro_torch.core.vclock import DenseClock
from repro_torch.kernels import clock_ops as co

TOP, LOW = 2**31 - 1, -2**31
OPS = ("join", "subtract", "intersect")
EMPTY = (1, 0)


def _random_clock(n_actors, n_runs, rng, pad=0):
    """A random canonical dense clock (built by the port from a sparse
    clock, ``pad`` empty columns added) and the sparse oracle."""
    names = [f"v{i}" for i in range(n_actors)]
    n_dots = n_actors * n_runs * 2
    sparse = TClock.zero().add_dots(
        TDot(names[int(a)], int(c))
        for a, c in zip(rng.integers(0, n_actors, n_dots),
                        rng.integers(1, n_runs * 20, n_dots)))
    idx = {a: i for i, a in enumerate(names)}
    dense = tvc.from_clock(sparse, idx, n_actors, device="cpu")
    if pad:
        width = dense.n_runs + pad
        dense = tvc.from_clock(sparse, idx, n_actors, width, device="cpu")
    return dense, sparse, names


def _pair(starts, ends):
    """The same run arrays as a port clock and a JAX clock."""
    s = np.ascontiguousarray(starts, np.int32)
    e = np.ascontiguousarray(ends, np.int32)
    return (DenseClock(torch.tensor(s), torch.tensor(e)),
            jvc.DenseClock(jnp.asarray(s), jnp.asarray(e)))


def _np(clock):
    return np.asarray(clock.starts), np.asarray(clock.ends)


def _assert_same(port, jax_clock):
    ps, pe = _np(port)
    js, je = _np(jax_clock)
    assert ps.dtype == np.int32 and pe.dtype == np.int32
    assert np.array_equal(ps, js) and np.array_equal(pe, je)


def _assert_same_canonical(port, jax_clock):
    """The port's rows equal JAX's, sorted canonically: JAX's own wherever
    its rows are canonical, which is everywhere but C9."""
    js, je = tvc.sort_runs(*(torch.from_numpy(np.array(x))
                             for x in _np(jax_clock)))
    _assert_same(port, DenseClock(js, je))


def _arrays(rows, width):
    """int32 run arrays from per-row lists of (lo, hi), padded with (1, 0)."""
    rows = [list(r) + [EMPTY] * (width - len(r)) for r in rows]
    s = np.array([[lo for lo, _ in r] for r in rows], np.int64)
    e = np.array([[hi for _, hi in r] for r in rows], np.int64)
    return s.astype(np.int32), e.astype(np.int32)


def _coalesce(runs):
    out = []
    for lo, hi in sorted((lo, hi) for lo, hi in runs if lo <= hi):
        if out and lo <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [tuple(r) for r in out]


def _oracle(a_runs, b_runs, op):
    """The merge of two rows of runs over Python ints (no wrap): sorted,
    disjoint, coalesced runs."""
    a, b = _coalesce(a_runs), _coalesce(b_runs)
    cuts = sorted({lo for lo, _ in a + b} | {hi + 1 for _, hi in a + b})

    def inside(runs, x):
        return any(lo <= x <= hi for lo, hi in runs)

    keep = {"join": lambda x, y: x or y, "subtract": lambda x, y: x and not y,
            "intersect": lambda x, y: x and y}[op]
    pieces = [(lo, nxt - 1) for lo, nxt in zip(cuts, cuts[1:])
              if keep(inside(a, lo), inside(b, lo))]
    return _coalesce(pieces)


def _rows(clock):
    s, e = _np(clock)
    return [[(int(lo), int(hi)) for lo, hi in zip(rs, re_) if lo <= hi]
            for rs, re_ in zip(s, e)]


def _assert_canonical(clock):
    """Sorted by start, empty (1, 0) slots last."""
    s, e = _np(clock)
    for rs, re_ in zip(s, e):
        valid = rs <= re_
        n = int(valid.sum())
        assert valid[:n].all() and not valid[n:].any()
        assert (rs[n:] == 1).all() and (re_[n:] == 0).all()
        assert (np.diff(rs[:n].astype(np.int64)) > 0).all()


# ------------------------------------------------------------ (a) parity
@pytest.mark.parametrize("n_actors,ra,rb", [(4, 16, 16), (8, 64, 64),
                                            (13, 25, 25), (6, 10, 30)])
def test_merges_match_jax_ref_pallas_and_sparse(n_actors, ra, rb):
    rng = np.random.default_rng(n_actors * 100 + ra)
    ta, sa, names = _random_clock(n_actors, ra, rng)
    tb, sb, _ = _random_clock(n_actors, rb, rng, pad=3 if ra != rb else 0)
    if ra != rb:
        assert ta.n_runs != tb.n_runs
    ja = jvc.DenseClock(*(jnp.asarray(x.numpy()) for x in ta))
    jb = jvc.DenseClock(*(jnp.asarray(x.numpy()) for x in tb))
    for op, sparse_want in (("join", sa.join(sb)),
                            ("subtract", sa.subtract_clock(sb)),
                            ("intersect", sa.intersect(sb))):
        got = getattr(co, op)(ta, tb)
        assert got.starts.device.type == "cpu"
        assert got.n_runs == ta.n_runs + tb.n_runs
        _assert_same(got, getattr(jops, op)(ja, jb, use_pallas=False))
        _assert_same(got, getattr(jops, op)(ja, jb, use_pallas=True,
                                            interpret=True))
        assert tvc.to_clock(got, names) == sparse_want


def test_ops_equal_the_port_vclock_ops():
    rng = np.random.default_rng(3)
    ta, _, _ = _random_clock(5, 12, rng)
    tb, _, _ = _random_clock(5, 12, rng)
    for op in OPS:
        got = getattr(co, op)(ta, tb)
        want = getattr(tvc, op)(ta, tb)
        assert torch.equal(got.starts, want.starts)
        assert torch.equal(got.ends, want.ends)


# ------------------------------------------------- (b) non-canonical inputs
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unsorted_overlapping_duplicated_runs_match_jax(seed):
    rng = np.random.default_rng(seed)
    n_actors, ra, rb = 5, 12, 9

    def draw(r):
        s = rng.integers(0, 60, (n_actors, r))
        e = s + rng.integers(0, 10, (n_actors, r))
        s[:, 3], e[:, 3] = s[:, 1], e[:, 1]              # a duplicate run
        empty = rng.random((n_actors, r)) < 0.25         # empties mid-row
        empty[:, 1] = empty[:, 3] = False
        s[empty], e[empty] = 1, 0
        return s, e

    a_s, a_e = draw(ra)
    b_s, b_e = draw(rb)
    b_s[:, 0], b_e[:, 0] = a_s[:, 1], a_e[:, 1]          # shared by a and b
    ta, ja = _pair(a_s, a_e)
    tb, jb = _pair(b_s, b_e)
    for op in OPS:
        got = getattr(co, op)(ta, tb)
        _assert_canonical(got)
        _assert_same(got, getattr(jops, op)(ja, jb, use_pallas=False))
        _assert_same(got, getattr(jops, op)(ja, jb, use_pallas=True,
                                            interpret=True))
        want = [_oracle(list(zip(a_s[i], a_e[i])), list(zip(b_s[i], b_e[i])), op)
                for i in range(n_actors)]
        assert _rows(got) == want
    # the raw merge keeps the reference's slots, before any sort
    for ref, mode in ((co.join_ref, "or"), (co.subtract_ref, "andnot"),
                      (co.intersect_ref, "and")):
        s, e = ref(ta.starts, ta.ends, tb.starts, tb.ends)
        js, je = jvc._interval_merge(ja.starts, ja.ends, jb.starts, jb.ends,
                                     mode)
        assert np.array_equal(s.numpy(), np.asarray(js))
        assert np.array_equal(e.numpy(), np.asarray(je))


# ------------------------------------------------------- (c) int32 edges
TOP_A = [[(TOP - 10, TOP), (5, 9), (TOP - 30, TOP - 25)],
         [(0, TOP)],
         [(TOP, TOP), (1, 3)],
         [(TOP - 4, TOP - 2), (TOP - 2, TOP)],
         [(0, 4)]]
TOP_B = [[(TOP - 3, TOP), (TOP - 20, TOP - 12), (6, 6)],
         [(TOP - 1, TOP), (0, 0), (3, 4)],
         [(TOP, TOP)],
         [(TOP - 3, TOP - 3)],
         [(TOP - 5, TOP)]]
LOW_A = [[(LOW, TOP - 3)],
         [(LOW, LOW + 5), (0, 2)],
         [(LOW, -1), (LOW + 2, 3)],
         [(LOW + 1, LOW + 1), (TOP, TOP)]]
LOW_B = [[(LOW, -5), (0, 2), (TOP - 1, TOP), (LOW, LOW)],
         [(LOW, LOW)],
         [(LOW + 1, LOW + 1), (-3, 0)],
         [(LOW, LOW + 2), (TOP - 1, TOP)]]


def test_counters_at_int32_max_match_jax_and_the_oracle():
    (a_s, a_e), (b_s, b_e) = _arrays(TOP_A, 4), _arrays(TOP_B, 3)
    ta, ja = _pair(a_s, a_e)
    tb, jb = _pair(b_s, b_e)
    for op in OPS:
        got = getattr(co, op)(ta, tb)
        _assert_same(got, getattr(jops, op)(ja, jb, use_pallas=False))
        _assert_same(got, getattr(jops, op)(ja, jb, use_pallas=True,
                                            interpret=True))
        assert _rows(got) == [_oracle(x, y, op) for x, y in zip(TOP_A, TOP_B)]


def test_counters_at_int32_min_match_the_oracle():
    # C8: the JAX reference wraps here; nothing is asserted about it
    (a_s, a_e), (b_s, b_e) = _arrays(LOW_A, 3), _arrays(LOW_B, 5)
    ta, _ = _pair(a_s, a_e)
    tb, _ = _pair(b_s, b_e)
    for op in OPS:
        got = getattr(co, op)(ta, tb)
        _assert_canonical(got)
        assert _rows(got) == [_oracle(x, y, op) for x, y in zip(LOW_A, LOW_B)]
    # a run that starts at -2^31 survives the union
    assert _rows(co.join(ta, tb))[0] == [(LOW, TOP - 3), (TOP - 1, TOP)]


# ------------------------------------------------------------ (d) popcount
@pytest.mark.parametrize("n_actors,n_runs", [(6, 12), (13, 25)])
def test_popcount_matches_jax_ref_pallas_and_sparse(n_actors, n_runs):
    rng = np.random.default_rng(7 + n_runs)
    ta, sparse, _ = _random_clock(n_actors, n_runs, rng)
    ja = jvc.DenseClock(*(jnp.asarray(x.numpy()) for x in ta))
    got = co.popcount(ta)
    assert got.dtype == torch.int32 and got.shape == (n_actors,)
    assert np.array_equal(got.numpy(), np.asarray(jops.popcount(ja)))
    assert np.array_equal(got.numpy(), np.asarray(
        jops.popcount(ja, use_pallas=True, interpret=True)))
    assert int(got.long().sum()) == sparse.n_events()


def test_popcount_wraps_as_jax_does():
    rows = [[(0, TOP - 5), (10, TOP)],
            [(0, TOP)],
            [(LOW, 5)],
            [(5, LOW)],
            [(TOP, TOP), (LOW, LOW), EMPTY],
            [(1, 3), (2, 8), (9, 1)]]
    s, e = _arrays(rows, 3)
    ta, ja = _pair(s, e)
    got = co.popcount(ta).numpy()
    assert np.array_equal(got, np.asarray(jops.popcount(ja)))
    assert np.array_equal(got, np.asarray(
        jops.popcount(ja, use_pallas=True, interpret=True)))
    assert got[0] == -15 and got[1] == 0
    assert got[4] == 2 and got[5] == 3 + 7


# ------------------------------------------------------- (e) property
_COUNTER = st.one_of(st.integers(0, 40), st.integers(TOP - 5, TOP))
_RUN = st.one_of(st.tuples(_COUNTER, _COUNTER), st.just(EMPTY))
_ROWS = st.lists(st.lists(_RUN, min_size=5, max_size=5), min_size=3,
                 max_size=3)


@given(_ROWS, _ROWS)
@settings(max_examples=50, deadline=None, derandomize=True)
def test_property_port_matches_jax_ref(a_rows, b_rows):
    ta, ja = _pair(*_arrays(a_rows, 5))
    tb, jb = _pair(*_arrays(b_rows, 5))
    for op in OPS:
        got = getattr(co, op)(ta, tb)
        _assert_canonical(got)
        _assert_same_canonical(got, getattr(jops, op)(ja, jb,
                                                      use_pallas=False))
        assert _rows(got) == [_oracle(x, y, op)
                              for x, y in zip(a_rows, b_rows)]
    assert np.array_equal(co.popcount(ta).numpy(),
                          np.asarray(jops.popcount(ja)))


# ------------------------------------------- (f) arguments and the ledger
def test_a_different_actor_count_raises():
    a = tvc.zero(3, 2, device="cpu")
    b = tvc.zero(4, 2, device="cpu")
    for op in OPS:
        with pytest.raises(ValueError, match="share the actor universe"):
            getattr(co, op)(a, b)


def test_bad_arguments_raise():
    a = tvc.zero(3, 2, device="cpu")
    wide = DenseClock(a.starts.long(), a.ends.long())
    with pytest.raises(TypeError, match="int32"):
        co.join(wide, a)
    with pytest.raises(TypeError, match="int32"):
        co.popcount(wide)
    strided = DenseClock(torch.ones((2, 3), dtype=torch.int32).t(),
                         torch.zeros((2, 3), dtype=torch.int32).t())
    with pytest.raises(ValueError, match="contiguous"):
        co.subtract(strided, strided)
    flat = DenseClock(torch.ones(3, dtype=torch.int32),
                      torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\[A, R\]"):
        co.intersect(flat, flat)
    meta = DenseClock(torch.ones((3, 2), dtype=torch.int32, device="meta"),
                      torch.zeros((3, 2), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        co.popcount(meta)


def test_ledger_counts_launches_and_rows_on_the_cpu():
    a = tvc.zero(5, 3, device="cpu")
    b = tvc.zero(5, 2, device="cpu")
    before = [ledger.snapshot() for ledger in co.DISPATCHES]
    for op in OPS:
        getattr(co, op)(a, b)
    co.popcount(a)
    co.popcount(b)
    merge, pop = (ledger.delta(since)
                  for ledger, since in zip(co.DISPATCHES, before))
    # CPU tensors run the plain versions: no CUDA kernel launch
    assert vars(merge) == {"launches": 3, "rows": 15, "kernel_launches": 0}
    assert vars(pop) == {"launches": 2, "rows": 10, "kernel_launches": 0}
    assert co.DISPATCHES._fields == ("merge", "popcount")


# ------------------------------------------------- (g) the canonical row
def _messy_rows(rng, n_actors, n_runs):
    """Unsorted, overlapping and duplicated runs with empty slots mid-row,
    counters in [0, 2**31 - 1]: small ones that overlap, and some at the
    top, runs that start at 2**31 - 1 among them."""
    s = rng.integers(0, 60, (n_actors, n_runs))
    e = s + rng.integers(-1, 12, (n_actors, n_runs))
    top = rng.random((n_actors, n_runs)) < 0.2
    s[top] = TOP - rng.integers(0, 4, int(top.sum()))
    e[top] = np.minimum(s[top] + rng.integers(0, 3, int(top.sum())), TOP)
    s[:, 3], e[:, 3] = s[:, 1], e[:, 1]              # a duplicate run
    empty = rng.random((n_actors, n_runs)) < 0.25    # empties mid-row
    empty[:, 1] = empty[:, 3] = False
    s[empty], e[empty] = 1, 0
    return s.astype(np.int32), e.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("op,mode", [("join", "or"), ("subtract", "andnot"),
                                     ("intersect", "and")])
def test_sorted_plain_merge_is_the_canonical_row_of_the_sets(op, mode, seed):
    # the fact the CUDA merge rests on: whatever slots the plain version
    # fills, sorting them gives the sorted maximal runs of the live set,
    # padded with (1, 0) to Ra + Rb slots
    rng = np.random.default_rng(100 + seed)
    n_actors, ra, rb = 8, 11, 7 + seed
    a_s, a_e = _messy_rows(rng, n_actors, ra)
    b_s, b_e = _messy_rows(rng, n_actors, rb)
    ta, ja = _pair(a_s, a_e)
    tb, jb = _pair(b_s, b_e)
    ref = {"or": co.join_ref, "andnot": co.subtract_ref,
           "and": co.intersect_ref}[mode]
    got = DenseClock(*tvc.sort_runs(*ref(ta.starts, ta.ends, tb.starts,
                                         tb.ends)))
    want = [_oracle(list(zip(a_s[i].tolist(), a_e[i].tolist())),
                    list(zip(b_s[i].tolist(), b_e[i].tolist())), op)
            for i in range(n_actors)]
    padded = _arrays(want, ra + rb)
    assert np.array_equal(got.starts.numpy(), padded[0])
    assert np.array_equal(got.ends.numpy(), padded[1])
    # JAX's merge, sorted the same way, gives the same rows
    js, je = jvc._interval_merge(ja.starts, ja.ends, jb.starts, jb.ends, mode)
    jsorted = tvc.sort_runs(torch.from_numpy(np.array(js)),
                            torch.from_numpy(np.array(je)))
    assert all(torch.equal(g, w) for g, w in zip(got, jsorted))
    # and the wrapper returns exactly these rows
    assert all(torch.equal(g, w) for g, w in zip(getattr(co, op)(ta, tb), got))


def test_sort_runs_keeps_a_run_at_int32_max_before_the_empties():
    # C9: JAX's sort_runs keys empties at 2**31 - 1 and leaves such a run
    # among them in slot order
    s = np.array([[1, 5, 1, TOP, 1]], np.int32)
    e = np.array([[0, 9, 0, TOP, 0]], np.int32)
    ts, te = tvc.sort_runs(torch.from_numpy(s), torch.from_numpy(e))
    assert ts.tolist() == [[5, TOP, 1, 1, 1]]
    assert te.tolist() == [[9, TOP, 0, 0, 0]]
    js, je = jvc.sort_runs(jnp.asarray(s), jnp.asarray(e))
    assert np.asarray(js).tolist() == [[5, 1, 1, TOP, 1]]
    assert np.asarray(je).tolist() == [[9, 0, 0, TOP, 0]]
