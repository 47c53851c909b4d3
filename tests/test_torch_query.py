"""One vnode, both packages: the same seeded op sequence is replayed on a
JAX ``BigsetVnode`` and a port ``BigsetVnode`` (two coordinators, so the
set-tombstone spans two actors), and every plan shape must give the same
answer — entries, ``present``, ``count``, cursor bytes, ``QueryStats`` and
``plan_to_wire`` bytes — page after page.  The port executes on the CPU.

A port vnode rebuilt from the JAX vnode's raw ``(key, value)`` pairs
(``interop.vnode_from_items``) must answer the same.
"""
import dataclasses

import numpy as np
import pytest

import repro.core  # noqa: F401  (core before index: see ROADMAP C2)
import repro_torch.core  # noqa: F401
from repro.core.bigset import BigsetVnode as JVnode
from repro.index import by_element_suffix as j_suffix
from repro import query as jq
from repro_torch.core.bigset import BigsetVnode as TVnode
from repro_torch.index import by_element_suffix as t_suffix
from repro_torch import query as tq
from repro_torch.interop import vnode_from_items
from repro_torch.query.batch import MIN_BATCH

S, T = b"qset", b"qset2"
IDX = b"element_suffix:1"


def _replay(vnode_cls, suffix, seed=0):
    """Two vnodes fed the same seeded inserts/removes; returns both."""
    rng = np.random.default_rng(seed)
    vns = [vnode_cls("n0"), vnode_cls("n1")]
    for vn in vns:
        vn.register_index(S, suffix(1))
    order = rng.permutation(900)

    def insert(set_name, el, value, coord, ctx=()):
        delta = vns[coord].coordinate_insert(set_name, el, ctx, value=value)
        vns[1 - coord].replica_insert(delta)

    for i in order[:600]:
        insert(S, b"e%04d" % i, b"v%d" % (i % 7), int(rng.integers(0, 2)))
    for i in order[300:700]:
        insert(T, b"e%04d" % i, b"", int(rng.integers(0, 2)))
    for i in rng.choice(order[:600], 180, replace=False):
        coord = int(rng.integers(0, 2))
        _present, ctx = vns[coord].is_member(S, b"e%04d" % i)
        delta = vns[coord].coordinate_remove(S, ctx)
        vns[1 - coord].replica_remove(delta)
    for i in rng.choice(order[:600], 40, replace=False):  # replacing adds
        el = b"e%04d" % i
        _present, ctx = vns[0].is_member(S, el)
        insert(S, el, b"r", 0, ctx=ctx)
    return vns


@pytest.fixture(scope="module")
def vnodes():
    return _replay(JVnode, j_suffix), _replay(TVnode, t_suffix)


# (shape, fields, paginate): every plan shape the executor takes
PLANS = [
    ("Membership", dict(set_name=S, element=b"e0003"), False),
    ("Membership", dict(set_name=S, element=b"zzzz"), False),
    ("Range", dict(set_name=S, start=b"e0100", end=b"e0700", limit=70), True),
    ("Scan", dict(set_name=S, page_size=150), True),
    ("Count", dict(set_name=S, start=b"e0050"), False),
    ("Join", dict(kind="intersect", left=S, right=T, limit=80), True),
    ("Join", dict(kind="union", left=S, right=T, limit=200), True),
    ("Join", dict(kind="difference", left=S, right=T, strategy="gallop",
                  limit=90), True),
    ("Join", dict(kind="intersect", left=T, right=S, strategy="gallop"),
     False),
    ("IndexLookup", dict(set_name=S, index=IDX, key=b"3", limit=25), True),
    ("IndexRange", dict(set_name=S, index=IDX, start=b"2", end=b"7",
                        limit=120), True),
]


def _dots(dots):
    return tuple((d.actor, d.counter) for d in dots)


def _norm(res):
    return {
        "entries": [(el, _dots(ds)) for el, ds in res.entries],
        "index_entries": None if res.index_entries is None else [
            (ik, el, _dots(ds)) for ik, el, ds in res.index_entries],
        "present": res.present,
        "count": res.count,
        "cursor": res.cursor,
        "clock": sorted(res.clock.iter_runs()) if res.clock else None,
        "stats": dataclasses.asdict(res.stats),
    }


def _pages(q, executor, shape, fields, paginate, max_pages=12):
    """Run a plan and follow its cursors; (wire bytes, normalised) pages."""
    plan = getattr(q, shape)(**fields)
    out = []
    while True:
        res = executor.execute(plan)
        out.append((q.plan_to_wire(plan), _norm(res)))
        if not paginate or res.cursor is None or len(out) >= max_pages:
            return out
        plan = dataclasses.replace(plan, cursor=res.cursor)


@pytest.mark.parametrize("shape,fields,paginate", PLANS,
                         ids=[f"{p[0]}{i}" for i, p in enumerate(PLANS)])
def test_plan_matches_jax(vnodes, shape, fields, paginate):
    jvn, tvn = vnodes
    for side in (0, 1):
        want = _pages(jq, jq.QueryExecutor(jvn[side]), shape, fields, paginate)
        got = _pages(tq, tq.QueryExecutor(tvn[side], device="cpu"),
                     shape, fields, paginate)
        assert got == want


def test_every_plan_shape_is_covered():
    assert {p[0] for p in PLANS} == {
        "Membership", "Range", "Scan", "Count", "Join", "IndexLookup",
        "IndexRange"}


def test_scan_dispatches_batched_visibility(vnodes):
    # the fixture is big enough that chunks take the batched path
    _jvn, tvn = vnodes
    res = tq.QueryExecutor(tvn[0], device="cpu").execute(tq.Scan(S))
    assert res.stats.kernel_launches > 0
    assert res.stats.kernel_rows >= MIN_BATCH
    assert len(tvn[0].read_tombstone(S).actors()) == 2


def test_vnode_from_items_answers_the_same(vnodes):
    jvn, _tvn = vnodes
    rebuilt = vnode_from_items("n0", jvn[0].store.scan())
    for shape, fields, paginate in PLANS:
        want = _pages(jq, jq.QueryExecutor(jvn[0]), shape, fields, paginate)
        got = _pages(tq, tq.QueryExecutor(rebuilt, device="cpu"),
                     shape, fields, paginate)
        assert got == want, shape
