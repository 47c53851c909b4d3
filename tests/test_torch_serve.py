"""The serve stack, both packages: one seeded client workload through
``BigsetService(BigsetCluster(3))`` of the JAX package and of the port (on
``device="cpu"``), with one injected fake clock, must produce the same wire
bytes request for request.

The random session id is normalised by giving both services the same
``secrets.token_hex``.  The ``stats`` op's ``kernels.dot_seen.*`` gauges
lift a process-wide ledger, so they are compared as deltas over the
workload, the JAX ``pallas_launches`` beside the port's
``kernel_launches``.
"""
import itertools
import secrets

import msgpack
import numpy as np
import pytest

import repro.core  # noqa: F401  (core before index: see ROADMAP C2)
import repro_torch.core  # noqa: F401
from repro.cluster.clusters import BigsetCluster as JCluster
from repro.index import by_element_suffix as j_suffix
from repro import query as jq
from repro.serve import bigset_service as jsvc
from repro_torch.cluster.clusters import BigsetCluster as TCluster
from repro_torch.index import by_element_suffix as t_suffix
from repro_torch import query as tq
from repro_torch.launch import serve_bigset as t_launch
from repro_torch.serve import bigset_service as tsvc

S, T = b"srv", b"srv2"
KERNEL_GAUGES = "kernels.dot_seen."


class Recorder:
    """A service front that logs every (request, response) byte pair."""

    def __init__(self, service):
        self.service = service
        self.log = []

    def handle(self, request: bytes) -> bytes:
        response = self.service.handle(request)
        self.log.append((request, response))
        return response


def _workload(cluster, svc_mod, q, suffix, monkeypatch, seed=3):
    ids = itertools.count(1)
    monkeypatch.setattr(secrets, "token_hex",
                        lambda n: "%0*x" % (2 * n, next(ids)))
    clk = [0.0]
    rec = Recorder(svc_mod.BigsetService(cluster, clock=lambda: clk[0]))
    tight = Recorder(svc_mod.BigsetService(
        cluster, svc_mod.ServiceConfig(byte_budget=1, budget_window=1.0),
        clock=lambda: clk[0]))
    client = svc_mod.BigsetClient(rec)
    rng = np.random.default_rng(seed)
    cluster.register_index(S, suffix(1))

    def tick(dt=0.05):
        clk[0] += dt

    client.stats()
    for base in range(0, 600, 100):
        ops = [["add", b"%08d" % i, b"v%d" % (i % 5)]
               for i in range(base, base + 100)]
        client.batch(S, ops)
        tick()
    client.batch(T, [["add", b"%08d" % i] for i in range(300, 800, 2)])
    for i in rng.choice(600, 12, replace=False):
        client.insert(S, b"%08d" % (1000 + i), value=b"x")
        tick()
    doomed = sorted(int(i) for i in rng.choice(600, 90, replace=False))
    client.batch(S, [["remove", b"%08d" % i] for i in doomed])
    present, ctx = client.membership(S, b"%08d" % 1)
    client.remove(S, b"%08d" % 1, ctx=ctx)
    client.remove(S, b"%08d" % doomed[0])
    tick()
    for plan, r in [
        (q.Scan(S, page_size=64), None),
        (q.Range(S, start=b"00000100", end=b"00000500", limit=45), 3),
        (q.Join("intersect", S, T, limit=70), None),
        (q.Join("difference", S, T, limit=150), 3),
        (q.IndexRange(S, b"element_suffix:1", start=b"2", end=b"6",
                      limit=80), None),
    ]:
        for _page in client.pages(plan, r=r):
            tick()
    client.query(q.Count(S))
    client.query(q.Membership(S, b"%08d" % doomed[-1]), r=3)
    client.query(q.IndexLookup(S, b"element_suffix:1", b"7", limit=5))

    def sleep(seconds):
        clk[0] += seconds

    slow = svc_mod.BigsetClient(tight)
    for n, _page in enumerate(slow.pages(q.Scan(S, page_size=50),
                                         sleep=sleep)):
        if n == 3:
            break
    client.stats()
    client.close()
    slow.close()
    return rec.log + tight.log


def _split_stats(response: bytes):
    """(stats body without kernel gauges, the kernel gauges)."""
    version, status, out = msgpack.unpackb(response)
    node = out["node"]
    gauges = {k[len(KERNEL_GAUGES):]: node.pop(k)["value"]
              for k in list(node) if k.startswith(KERNEL_GAUGES)}
    return (version, status, out), gauges


def test_serve_workload_matches_jax(monkeypatch):
    jc, tc = JCluster(3), TCluster(3, device="cpu")
    jlog = _workload(jc, jsvc, jq, j_suffix, monkeypatch)
    tlog = _workload(tc, tsvc, tq, t_suffix, monkeypatch)
    assert len(tlog) == len(jlog) > 40
    stats = []
    for (jreq, jresp), (treq, tresp) in zip(jlog, tlog):
        assert treq == jreq
        if msgpack.unpackb(jreq)[1] == "stats":
            (jbody, jg), (tbody, tg) = _split_stats(jresp), _split_stats(tresp)
            assert tbody == jbody
            stats.append((jg, tg))
        else:
            assert tresp == jresp
    assert any(b"retry" in r for _q, r in jlog)  # backpressure engaged
    (j0, t0), (j1, t1) = stats
    jd = {k: j1[k] - j0[k] for k in j1}
    td = {k: t1[k] - t0[k] for k in t1}
    assert td["launches"] == jd["launches"] > 0
    assert td["rows"] == jd["rows"]
    assert td["kernel_launches"] == jd["pallas_launches"] == 0
    assert tc.net.bytes_sent == jc.net.bytes_sent > 0


def test_launcher_demo_on_cpu(capsys):
    t_launch.main(["--device", "cpu", "--elements", "3000",
                   "--page-size", "400"])
    out = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith("backpressure engaged") for line in out)
    assert "scanned 3000 elements in 8 pages" in "\n".join(out)
    assert out[-1] == "serve_bigset demo ok"


def test_launcher_rejects_unknown_device():
    with pytest.raises(RuntimeError):
        t_launch.main(["--device", "tpu", "--elements", "10"])
