"""Quickstart: the bigset CRDT public API in 60 lines, on the PyTorch port.

Writes and queries go through the serve layer (the wire protocol a remote
client would speak); the cluster/vnode internals appear only where the
paper's cost claims are being shown off.  The cluster's queries filter
visibility on ``--device``: ``cuda`` (the default: the ``dot_seen`` CUDA
kernel) or ``cpu`` (its plain PyTorch version).

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

The port's copy of ``examples/quickstart.py``: the same calls and the same
printed lines.
"""
import argparse

from repro_torch.cluster.antientropy import sync
from repro_torch.cluster.clusters import BigsetCluster, RiakSetCluster
from repro_torch.core.bigset import BigsetVnode
from repro_torch.device import resolve_device
from repro_torch.query.plan import Range
from repro_torch.serve.bigset_service import BigsetClient, BigsetService

S = b"fruits"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the cluster's queries run: cuda or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    # --- a 3-replica bigset cluster behind the query service --------------
    big = BigsetCluster(3, device=device)
    client = BigsetClient(BigsetService(big))
    client.batch(S, [["add", f]
                     for f in (b"apple", b"banana", b"cherry", b"durian")])

    # observed-remove: read the causal context, hand it back (§4.3.2)
    present, ctx = client.membership(S, b"durian")
    assert present
    client.remove(S, b"durian", ctx=ctx)
    print("value (quorum r=2):", sorted(big.value(S, r=2)))

    # membership / range queries without reading the whole set (§4.4)
    print("is_member(banana):", client.membership(S, b"banana")[0])
    print("range from 'b', 2:",
          client.query(Range(S, start=b"b", limit=2)).members)

    # write cost is causal-metadata-sized, not set-sized (§4.3)
    vn = big.vnodes[big.actors[0]]
    before = vn.store.stats.snapshot()
    client.insert(S, b"elderberry")
    d = vn.store.stats.delta(before)
    print(f"one insert cost: read {d.bytes_read}B, wrote {d.bytes_written}B")

    # --- compaction shrinks the tombstone (§4.3.3) ------------------------
    big.compact_all()
    print("tombstone after compaction:", vn.read_tombstone(S))

    # --- equivalence with Riak Sets (§5) ----------------------------------
    riak = RiakSetCluster(3)
    for fruit in (b"apple", b"banana", b"cherry"):
        riak.add(S, fruit)
    assert riak.value(S, r=3) == big.value(S, r=3) - {b"elderberry"}
    print("semantically equivalent to Riak ORSWOT sets ✓")

    # --- divergent replicas converge via anti-entropy ---------------------
    a, b = BigsetVnode("a"), BigsetVnode("b")
    a.coordinate_insert(S, b"kiwi")
    b.coordinate_insert(S, b"lime")
    sync(a, b, S)
    assert a.value(S) == b.value(S) == {b"kiwi", b"lime"}
    print("anti-entropy convergence ✓")


if __name__ == "__main__":
    main()
