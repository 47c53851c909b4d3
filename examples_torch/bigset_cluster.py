"""Partition/heal demo: bigset under an adversarial network, on the
PyTorch port.

Two "sides" of a partitioned 4-replica cluster take writes independently
(including a remove of an element the other side concurrently re-adds),
then heal via anti-entropy — all replicas converge, add-wins.  Client
traffic (writes, membership with causal context, the final scan) goes
through the serve layer's wire protocol.  The cluster's queries filter
visibility on ``--device`` (default ``cuda``; ``cpu`` runs the plain
versions).

Run:  PYTHONPATH=src python examples_torch/bigset_cluster.py [--device cpu]

The port's copy of ``examples/bigset_cluster.py``: the same calls and the
same printed lines.
"""
import argparse

from repro_torch.cluster.antientropy import sync
from repro_torch.cluster.clusters import BigsetCluster
from repro_torch.cluster.sim import Network
from repro_torch.device import resolve_device
from repro_torch.query.plan import Scan
from repro_torch.serve.bigset_service import BigsetClient, BigsetService

S = b"cart"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the cluster's queries run: cuda or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    net = Network(seed=7, drop_prob=0.0)
    big = BigsetCluster(4, net=net, sync=False,  # manual delivery
                        device=device)
    client = BigsetClient(BigsetService(big))

    client.insert(S, b"book")
    big.settle()
    print("before partition:", sorted(big.value(S, r=4)))

    # ---- partition: {0,1} | {2,3}; deltas between sides are dropped ------
    big.net.drop_prob = 1.0  # total partition (simplified: drop everything)
    # side A reads book's causal context (r=1: only its own side answers),
    # then removes exactly what it observed
    _, ctx = client.membership(S, b"book", r=1)
    client.remove(S, b"book", ctx=ctx)          # side A removes the book
    big.add(S, b"book", 2)                      # side B re-adds concurrently
    big.add(S, b"pen", 3)
    big.net.queue.clear()
    big.net.drop_prob = 0.0

    print("side A view:", sorted(big.vnodes[big.actors[0]].value(S)))
    print("side B view:", sorted(big.vnodes[big.actors[2]].value(S)))

    # ---- heal: ring anti-entropy ------------------------------------------
    vns = [big.vnodes[a] for a in big.actors]
    for _ in range(2):
        for i in range(4):
            sync(vns[i], vns[(i + 1) % 4], S)

    views = [sorted(vn.value(S)) for vn in vns]
    print("after heal:", views[0])
    assert all(v == views[0] for v in views), "replicas diverged!"
    assert b"book" in set(views[0]), "add-wins violated"
    print("converged; concurrent re-add beat the remove (add-wins) ✓")

    # the healed set, served: a paginated scan over the full quorum
    members = [el for page in client.pages(Scan(S, page_size=1), r=4)
               for el in page.members]
    assert members == views[0], (members, views[0])
    print("served scan agrees with every replica ✓")

    # storage hygiene after churn
    for vn in vns:
        vn.compact()
    print("tombstones after compaction:",
          [str(vn.read_tombstone(S)) for vn in vns])


if __name__ == "__main__":
    main()
