"""Bigset query engine (paper §4.4).

The paper's decomposition trade-off — writes become O(causal metadata) but a
full read must stream every element-key — is "mitigated by enabling queries
on sets": because element-keys live in one lexicographically ordered range,
membership is a seek, range scans touch only their result, and cross-set
joins are ordered-stream zippers.  This package is that query layer:

* :mod:`repro.query.plan`     — logical plans (membership / range / count /
  paginated scan / cross-set streaming joins / secondary-index lookups and
  ranges over :mod:`repro.index` postings);
* :mod:`repro.query.cursor`   — opaque resumable pagination tokens;
* :mod:`repro.query.batch`    — vectorised dot-visibility filtering that
  dispatches the ``kernels/dot_seen`` Pallas kernel over dense
  ``(actors, counters)`` batches instead of per-dot Python checks;
* :mod:`repro.query.executor` — the streaming executor: bounded-memory folds
  over LSM seeks, with per-query :class:`~repro.storage.lsm.IoStats`;
* :mod:`repro.query.planner`  — cost-based join planning: zipper vs
  seek-gallop, chosen from LSM run statistics
  (:meth:`repro.storage.lsm.LsmStore.range_stats`), surfaced in
  :attr:`~repro.query.executor.QueryStats.strategy`.

Cluster-level scatter/gather with quorum merge and read-repair lives in
:meth:`repro.cluster.clusters.BigsetCluster.query`.

PyTorch port: a copy of :mod:`repro.query`; everything below
this docstring is unchanged.
"""
from .cursor import (CursorError, LeaseError, decode_cursor, encode_cursor,
                     unwrap_lease, wrap_lease)
from .executor import (QueryExecutor, QueryResult, QueryStats, gallop_join,
                       zipper_join)
from .plan import (Count, IndexLookup, IndexRange, Join, Membership, Plan,
                   PlanError, Range, Scan, plan_from_wire, plan_to_wire,
                   validate)
from .planner import (GALLOP, ZIPPER, JoinChoice, SideStats, choose_join,
                      quorum_side_stats, side_stats)

__all__ = [
    "Count", "CursorError", "GALLOP", "IndexLookup", "IndexRange", "Join",
    "JoinChoice", "LeaseError", "Membership", "Plan", "PlanError",
    "QueryExecutor", "QueryResult", "QueryStats", "Range", "Scan",
    "SideStats", "ZIPPER", "choose_join", "decode_cursor", "encode_cursor",
    "gallop_join", "plan_from_wire", "plan_to_wire", "quorum_side_stats",
    "side_stats", "unwrap_lease", "validate", "wrap_lease", "zipper_join",
]
