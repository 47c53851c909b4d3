"""Secondary indexes over bigset element values, under the CRDT clocks.

The paper's read trade-off is "mitigated by enabling queries on sets"
(§4.4); the query engine alone filters by element *order* only.  This package
adds payload filtering: per-set named indexes whose postings live in the
same ordered keyspace as the element-keys they mirror —

    ``(set, KIND_INDEX, index_name, index_key, element, actor, counter)``

— and under the same set-clock / set-tombstone.  The consistency argument
is one sentence: **a posting is live iff its dot is live.**  Postings are
written in the same atomic batch as their element-key (coordinator and
downstream replica re-derive them from the delta), filtered by the same
batched ``dot_seen`` visibility pass at query time, and discarded by the
same compaction filter in the same pass — so a concurrent remove makes a
posting invisible without any index write, and there is no separate index
GC or index replication.

* :mod:`repro.index.spec`     — :class:`IndexSpec` + standard extractors;
* :mod:`repro.index.postings` — posting key codec and range bounds.

Query plans (`IndexLookup` / `IndexRange`) live in :mod:`repro.query.plan`;
the quorum-merged cluster path in
:meth:`repro.cluster.clusters.BigsetCluster.query`.

PyTorch port: a copy of :mod:`repro.index`; everything below
this docstring is unchanged.
"""
from .postings import (decode_posting_key, index_bounds, index_range,
                       lookup_span, posting_key)
from .spec import (IndexSpec, by_element_prefix, by_element_suffix, by_field,
                   by_length, by_value, by_value_prefix)

__all__ = [
    "IndexSpec", "by_element_prefix", "by_element_suffix", "by_field",
    "by_length", "by_value", "by_value_prefix",
    "decode_posting_key", "index_bounds", "index_range", "lookup_span",
    "posting_key",
]
