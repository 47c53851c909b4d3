"""Replicated-cluster layer: vnodes, delta replication, quorums, anti-entropy.

Mirrors the paper's deployment model (§4): N vnodes each store a replica of
each datum, service many clients, act concurrently.  A deterministic,
seedable network simulation delivers messages with optional drop /
duplicate / reorder so convergence properties can be tested exhaustively.

PyTorch port: a copy of :mod:`repro.cluster`; everything below
this docstring is unchanged.
"""
from .sim import DeliveryBudget, Network
from .antientropy import AntiEntropyScheduler, AntiEntropyStats
from .clusters import BigsetCluster, DeltaCluster, RiakSetCluster
from .placement import (CoveragePlan, PreferenceList, Ring, RingDelta,
                        VnodeDown, plan_coverage)

__all__ = [
    "AntiEntropyScheduler",
    "AntiEntropyStats",
    "BigsetCluster",
    "CoveragePlan",
    "DeliveryBudget",
    "DeltaCluster",
    "Network",
    "PreferenceList",
    "RiakSetCluster",
    "Ring",
    "RingDelta",
    "VnodeDown",
    "plan_coverage",
]
