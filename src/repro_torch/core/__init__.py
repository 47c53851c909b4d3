"""Core CRDT library - the paper's primary contribution.

* :mod:`repro.core.clock` - BaseVV + DotCloud logical clocks (paper 4.1)
* :mod:`repro.core.orswot` - state-based ORSWOT (Riak Sets baseline, paper 2)
* :mod:`repro.core.delta_orswot` - delta-replication baseline (paper 3)
* :mod:`repro.core.bigset` - the decomposed bigset (paper 4, Algorithms 1 & 2)
* :mod:`repro.core.streaming` - streaming ORSWOT join / quorum reads (paper 4.4)
* :mod:`repro.core.vclock` - dense JAX clock arrays backing the Pallas
  dot-seen / clock-join kernels used by the framework's checkpoint and
  membership planes

PyTorch port: a copy of :mod:`repro.core`; everything below
this docstring is unchanged.
"""
from .clock import Clock
from .dots import Dot
from .orswot import Orswot
from .bigset import BigsetVnode, InsertDelta, RemoveDelta

__all__ = ["Clock", "Dot", "Orswot", "BigsetVnode", "InsertDelta", "RemoveDelta"]
