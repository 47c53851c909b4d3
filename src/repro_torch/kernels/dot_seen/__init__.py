from .ops import DISPATCHES, DispatchStats, dot_seen
from .kernel import dot_seen_cuda
from .ref import dot_seen_ref

__all__ = ["DISPATCHES", "DispatchStats", "dot_seen", "dot_seen_cuda",
           "dot_seen_ref"]
