from .ops import DISPATCHES, intersect, join, popcount, subtract
from .kernel import clock_merge_cuda, clock_popcount_cuda
from .ref import intersect_ref, join_ref, popcount_ref, subtract_ref

__all__ = ["DISPATCHES", "clock_merge_cuda", "clock_popcount_cuda",
           "intersect", "intersect_ref", "join", "join_ref", "popcount",
           "popcount_ref", "subtract", "subtract_ref"]
