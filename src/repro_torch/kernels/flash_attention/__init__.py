from .ops import DISPATCHES, ROUTE_LAUNCHES, flash_attention
from .kernel import flash_attention_cuda, flash_route
from .ref import attention_ref

__all__ = ["DISPATCHES", "ROUTE_LAUNCHES", "attention_ref", "flash_attention",
           "flash_attention_cuda", "flash_route"]
