from .ops import (BWD_DISPATCHES, BWD_ROUTE_LAUNCHES, DISPATCHES,
                  ROUTE_LAUNCHES, FlashAttentionFunction, flash_attention,
                  flash_attention_bwd, flash_work, visible_pairs)
from .kernel import (flash_attention_bwd_cuda, flash_attention_cuda,
                     flash_bwd_route, flash_route)
from .ref import attention_bwd_ref, attention_lse_ref, attention_ref

__all__ = ["BWD_DISPATCHES", "BWD_ROUTE_LAUNCHES", "DISPATCHES",
           "ROUTE_LAUNCHES", "FlashAttentionFunction", "attention_bwd_ref",
           "attention_lse_ref", "attention_ref", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_cuda",
           "flash_attention_cuda", "flash_bwd_route", "flash_route",
           "flash_work", "visible_pairs"]
