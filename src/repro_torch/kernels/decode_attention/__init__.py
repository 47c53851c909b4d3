from .ops import DISPATCHES, decode_attention, decode_work
from .kernel import LAUNCHES, decode_attention_cuda, launches_by_group
from .ref import decode_attention_ref

__all__ = ["DISPATCHES", "LAUNCHES", "decode_attention",
           "decode_attention_cuda", "decode_attention_ref", "decode_work",
           "launches_by_group"]
