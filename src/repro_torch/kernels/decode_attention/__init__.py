from .ops import DISPATCHES, decode_attention, decode_work
from .kernel import decode_attention_cuda
from .ref import decode_attention_ref

__all__ = ["DISPATCHES", "decode_attention", "decode_attention_cuda",
           "decode_attention_ref", "decode_work"]
