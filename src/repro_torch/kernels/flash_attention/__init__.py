from .ops import DISPATCHES, flash_attention
from .kernel import flash_attention_cuda
from .ref import attention_ref

__all__ = ["DISPATCHES", "attention_ref", "flash_attention",
           "flash_attention_cuda"]
