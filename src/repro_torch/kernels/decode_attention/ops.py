"""Public decode-attention wrapper, dispatching on the device.

A CPU tensor runs the plain version (:mod:`.ref`); a CUDA tensor launches
the split-KV CUDA kernels (:mod:`.kernel`: one split pass and one combine
pass, in fp32 and bf16 alike) and raises if the build or the launch fails
— there is no fallback.  ``cache_len`` stays on the device: the kernels
read it there, so a decode step needs no host sync and can be captured in
a CUDA graph.

Every call is tallied in :data:`DISPATCHES` (rows = query rows,
``B * Hq``); ``kernel_launches`` counts the calls that launched the CUDA
kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..flash_attention.ops import check_attention_inputs
from ..ledger import DispatchStats
from .kernel import decode_attention_cuda
from .ref import decode_attention_ref

DISPATCHES = DispatchStats()


def decode_attention(
    q: torch.Tensor,          # [B, Hq, D]
    k_cache: torch.Tensor,    # [B, Hkv, S, D]
    v_cache: torch.Tensor,    # [B, Hkv, S, D]
    cache_len: torch.Tensor,  # int32[B]
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:            # [B, Hq, D]
    """Attention of one new token per row against its cache prefix."""
    if q.dim() != 3:
        raise ValueError("decode_attention: q must be [B, Hq, D]")
    check_attention_inputs("decode_attention", q, k_cache, v_cache, window)
    if not isinstance(cache_len, torch.Tensor) or cache_len.dtype != torch.int32:
        raise TypeError("decode_attention: cache_len must be an int32 tensor")
    if cache_len.shape != (q.shape[0],) or not cache_len.is_contiguous():
        raise ValueError(
            "decode_attention: cache_len must be a contiguous int32[B]")
    if cache_len.device != q.device:
        raise ValueError(
            f"decode_attention: cache_len is on {cache_len.device}, "
            f"q on {q.device}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    DISPATCHES.launches += 1
    DISPATCHES.rows += q.shape[0] * q.shape[1]
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, cache_len,
                                    window=window, scale=scale)
    out = decode_attention_cuda(q, k_cache, v_cache, cache_len,
                                window=window, scale=float(scale))
    DISPATCHES.kernel_launches += 1
    return out
