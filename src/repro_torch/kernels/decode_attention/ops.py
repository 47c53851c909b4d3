"""Public decode-attention wrapper, dispatching on the device.

A CPU tensor runs the plain version (:mod:`.ref`); a CUDA tensor launches
the split-KV CUDA kernels (:mod:`.kernel`: one split pass and one combine
pass, in fp32 and bf16 alike) and raises if the build or the launch fails
— there is no fallback.  ``cache_len`` stays on the device: the kernels
read it there, so a decode step needs no host sync and can be captured in
a CUDA graph.

Every call is tallied in :data:`DISPATCHES` (rows = query rows,
``B * Hq``); ``kernel_launches`` counts the calls that launched the CUDA
kernels (:data:`.kernel.LAUNCHES` counts them by the grid the launcher
reported).

On a ``meta`` tensor (the dry run) the wrapper allocates its output and
adds the kernels' FLOPs and bytes (:func:`decode_work`) to
:data:`~repro_torch.kernels.ledger.DRYRUN`.  A DTensor reaches the
kernels through ``local_map``
(:func:`repro_torch.models.sharding.attention_map`): q by ``("batch",
"heads")``, the cache by ``("batch", "kv_heads")`` with its slots whole
(a cache the rules shard by ``kv_seq`` is gathered first: the kernels
take a row's every slot), ``cache_len`` by ``"batch"``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from ..flash_attention.ops import check_attention_inputs
from ..ledger import DRYRUN, DispatchStats
from .kernel import decode_attention_cuda
from .ref import decode_attention_ref

DISPATCHES = DispatchStats()


def decode_work(q: torch.Tensor, k_cache: torch.Tensor, valid: int):
    """(FLOPs, bytes) of one call over ``valid`` cache slots in all (the
    sum over rows): the two products, the valid slots' K and V and q read
    and the output written once, and ``cache_len``."""
    B, Hq, D = q.shape
    esize = q.element_size()
    return (4 * D * Hq * valid,
            (2 * k_cache.shape[1] * valid * D + 2 * q.numel()) * esize + 4 * B)


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
    if isinstance(q, DTensor):
        from ...models.sharding import attention_map
        return attention_map(
            lambda ql, kl, vl, n: decode_attention(ql, kl, vl, n,
                                                   window=window, scale=scale),
            q, k_cache, v_cache, cache_len)
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
    if q.device.type == "meta":
        # a meta cache_len has no values: every slot counts (the dry run's
        # decode cells fill their caches)
        DRYRUN.add(*decode_work(q, k_cache, q.shape[0] * k_cache.shape[2]))
        return torch.empty_like(q)
    out = decode_attention_cuda(q, k_cache, v_cache, cache_len,
                                window=window, scale=float(scale))
    DISPATCHES.kernel_launches += 1
    return out
