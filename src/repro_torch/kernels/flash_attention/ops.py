"""Public prefill-attention wrapper, dispatching on the device.

A CPU tensor runs the plain version (:mod:`.ref`); a CUDA tensor launches
the CUDA kernel (:mod:`.kernel`) and raises if the build or the launch
fails — there is no fallback.  The JAX package runs its jnp reference
unless a caller passes ``use_pallas=True``; the port has no such switch:
on the card, every call is the kernel.

Every call is tallied in :data:`DISPATCHES` (rows = query rows,
``B * Hq * T``); ``kernel_launches`` counts the calls that launched a CUDA
kernel, and :data:`ROUTE_LAUNCHES` splits them by route (``"tc"``,
``"simt"``; see :func:`.kernel.flash_route`).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ledger import DispatchStats
from .kernel import DTYPE_CODES, ROUTES, flash_attention_cuda, flash_route
from .ref import attention_ref

DISPATCHES = DispatchStats()
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)


def check_attention_inputs(name: str, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, window: Optional[int]) -> None:
    """Types, shapes, contiguity and device of q ``[B, Hq, .., D]`` against
    k / v ``[B, Hkv, S, D]``; on a CUDA tensor, what the kernels take."""
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {nm} must be a torch.Tensor")
        if t.dtype not in DTYPE_CODES:
            raise TypeError(
                f"{name}: {nm} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {nm} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name}: {nm} is on {t.device}, q on {q.device}")
    if k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: k/v must share one [B, Hkv, S, D] shape")
    B, Hkv, S, D = k.shape
    if q.shape[0] != B or q.shape[-1] != D:
        raise ValueError(
            f"{name}: q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    Hq = q.shape[1]
    if Hkv == 0 or Hq % Hkv != 0:
        raise ValueError(f"GQA requires Hq % Hkv == 0, got {Hq} % {Hkv}")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1 or None, got {window}")
    if q.device.type == "cuda":
        if D % 8 != 0 or not 8 <= D <= 256:
            raise ValueError(
                f"{name}: the CUDA kernel takes head dims 8..256 in steps of "
                f"8, got {D}")
        for nm, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: {nm} must be 16-byte aligned")
        if max(q.numel(), k.numel()) >= 2**31:
            raise ValueError(f"{name}: sizes must fit int32 indexing")
    elif q.device.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {q.device}")


def flash_attention(
    q: torch.Tensor,          # [B, Hq, T, D]
    k: torch.Tensor,          # [B, Hkv, S, D]
    v: torch.Tensor,          # [B, Hkv, S, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:            # [B, Hq, T, D]
    """Attention of T queries at the tail of an S-long context."""
    if q.dim() != 4:
        raise ValueError("flash_attention: q must be [B, Hq, T, D]")
    check_attention_inputs("flash_attention", q, k, v, window)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    B, Hq, T, _ = q.shape
    DISPATCHES.launches += 1
    DISPATCHES.rows += B * Hq * T
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               scale=float(scale))
    DISPATCHES.kernel_launches += 1
    ROUTE_LAUNCHES[flash_route(q.dtype, q.shape[-1])] += 1
    return out
