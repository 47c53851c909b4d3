"""Public prefill-attention wrapper, dispatching on the device.

A CPU tensor runs the plain version (:mod:`.ref`); a CUDA tensor launches
the CUDA kernel (:mod:`.kernel`) and raises if the build or the launch
fails — there is no fallback.  The JAX package runs its jnp reference
unless a caller passes ``use_pallas=True``; the port has no such switch:
on the card, every call is the kernel.

Under autograd (grad enabled and an input that requires grad) a call goes
through :class:`FlashAttentionFunction`: its forward is the same launch
with each row's log-sum-exp written beside the output, its backward
:func:`flash_attention_bwd` — the CUDA backward kernel on the card, the
plain :func:`.ref.attention_bwd_ref` on the CPU.  The Function keeps only
its saved tensors (q, k, v, the output and lse), so a recompute under
``torch.utils.checkpoint`` runs the forward again, and is counted again.

Every forward call is tallied in :data:`DISPATCHES` (rows = query rows,
``B * Hq * T``); ``kernel_launches`` counts the calls that launched a CUDA
kernel, and :data:`ROUTE_LAUNCHES` splits them by route (``"tc"``,
``"simt"``; see :func:`.kernel.flash_route`).  :data:`BWD_DISPATCHES`
tallies the backward calls likewise; one call is three kernel launches
(delta, dK / dV, dQ) and counts once, and :data:`BWD_ROUTE_LAUNCHES`
splits the launched calls by the backward's route
(:func:`.kernel.flash_bwd_route`).

On a ``meta`` tensor (the dry run) nothing is computed: the wrapper
allocates its outputs on ``meta`` and adds the kernel's FLOPs and bytes
(:func:`flash_work`) to :data:`~repro_torch.kernels.ledger.DRYRUN`.  A
:class:`~torch.distributed.tensor.DTensor` reaches the kernel through
``local_map`` (:func:`repro_torch.models.sharding.attention_map`): q by
``("batch", "heads")``, k and v by ``("batch", "kv_heads")`` under the
installed rules, each rank running the kernel on its shard.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from ..ledger import DRYRUN, DispatchStats
from .kernel import (DTYPE_CODES, ROUTES, flash_attention_bwd_cuda,
                     flash_attention_cuda, flash_bwd_route, flash_route)
from .ref import attention_bwd_ref, attention_lse_ref, attention_ref

DISPATCHES = DispatchStats()
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
BWD_DISPATCHES = DispatchStats()
BWD_ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)


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
    elif q.device.type == "meta":
        # what the kernel takes, checked on the shapes the card would see
        if D % 8 != 0 or not 8 <= D <= 256:
            raise ValueError(
                f"{name}: the CUDA kernel takes head dims 8..256 in steps of "
                f"8, got {D}")
        if max(q.numel(), k.numel()) >= 2**31:
            raise ValueError(f"{name}: sizes must fit int32 indexing")
    elif q.device.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {q.device}")


def visible_pairs(T: int, S: int, window: Optional[int],
                  causal: bool = True) -> int:
    """(query, key) pairs a prefill computes, T queries at the tail of S
    keys."""
    if not causal and window is None:
        return T * S
    qpos = torch.arange(T, dtype=torch.int64) + (S - T)
    hi = torch.clamp(qpos + 1, max=S) if causal else torch.full_like(qpos, S)
    lo = (torch.clamp(qpos - window + 1, min=0) if window
          else torch.zeros_like(qpos))
    return int(torch.clamp(hi - lo, min=0).sum())


def flash_work(q: torch.Tensor, k: torch.Tensor, causal: bool,
               window: Optional[int], *, bwd: bool = False,
               with_lse: bool = False):
    """(FLOPs, bytes) of one launch: the forward's two products of the
    visible pairs and q, k, v read and o written once (and the lse); the
    backward's five products, q, k, v, o, dO and lse read and dq, dk, dv
    written once."""
    B, Hq, T, D = q.shape
    pairs = visible_pairs(T, k.shape[2], window, causal)
    esize = q.element_size()
    if bwd:
        return (10 * D * pairs * Hq * B,
                (4 * q.numel() + 4 * k.numel()) * esize + 4 * B * Hq * T)
    nbytes = (2 * q.numel() + 2 * k.numel()) * esize
    return 4 * D * pairs * Hq * B, nbytes + (4 * B * Hq * T if with_lse else 0)


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
    if isinstance(q, DTensor):
        from ...models.sharding import attention_map
        return attention_map(
            lambda ql, kl, vl: flash_attention(ql, kl, vl, causal=causal,
                                               window=window, scale=scale),
            q, k, v)
    check_attention_inputs("flash_attention", q, k, v, window)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, causal, window,
                                            float(scale))
    return _forward(q, k, v, causal, window, scale, with_lse=False)[0]


def _forward(q, k, v, causal: bool, window: Optional[int], scale: float,
             *, with_lse: bool):
    """(output, lse or None): the plain version on the CPU, the kernel on
    the card, tallied in :data:`DISPATCHES`."""
    B, Hq, T, _ = q.shape
    DISPATCHES.launches += 1
    DISPATCHES.rows += B * Hq * T
    if q.device.type == "cpu":
        out = attention_ref(q, k, v, causal=causal, window=window,
                            scale=scale)
        lse = (attention_lse_ref(q, k, causal=causal, window=window,
                                 scale=scale) if with_lse else None)
        return out, lse
    lse = (torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.device.type == "meta":
        DRYRUN.add(*flash_work(q, k, causal, window, with_lse=with_lse))
        return torch.empty_like(q), lse
    out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                               scale=float(scale), lse=lse)
    DISPATCHES.kernel_launches += 1
    ROUTE_LAUNCHES[flash_route(q.dtype, q.shape[-1])] += 1
    return out, lse


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    dout: torch.Tensor, lse: torch.Tensor, *, causal: bool = True,
    window: Optional[int] = None, scale: Optional[float] = None,
):
    """``(dq, dk, dv)`` of :func:`flash_attention` at ``(q, k, v)``, whose
    output was ``o`` with row log-sum-exps ``lse`` (fp32 ``[B, Hq, T]``),
    against the output's gradient ``dout``."""
    check_attention_inputs("flash_attention_bwd", q, k, v, window)
    for nm, t in (("o", o), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(
                f"flash_attention_bwd: {nm} must be a contiguous "
                f"{tuple(q.shape)} {q.dtype} tensor on {q.device}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(
            "flash_attention_bwd: lse must be a contiguous fp32 "
            f"{tuple(q.shape[:3])} tensor on {q.device}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    B, Hq, T, _ = q.shape
    BWD_DISPATCHES.launches += 1
    BWD_DISPATCHES.rows += B * Hq * T
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, dout, lse, causal=causal,
                                 window=window, scale=scale)
    if q.device.type == "meta":
        DRYRUN.add(*flash_work(q, k, causal, window, bwd=True))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    grads = flash_attention_bwd_cuda(q, k, v, o, dout, lse, causal=causal,
                                     window=window, scale=float(scale))
    BWD_DISPATCHES.kernel_launches += 1
    BWD_ROUTE_LAUNCHES[flash_bwd_route(q.dtype)] += 1
    return grads


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable :func:`flash_attention`: the forward kernel (with
    lse) and the backward kernel on the card, their plain versions on the
    CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = _forward(q, k, v, causal, window, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attn = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.attn
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, dout.contiguous(), lse, causal=causal,
            window=window, scale=scale)
        return dq, dk, dv, None, None, None
