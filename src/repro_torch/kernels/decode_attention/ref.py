"""Plain PyTorch version of single-token decode attention over a KV cache.

Mirrors the JAX package's ``decode_attention_ref``: fp32 scores and
softmax over the slots ``pos < cache_len`` (and ``pos >= cache_len -
window``).  As there, a row with no valid slot softmaxes a row of equal
``NEG_INF`` and averages every slot, where the CUDA kernel (like the Pallas
kernel) gives 0; the serve path always has a valid slot.  The wrapper runs
it for tensors on the CPU, and the CUDA kernel is held against it on the
card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(
    q: torch.Tensor,          # [B, Hq, D]      (one new token per sequence)
    k_cache: torch.Tensor,    # [B, Hkv, S, D]
    v_cache: torch.Tensor,    # [B, Hkv, S, D]
    cache_len: torch.Tensor,  # int32[B]        (valid prefix length per seq)
    *,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:            # [B, Hq, D]
    B, Hq, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    group = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    kq = torch.repeat_interleave(k_cache, group, dim=1)
    vq = torch.repeat_interleave(v_cache, group, dim=1)
    logits = torch.einsum("bhd,bhsd->bhs", q.float(), kq.float()) * scale
    pos = torch.arange(S, device=q.device)[None, :]            # [1, S]
    valid = pos < cache_len[:, None]                           # [B, S]
    if window is not None:
        valid &= pos >= (cache_len[:, None] - window)
    logits = torch.where(valid[:, None, :], logits,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhs,bhsd->bhd", probs, vq.float())
    return out.to(q.dtype)
