"""Plain PyTorch version of the Mamba-1 selective scan.

Recurrence (per batch, channel d, state n):
    h_t = exp(Δ_t · A[d,n]) · h_{t-1} + Δ_t · B_t[n] · x_t[d]
    y_t = Σ_n C_t[n] · h_t[d,n] + D[d] · x_t[d]

Mirrors the JAX package's ``mamba_scan_ref`` (a ``lax.scan`` over time) as
a Python loop over T: exact, O(T) sequential, state in fp32, ``y`` cast to
``x``'s dtype; it returns the final state so decode can continue the
recurrence.  The wrapper runs it for tensors on the CPU, and the CUDA
kernel is held against it on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def mamba_scan_ref(
    x: torch.Tensor,        # [B, T, D]    (post-conv activations)
    delta: torch.Tensor,    # [B, T, D]    (softplus-ed step sizes)
    A: torch.Tensor,        # [D, N]       (negative; log-spaced init)
    Bm: torch.Tensor,       # [B, T, N]
    Cm: torch.Tensor,       # [B, T, N]
    D: torch.Tensor,        # [D]
    h0: Optional[torch.Tensor] = None,  # [B, D, N]
) -> Tuple[torch.Tensor, torch.Tensor]:  # y [B,T,D], h_T [B,D,N]
    Bsz, T, Dm = x.shape
    N = A.shape[1]
    xf, df, Af, Bf, Cf = (t.float() for t in (x, delta, A, Bm, Cm))
    if h0 is None:
        h = torch.zeros((Bsz, Dm, N), dtype=torch.float32, device=x.device)
    else:
        h = h0.float()
    ys = torch.empty((Bsz, T, Dm), dtype=torch.float32, device=x.device)
    for t in range(T):
        a = torch.exp(df[:, t, :, None] * Af)                  # [B, D, N]
        h = a * h + (df[:, t] * xf[:, t])[:, :, None] * Bf[:, t, None, :]
        ys[:, t] = (h * Cf[:, t, None, :]).sum(-1)             # [B, D]
    y = ys + xf * D.float()[None, None, :]
    return y.to(x.dtype), h


def mamba_step_ref(
    x: torch.Tensor,      # [B, D]  one token
    delta: torch.Tensor,  # [B, D]
    A: torch.Tensor,      # [D, N]
    Bm: torch.Tensor,     # [B, N]
    Cm: torch.Tensor,     # [B, N]
    D: torch.Tensor,      # [D]
    h: torch.Tensor,      # [B, D, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    a = torch.exp(delta[..., None] * A[None])             # [B, D, N]
    h = a * h.float() + (delta * x)[..., None] * Bm[:, None, :]
    y = (h * Cm[:, None, :]).sum(-1) + x * D[None]
    return y.to(x.dtype), h
