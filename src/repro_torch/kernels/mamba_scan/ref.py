"""Plain PyTorch version of the Mamba-1 selective scan.

Recurrence (per batch, channel d, state n):
    h_t = exp(Δ_t · A[d,n]) · h_{t-1} + Δ_t · B_t[n] · x_t[d]
    y_t = Σ_n C_t[n] · h_t[d,n] + D[d] · x_t[d]

Mirrors the JAX package's ``mamba_scan_ref`` (a ``lax.scan`` over time) as
a Python loop over T: exact, O(T) sequential, state in fp32, ``y`` cast to
``x``'s dtype; it returns the final state so decode can continue the
recurrence.  The wrapper runs it for tensors on the CPU, and the CUDA
kernel is held against it on the card.

:func:`mamba_scan_bwd_ref` is the plain version of the scan's gradient
(the CUDA kernel ``csrc/mamba_scan_bwd.cu``): with ``a_t = exp(Δ_t A)``
and ``g_t = dy_t ⊗ C_t + a_{t+1} ⊙ g_{t+1}`` (the gradient reaching
``h_t``), an explicit reverse-time recurrence in fp32.  The JAX package
differentiates its ``lax.scan`` instead; both give the same sums.
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


def mamba_scan_bwd_ref(
    x: torch.Tensor,      # [B, T, D]
    delta: torch.Tensor,  # [B, T, D]
    A: torch.Tensor,      # [D, N]  fp32
    Bm: torch.Tensor,     # [B, T, N]
    Cm: torch.Tensor,     # [B, T, N]
    D: torch.Tensor,      # [D]     fp32
    dy: torch.Tensor,     # [B, T, D]  gradient of y
) -> Tuple[torch.Tensor, ...]:
    """``(dx, ddelta, dA, dBm, dCm, dD)`` of ``y`` of :func:`mamba_scan_ref`
    from a zero state (``h_T`` takes no gradient).  Each gradient comes
    back in its input's type; the sums are fp32:

        dC_t[n]  = Σ_d dy_t[d] h_t[d,n]
        dB_t[n]  = Σ_d g_t[d,n] Δ_t[d] x_t[d]
        dx_t[d]  = Σ_n g_t[d,n] Δ_t[d] B_t[n] + D[d] dy_t[d]
        dΔ_t[d]  = Σ_n g_t[d,n] (x_t[d] B_t[n] + A[d,n] a_t[d,n] h_{t-1}[d,n])
        dA[d,n]  = Σ_{b,t} g_t[d,n] Δ_t[d] a_t[d,n] h_{t-1}[d,n]
        dD[d]    = Σ_{b,t} dy_t[d] x_t[d]
    """
    Bsz, T, Dm = x.shape
    N = A.shape[1]
    xf, df, Af, Bf, Cf, dyf = (t.float() for t in (x, delta, A, Bm, Cm, dy))
    dev = x.device
    # the forward's states h_0 .. h_{T-1}, each [B, D, N]
    hs = []
    h = torch.zeros((Bsz, Dm, N), dtype=torch.float32, device=dev)
    for t in range(T):
        a = torch.exp(df[:, t, :, None] * Af)
        h = a * h + (df[:, t] * xf[:, t])[:, :, None] * Bf[:, t, None, :]
        hs.append(h)
    dx = torch.empty((Bsz, T, Dm), dtype=torch.float32, device=dev)
    ddelta = torch.empty_like(dx)
    dBm = torch.empty((Bsz, T, N), dtype=torch.float32, device=dev)
    dCm = torch.empty_like(dBm)
    dA = torch.zeros((Dm, N), dtype=torch.float32, device=dev)
    g = torch.zeros((Bsz, Dm, N), dtype=torch.float32, device=dev)
    a_next = None
    for t in reversed(range(T)):
        a = torch.exp(df[:, t, :, None] * Af)                  # a_t
        g = dyf[:, t, :, None] * Cf[:, t, None, :] + (
            a_next * g if a_next is not None else 0.0)
        h_prev = hs[t - 1] if t > 0 else torch.zeros_like(g)
        dCm[:, t] = (dyf[:, t, :, None] * hs[t]).sum(1)
        dBm[:, t] = (g * (df[:, t] * xf[:, t])[:, :, None]).sum(1)
        gB = (g * Bf[:, t, None, :]).sum(-1)                   # [B, D]
        dx[:, t] = gB * df[:, t] + D.float() * dyf[:, t]
        gah = g * a * h_prev
        ddelta[:, t] = gB * xf[:, t] + (gah * Af).sum(-1)
        dA += (gah * df[:, t, :, None]).sum(0)
        a_next = a
    dD = (dyf * xf).sum((0, 1))
    return (dx.to(x.dtype), ddelta.to(delta.dtype), dA.to(A.dtype),
            dBm.to(Bm.dtype), dCm.to(Cm.dtype), dD.to(D.dtype))


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
