"""Plain fp32 pieces shared by the references: products in a stated
precision, the RMS norm, rotary positions, the chunked selective scan and
the cross-entropy.  No kernel, cache or batching of the program; nothing
here imports it.

``prec`` is ``"fp32"`` (the reference) or ``"fp8"`` (the control: each
product's operands rounded to float8 e4m3 with one scale per row of the
left operand and per column of the right one, then multiplied in fp32; the
rounding passes the gradient straight through).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

F8_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """fp32 products without TF32, for the reference's whole run."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def to_f8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to e4m3 with one scale per slice along ``dim``
    (values, in fp32; the gradient passes straight through)."""
    amax = torch.amax(x.detach().abs(), dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-30) / F8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def mm(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """``x @ w``; ``w`` is ``[..., K, N]``."""
    if prec == "fp8":
        return to_f8(x, -1) @ to_f8(w, -2)
    return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + scale)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions over the two halves of the head dim.  ``x``
    ``[B, T, H, Dh]``, ``pos`` ``[T]``."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = pos.float()[:, None] * freq                  # [T, half]
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def scan_block(u, delta, A, Bm, Cm, chunk: int = 64) -> torch.Tensor:
    """``sum_n C_t[n] h_t[d, n]`` of ``h_t = exp(delta_t A) h_{t-1} +
    delta_t u_t B_t`` from a zero state, for a block of channels.  ``u``,
    ``delta`` ``[B, T, Dc]``, ``A`` ``[Dc, N]``, ``Bm``, ``Cm`` ``[B, T,
    N]``, all fp32.

    Exact in fp32 and in two levels: each chunk of ``chunk`` steps is
    scanned from a zero state (all chunks at once, step by step), with the
    running product of its decays; then the state carried into each chunk
    is scanned over the chunks, and each step adds its product times that
    carry.  No division and no log: a decay that underflows gives 0."""
    Bsz, T, Dc = u.shape
    N = A.shape[1]
    pad = (-T) % chunk
    if pad:
        # a step of delta 0 decays nothing and adds nothing
        u, delta = F.pad(u, (0, 0, 0, pad)), F.pad(delta, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    nC = (T + pad) // chunk
    a = torch.exp(delta[..., None] * A)                       # [B, T', Dc, N]
    b = (delta * u)[..., None] * Bm[:, :, None, :]
    # unbind, not indexing: under autograd a slice's backward writes a
    # whole zero tensor per slice, unbind's one stack for all of them
    a_j = a.view(Bsz, nC, chunk, Dc, N).unbind(2)
    b_j = b.view(Bsz, nC, chunk, Dc, N).unbind(2)
    hs, ps = [b_j[0]], [a_j[0]]
    for j in range(1, chunk):
        hs.append(a_j[j] * hs[-1] + b_j[j])
        ps.append(ps[-1] * a_j[j])
    h_loc = torch.stack(hs, dim=2)                            # [B, nC, L, Dc, N]
    prod = torch.stack(ps, dim=2)
    h_end, p_end = hs[-1].unbind(1), ps[-1].unbind(1)
    carry = [torch.zeros_like(h_end[0])]
    for c in range(nC - 1):
        carry.append(p_end[c] * carry[-1] + h_end[c])
    carry = torch.stack(carry, dim=1)                         # [B, nC, Dc, N]
    h = h_loc + prod * carry[:, :, None]
    y = (h * Cm.view(Bsz, nC, chunk, 1, N)).sum(-1)           # [B, nC, L, Dc]
    return y.reshape(Bsz, nC * chunk, Dc)[:, :T]


def selective_scan(u, delta, A, Bm, Cm, D, *, channels: Optional[int] = None,
                   checkpoint: bool = False) -> torch.Tensor:
    """``y`` of the Mamba-1 scan (fp32), in blocks of channels so that the
    ``[B, T, channels, N]`` temporaries fit; under autograd each block is
    recomputed in the backward (``checkpoint``)."""
    Bsz, T, Dm = u.shape
    N = A.shape[1]
    if channels is None:
        # about 1 GiB per [B, T, channels, N] temporary
        channels = max(64, min(Dm, (1 << 28) // max(1, Bsz * T * N)))
    ys = []
    for lo in range(0, Dm, channels):
        hi = min(Dm, lo + channels)
        args = (u[..., lo:hi], delta[..., lo:hi], A[lo:hi], Bm, Cm)
        if checkpoint:
            ys.append(torch.utils.checkpoint.checkpoint(
                scan_block, *args, use_reentrant=False))
        else:
            ys.append(scan_block(*args))
    return torch.cat(ys, dim=-1) + u * D


def scan_sequential(u, delta, A, Bm, Cm, D) -> torch.Tensor:
    """The same recurrence one step at a time (for tests at small sizes)."""
    Bsz, T, Dm = u.shape
    h = torch.zeros((Bsz, Dm, A.shape[1]), dtype=torch.float32,
                    device=u.device)
    ys = []
    for t in range(T):
        h = torch.exp(delta[:, t, :, None] * A) * h \
            + (delta[:, t] * u[:, t])[:, :, None] * Bm[:, t, None, :]
        ys.append((h * Cm[:, t, None, :]).sum(-1))
    return torch.stack(ys, dim=1) + u * D


def cross_entropy_sum(logits: torch.Tensor, gold: torch.Tensor) -> torch.Tensor:
    """Sum over rows of ``logsumexp(logits) - logits[gold]``."""
    lz = torch.logsumexp(logits, dim=-1)
    return (lz - torch.gather(logits, -1, gold[..., None])[..., 0]).sum()
