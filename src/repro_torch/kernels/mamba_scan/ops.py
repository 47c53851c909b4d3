"""Public selective-scan wrapper, dispatching on the device.

A CPU tensor runs the plain version (:mod:`.ref`); a CUDA tensor launches
the CUDA kernel (:mod:`.kernel`) and raises if the build or the launch
fails — there is no fallback.  The JAX package's ``mamba_scan`` returns
only ``y`` and runs its Pallas kernel only when asked (``use_pallas``), so
its prefill calls the jnp reference for the final state; here the scan
returns ``(y, h_T)`` and, on the card, every call is the kernel.

``x``, ``delta``, ``Bm`` and ``Cm`` share one type, fp32 or bf16 (the
Pallas kernel's contract: it casts inside its body); ``A`` and ``D`` are
fp32; ``y`` comes back in ``x``'s type and ``h_T`` in fp32.

Every call is tallied in :data:`DISPATCHES` (rows = channels, ``B * D``);
``kernel_launches`` counts the calls that launched the CUDA kernel, and
:data:`DTYPE_LAUNCHES` those launches by the inputs' type.
``mamba_step`` (one decode token) has no kernel in either package: it is
plain PyTorch on every device.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ledger import DispatchStats
from .kernel import MAX_BATCH, MAX_STATE, mamba_scan_cuda
from .ref import mamba_scan_ref, mamba_step_ref

DISPATCHES = DispatchStats()
INPUT_DTYPES = (torch.float32, torch.bfloat16)
DTYPE_LAUNCHES = {"float32": 0, "bfloat16": 0}


def mamba_scan(
    x: torch.Tensor,      # [B, T, D]  fp32 or bf16
    delta: torch.Tensor,  # [B, T, D]  x's type
    A: torch.Tensor,      # [D, N]     fp32
    Bm: torch.Tensor,     # [B, T, N]  x's type
    Cm: torch.Tensor,     # [B, T, N]  x's type
    D: torch.Tensor,      # [D]        fp32
) -> Tuple[torch.Tensor, torch.Tensor]:  # y [B, T, D], h_T [B, D, N] fp32
    """Selective scan from a zero state: ``y`` and the final state."""
    named = (("x", x), ("delta", delta), ("A", A), ("Bm", Bm), ("Cm", Cm),
             ("D", D))
    for nm, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"mamba_scan: {nm} must be a torch.Tensor")
    if x.dtype not in INPUT_DTYPES:
        raise TypeError(
            f"mamba_scan: x must be float32 or bfloat16, got {x.dtype}")
    for nm, t in named:
        want = torch.float32 if nm in ("A", "D") else x.dtype
        if t.dtype != want:
            raise TypeError(f"mamba_scan: {nm} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"mamba_scan: {nm} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"mamba_scan: {nm} is on {t.device}, x on {x.device}")
    if x.dim() != 3 or delta.shape != x.shape:
        raise ValueError("mamba_scan: x and delta must share one [B, T, D] shape")
    Bsz, T, Dm = x.shape
    if A.dim() != 2 or A.shape[0] != Dm:
        raise ValueError(f"mamba_scan: A must be [D={Dm}, N], got {tuple(A.shape)}")
    N = A.shape[1]
    for nm, t in (("Bm", Bm), ("Cm", Cm)):
        if t.shape != (Bsz, T, N):
            raise ValueError(
                f"mamba_scan: {nm} must be [{Bsz}, {T}, {N}], got {tuple(t.shape)}")
    if D.shape != (Dm,):
        raise ValueError(f"mamba_scan: D must be [{Dm}], got {tuple(D.shape)}")
    if T < 1 or N < 1:
        raise ValueError(f"mamba_scan: needs T >= 1 and N >= 1, got T={T}, N={N}")
    if x.device.type == "cuda":
        if N > MAX_STATE:
            raise ValueError(
                f"mamba_scan: the CUDA kernel takes N <= {MAX_STATE}, got {N}")
        if Bsz > MAX_BATCH:
            raise ValueError(
                f"mamba_scan: the CUDA kernel takes B <= {MAX_BATCH}, got {Bsz}")
    elif x.device.type != "cpu":
        raise ValueError(f"mamba_scan: no kernel for device {x.device}")
    DISPATCHES.launches += 1
    DISPATCHES.rows += Bsz * Dm
    if x.device.type == "cpu":
        return mamba_scan_ref(x, delta, A, Bm, Cm, D)
    out = mamba_scan_cuda(x, delta, A, Bm, Cm, D)
    DISPATCHES.kernel_launches += 1
    DTYPE_LAUNCHES[str(x.dtype).removeprefix("torch.")] += 1
    return out


def mamba_step(x, delta, A, Bm, Cm, D, h) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step (state-carrying); plain PyTorch, O(1) in sequence."""
    return mamba_step_ref(x, delta, A, Bm, Cm, D, h)
