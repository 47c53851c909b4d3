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

Under autograd (grad enabled and an input that requires grad) a call goes
through :class:`MambaScanFunction`: its forward is the kernel's train
variant, which also writes the state entering each window of 16 steps,
and its backward :func:`mamba_scan_bwd` — the CUDA backward kernels on
the card, the plain :func:`.ref.mamba_scan_bwd_ref` on the CPU.  ``h_T`` takes
no gradient there (training uses only ``y``, as the JAX package's scan
returns only ``y``): it comes back detached.

Every forward call is tallied in :data:`DISPATCHES` (rows = channels,
``B * D``); ``kernel_launches`` counts the calls that launched the CUDA
kernel, and :data:`DTYPE_LAUNCHES` those launches by the inputs' type.
:data:`BWD_DISPATCHES` tallies the backward calls likewise; one call is
up to three kernel launches (the carry across segments, the gradient and
the sums of its partials) and counts once.  ``mamba_step`` (one decode
token) has no kernel in either package: it is plain PyTorch on every
device.

On a ``meta`` tensor (the dry run) nothing is computed: the wrapper
allocates its outputs (the train variant's edges too) and adds the
kernels' FLOPs and bytes (:func:`scan_work`) to
:data:`~repro_torch.kernels.ledger.DRYRUN`.  A DTensor reaches the kernel
through ``local_map`` (:func:`repro_torch.models.sharding.local_kernel`):
x, delta and D by ``"batch"`` and ``"ff"`` (channels), A by ``"ff"``, B
and C by ``"batch"``, each rank scanning its rows and channels over the
whole sequence.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..ledger import DRYRUN, DispatchStats
from .kernel import (MAX_BATCH, MAX_STATE, edges_shape, mamba_scan_bwd_cuda,
                     mamba_scan_cuda)
from .ref import mamba_scan_bwd_ref, mamba_scan_ref, mamba_step_ref

DISPATCHES = DispatchStats()
BWD_DISPATCHES = DispatchStats()
INPUT_DTYPES = (torch.float32, torch.bfloat16)
DTYPE_LAUNCHES = {"float32": 0, "bfloat16": 0}


def scan_work(x: torch.Tensor, N: int, *, bwd: bool = False,
              edges: int = 0):
    """(FLOPs, bytes) of one forward or backward call at x ``[B, T, D]``
    with N states and ``edges`` fp32 edge states written or read.
    Forward: per state element and step delta*A, exp, a*h, (dx)*B, +, *C,
    sum, per channel and step delta*x, x*D, +; x, delta read and y written
    once and B, C read in x's type, A, D read and h_T written in fp32.
    Backward, an FMA counted as two: per state element and step delta*A,
    exp, the state's recompute (delta x B and an FMA), g (dy C and an
    FMA), a_t h_{t-1} and g times it, the dB and dC terms and their adds
    over channels, and the FMAs of the dx, ddelta and dA sums (10 + 5
    FMAs); per channel and step delta*x, the dx sum's scaling, ddelta's
    FMA, D*dy and its add, dD's FMA (4 + 2 FMAs); x, delta, dy read and
    dx, ddelta written, B, C read and dB, dC written, A, D read and dA, dD
    written."""
    B, T, D = x.shape
    esize = x.element_size()
    if bwd:
        return (B * T * D * (20 * N + 8),
                esize * (5 * B * T * D + 4 * B * T * N)
                + 4 * (2 * D * N + 2 * D) + 4 * edges)
    return (B * T * D * (7 * N + 3),
            esize * (3 * B * T * D + 2 * B * T * N)
            + 4 * (D * N + D + B * D * N) + 4 * edges)


def check_scan_inputs(name: str, x, delta, A, Bm, Cm, D) -> None:
    """Types, shapes, contiguity and device of the scan's inputs; on a
    CUDA tensor, what the kernels take."""
    named = (("x", x), ("delta", delta), ("A", A), ("Bm", Bm), ("Cm", Cm),
             ("D", D))
    for nm, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {nm} must be a torch.Tensor")
    if x.dtype not in INPUT_DTYPES:
        raise TypeError(
            f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    for nm, t in named:
        want = torch.float32 if nm in ("A", "D") else x.dtype
        if t.dtype != want:
            raise TypeError(f"{name}: {nm} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name}: {nm} is on {t.device}, x on {x.device}")
    if x.dim() != 3 or delta.shape != x.shape:
        raise ValueError(f"{name}: x and delta must share one [B, T, D] shape")
    Bsz, T, Dm = x.shape
    if A.dim() != 2 or A.shape[0] != Dm:
        raise ValueError(f"{name}: A must be [D={Dm}, N], got {tuple(A.shape)}")
    N = A.shape[1]
    for nm, t in (("Bm", Bm), ("Cm", Cm)):
        if t.shape != (Bsz, T, N):
            raise ValueError(
                f"{name}: {nm} must be [{Bsz}, {T}, {N}], got {tuple(t.shape)}")
    if D.shape != (Dm,):
        raise ValueError(f"{name}: D must be [{Dm}], got {tuple(D.shape)}")
    if T < 1 or N < 1:
        raise ValueError(f"{name}: needs T >= 1 and N >= 1, got T={T}, N={N}")
    if x.device.type in ("cuda", "meta"):
        if N > MAX_STATE:
            raise ValueError(
                f"{name}: the CUDA kernel takes N <= {MAX_STATE}, got {N}")
        if Bsz > MAX_BATCH:
            raise ValueError(
                f"{name}: the CUDA kernel takes B <= {MAX_BATCH}, got {Bsz}")
    elif x.device.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {x.device}")


def _sharded(fn, x, delta, A, Bm, Cm, D):
    """``fn`` over each rank's rows and channels of DTensor inputs."""
    from ...models.sharding import local_kernel

    row, ch = ("batch", None, "ff"), ("batch", None, None)
    Bsz, _, Dm = x.shape
    return local_kernel(
        fn, (x, delta, A, Bm, Cm, D),
        (row, row, ("ff", None), ch, ch, ("ff",)),
        ((tuple(x.shape), row), ((Bsz, Dm, A.shape[1]), ("batch", "ff", None))),
        split_by=0)


def mamba_scan(
    x: torch.Tensor,      # [B, T, D]  fp32 or bf16
    delta: torch.Tensor,  # [B, T, D]  x's type
    A: torch.Tensor,      # [D, N]     fp32
    Bm: torch.Tensor,     # [B, T, N]  x's type
    Cm: torch.Tensor,     # [B, T, N]  x's type
    D: torch.Tensor,      # [D]        fp32
) -> Tuple[torch.Tensor, torch.Tensor]:  # y [B, T, D], h_T [B, D, N] fp32
    """Selective scan from a zero state: ``y`` and the final state."""
    if isinstance(x, DTensor):
        return _sharded(mamba_scan, x, delta, A, Bm, Cm, D)
    check_scan_inputs("mamba_scan", x, delta, A, Bm, Cm, D)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, delta, A, Bm, Cm, D)):
        return MambaScanFunction.apply(x, delta, A, Bm, Cm, D)
    return _forward(x, delta, A, Bm, Cm, D, with_edges=False)[:2]


def _forward(x, delta, A, Bm, Cm, D, *, with_edges: bool):
    """``(y, h_T, edges or None)``: the plain version on the CPU (no
    edges: its backward recomputes the states), the kernel on the card,
    tallied in :data:`DISPATCHES`."""
    Bsz, _, Dm = x.shape
    DISPATCHES.launches += 1
    DISPATCHES.rows += Bsz * Dm
    if x.device.type == "cpu":
        return (*mamba_scan_ref(x, delta, A, Bm, Cm, D), None)
    if x.device.type == "meta":
        N = A.shape[1]
        edges = (x.new_empty(edges_shape(Bsz, x.shape[1], Dm, N),
                             dtype=torch.float32) if with_edges else None)
        DRYRUN.add(*scan_work(x, N, edges=edges.numel() if with_edges else 0))
        return (torch.empty_like(x), x.new_empty((Bsz, Dm, N),
                                                 dtype=torch.float32), edges)
    out = mamba_scan_cuda(x, delta, A, Bm, Cm, D, with_edges=with_edges)
    DISPATCHES.kernel_launches += 1
    DTYPE_LAUNCHES[str(x.dtype).removeprefix("torch.")] += 1
    return out if with_edges else (*out, None)


def mamba_scan_bwd(
    x: torch.Tensor, delta: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
    Cm: torch.Tensor, D: torch.Tensor, dy: torch.Tensor,
    edges: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """``(dx, ddelta, dA, dBm, dCm, dD)`` of ``y`` of :func:`mamba_scan`
    against its gradient ``dy`` (``[B, T, D]`` in ``x``'s type), each in
    its input's type.  On the card ``edges`` is the train variant's
    ``[B, ceil(T / 16), ceil(N / 4), D, 4]`` fp32 states entering each
    window (``kernel.edges_shape``); the CPU's plain version recomputes
    the states and takes none."""
    check_scan_inputs("mamba_scan_bwd", x, delta, A, Bm, Cm, D)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous():
        raise ValueError(
            "mamba_scan_bwd: dy must be a contiguous "
            f"{tuple(x.shape)} {x.dtype} tensor on {x.device}")
    Bsz, T, Dm = x.shape
    BWD_DISPATCHES.launches += 1
    BWD_DISPATCHES.rows += Bsz * Dm
    if x.device.type == "cpu":
        return mamba_scan_bwd_ref(x, delta, A, Bm, Cm, D, dy)
    want = edges_shape(Bsz, T, Dm, A.shape[1])
    if x.device.type == "meta":
        DRYRUN.add(*scan_work(x, A.shape[1], bwd=True,
                              edges=edges.numel() if edges is not None else 0))
        return tuple(torch.empty_like(t) for t in (x, delta, A, Bm, Cm, D))
    if edges is None or tuple(edges.shape) != want \
            or edges.dtype != torch.float32 or edges.device != x.device \
            or not edges.is_contiguous():
        raise ValueError(
            f"mamba_scan_bwd: edges must be a contiguous fp32 {want} tensor "
            f"on {x.device} (the train variant's)")
    grads = mamba_scan_bwd_cuda(x, delta, A, Bm, Cm, D, dy, edges)
    BWD_DISPATCHES.kernel_launches += 1
    return grads


class MambaScanFunction(torch.autograd.Function):
    """Differentiable :func:`mamba_scan`: the kernel's train variant and
    the backward kernel on the card, their plain versions on the CPU.
    It keeps only its saved tensors (the inputs and the edges), so a
    recompute under ``torch.utils.checkpoint`` runs the forward again, and
    is counted again."""

    @staticmethod
    def forward(ctx, x, delta, A, Bm, Cm, D):
        y, hT, edges = _forward(x, delta, A, Bm, Cm, D, with_edges=True)
        ctx.save_for_backward(x, delta, A, Bm, Cm, D, edges)
        ctx.mark_non_differentiable(hT)
        return y, hT

    @staticmethod
    def backward(ctx, dy, _dhT):
        x, delta, A, Bm, Cm, D, edges = ctx.saved_tensors
        return mamba_scan_bwd(x, delta, A, Bm, Cm, D, dy.contiguous(), edges)


def mamba_step(x, delta, A, Bm, Cm, D, h) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step (state-carrying); plain PyTorch, O(1) in sequence."""
    return mamba_step_ref(x, delta, A, Bm, Cm, D, h)
