"""CUDA kernels for Hopper: blocked online-softmax prefill attention.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py``
(``flash_attention_pallas`` → ``_flash_kernel``).  The kernels are in
``csrc/flash_attention.cu``, on two routes that :func:`flash_route` picks
from the dtype and the head dim before the launch:

* ``"tc"`` (bf16, ``D % 16 == 0``): ``flash_attention_kernel_tc``, TMA
  loads of K / V tiles into a ring in shared memory and ``wgmma`` on the
  tensor cores, 128 query rows a block (64 at D > 128);
* ``"simt"`` (fp32, and bf16 with ``D % 16 != 0``):
  ``flash_attention_kernel``, 64 query rows a block on the fp32 CUDA cores,
  the exact route for fp32 (the tensor cores would compute in TF32).

Both routes write each row's log-sum-exp when given an ``lse`` buffer
(training); the serve path passes none.  The backward, which the JAX
package leaves to XLA's autodiff of its jnp reference, is
``csrc/flash_attention_bwd.cu`` (:func:`flash_attention_bwd_cuda`), three
launches with no atomics (delta, then dK / dV a KV tile a block, then dQ a
query tile a block) on the route :func:`flash_bwd_route` picks: ``"tc"``
(bf16, every head dim: TMA pads it with zeros to 64, 128 or 256 columns)
runs ``attn_bwd_dkdv_tc`` and ``attn_bwd_dq_tc`` on ``wgmma``, ``"simt"``
(fp32) the CUDA-core kernels.  The tensor-core helpers both sources share
are in ``csrc/hopper_tc.cuh``.

The source notes give the bounds.  This module builds the sources with
``nvcc`` at first use (see :mod:`repro_torch.kernels.build`) and launches
them through :mod:`ctypes` on PyTorch's current stream.  It does not
synchronise, and it allocates only the outputs and the backward's delta
scratch.  Callers go through
:mod:`repro_torch.kernels.flash_attention.ops`, which checks the
arguments.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from ..build import load

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


ROUTES = ("tc", "simt")


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call takes: ``"tc"`` (tensor cores) for bf16 with
    a head dim that is a multiple of 16, ``"simt"`` otherwise."""
    if dtype == torch.bfloat16 and head_dim % 16 == 0:
        return "tc"
    return "simt"


def flash_bwd_route(dtype: torch.dtype) -> str:
    """The backward a CUDA call takes: ``"tc"`` (``wgmma``) for bf16 at
    every head dim the inputs' check admits, ``"simt"`` (exact) for fp32."""
    return "tc" if dtype == torch.bfloat16 else "simt"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library (compiled on first call, then cached)."""
    lib = load(SOURCE)
    simt = lib.flash_attention_launch
    simt.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                     + [ctypes.c_float] + [ctypes.c_int] * 3
                     + [ctypes.c_void_p])
    simt.restype = ctypes.c_int
    tc = lib.flash_attention_tc_launch
    tc.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    tc.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def bwd_library() -> ctypes.CDLL:
    """The built backward library (compiled on first call, then cached)."""
    lib = load(BWD_SOURCE)
    simt = lib.flash_attention_bwd_launch
    tc = lib.flash_attention_bwd_tc_launch
    for fn in (simt, tc):
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: Optional[int],
                         scale: float,
                         lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[B, Hq, T, D]`` on the card, on the route :func:`flash_route`
    picks; raises if the launch is refused.  ``lse`` (fp32 ``[B, Hq, T]``,
    contiguous), when given, receives each row's log-sum-exp."""
    B, Hq, T, D = q.shape
    _, Hkv, S, _ = k.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, Hq, Hkv, T, S, D, ctypes.c_float(scale), int(causal),
            -1 if window is None else int(window))
    route = flash_route(q.dtype, D)
    if route == "tc":
        rc = library().flash_attention_tc_launch(*args, stream)
    else:
        rc = library().flash_attention_launch(*args, DTYPE_CODES[q.dtype],
                                              stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention CUDA launch ({route} route) failed: "
            f"cudaError {rc}")
    return out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             dout: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool, window: Optional[int],
                             scale: float):
    """``(dq, dk, dv)`` on the card, in the inputs' dtype, on the route
    :func:`flash_bwd_route` picks; raises if a launch is refused."""
    B, Hq, T, D = q.shape
    _, Hkv, S, _ = k.shape
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, T, S, D,
            ctypes.c_float(scale), int(causal),
            -1 if window is None else int(window), stream)
    route = flash_bwd_route(q.dtype)
    if route == "tc":
        rc = bwd_library().flash_attention_bwd_tc_launch(*args)
    else:
        rc = bwd_library().flash_attention_bwd_launch(*args)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention backward CUDA launch ({route} route) failed: "
            f"cudaError {rc}")
    return dq, dk, dv
