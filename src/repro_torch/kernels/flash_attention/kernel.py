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

The source note gives the bound.  This module builds the source with
``nvcc`` at first use (see :mod:`repro_torch.kernels.build`) and launches
it through :mod:`ctypes` on PyTorch's current stream.  It does not
synchronise, and it allocates only the output.  Callers go through
:func:`repro_torch.kernels.flash_attention.ops.flash_attention`, which
checks the arguments.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from ..build import load

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


ROUTES = ("tc", "simt")


def flash_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call takes: ``"tc"`` (tensor cores) for bf16 with
    a head dim that is a multiple of 16, ``"simt"`` otherwise."""
    if dtype == torch.bfloat16 and head_dim % 16 == 0:
        return "tc"
    return "simt"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library (compiled on first call, then cached)."""
    lib = load(SOURCE)
    simt = lib.flash_attention_launch
    simt.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                     + [ctypes.c_float] + [ctypes.c_int] * 3
                     + [ctypes.c_void_p])
    simt.restype = ctypes.c_int
    tc = lib.flash_attention_tc_launch
    tc.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    tc.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: Optional[int],
                         scale: float) -> torch.Tensor:
    """``[B, Hq, T, D]`` on the card, on the route :func:`flash_route`
    picks; raises if the launch is refused."""
    B, Hq, T, D = q.shape
    _, Hkv, S, _ = k.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
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
