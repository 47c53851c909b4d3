"""CUDA kernel for Hopper: blocked online-softmax prefill attention.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py``
(``flash_attention_pallas`` → ``_flash_kernel``).  The kernel itself is
``csrc/flash_attention.cu``: one block per (64-query tile, q head, batch
row) loops over the KV tiles its rows can reach, with the online softmax
in fp32 registers; its source note gives the bound.

This module builds the source with ``nvcc`` at first use (see
:mod:`repro_torch.kernels.build`) and launches it through :mod:`ctypes`
on PyTorch's current stream.  It does not synchronise, and it allocates
only the output.  Callers go through :func:`repro_torch.kernels.
flash_attention.ops.flash_attention`, which checks the arguments.
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


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library (compiled on first call, then cached)."""
    lib = load(SOURCE)
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: Optional[int],
                         scale: float) -> torch.Tensor:
    """``[B, Hq, T, D]`` on the card; raises if the launch is refused."""
    B, Hq, T, D = q.shape
    _, Hkv, S, _ = k.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, T, S, D, ctypes.c_float(scale), int(causal),
        -1 if window is None else int(window), DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention CUDA launch failed: cudaError {rc}")
    return out
