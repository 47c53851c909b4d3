"""CUDA kernel for Hopper: one query token against a KV cache.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention/kernel.py``
(``decode_attention_pallas`` → ``_decode_kernel``).  The kernel itself is
``csrc/decode_attention.cu``: one block per (kv head, batch row) serves the
kv head's group of query heads, reads ``cache_len`` from device memory and
streams only the valid slots of the cache; its source note gives the bound.

This module builds the source with ``nvcc`` at first use (see
:mod:`repro_torch.kernels.build`) and launches it through :mod:`ctypes`
on PyTorch's current stream.  It does not synchronise, and it allocates
only the output.  Callers go through :func:`repro_torch.kernels.
decode_attention.ops.decode_attention`, which checks the arguments.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from ..build import load
from ..flash_attention.kernel import DTYPE_CODES

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library (compiled on first call, then cached)."""
    lib = load(SOURCE)
    fn = lib.decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, cache_len: torch.Tensor,
                          *, window: Optional[int],
                          scale: float) -> torch.Tensor:
    """``[B, Hq, D]`` on the card; raises if the launch is refused."""
    B, Hq, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = library().decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        cache_len.data_ptr(), out.data_ptr(), B, Hq, Hkv, S, D,
        ctypes.c_float(scale), -1 if window is None else int(window),
        DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"decode_attention CUDA launch failed: cudaError {rc}")
    return out
