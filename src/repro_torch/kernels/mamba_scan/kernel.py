"""CUDA kernel for Hopper: the Mamba-1 selective scan.

Replaces the Pallas TPU kernel ``repro/kernels/mamba_scan/kernel.py``
(``mamba_scan_pallas`` → ``_mamba_kernel``).  The kernel itself is
``csrc/mamba_scan.cu``: a block of 64 channels walks T in chunks that
``cp.async`` stages in shared memory three deep, each thread keeps 4
states of a channel in registers, the exps (``ex2``) and ``Δ·x·B`` run
ahead of the one FMA a step that is serial, and ``y`` is summed from
per-thread partials once a chunk.  It reads fp32 or bf16 inputs, writes
``y`` in their type and the final state in fp32 (the Pallas kernel
returned only ``y``); its source note gives the bound.

This module builds the source with ``nvcc`` at first use (see
:mod:`repro_torch.kernels.build`) and launches it through :mod:`ctypes`
on PyTorch's current stream.  It does not synchronise, and it allocates
only the outputs.  Callers go through :func:`repro_torch.kernels.
mamba_scan.ops.mamba_scan`, which checks the arguments.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from ..build import load
from ..flash_attention.kernel import DTYPE_CODES

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"

MAX_STATE = 32  # N: at most 8 groups of 4 states a channel
MAX_BATCH = 65535  # B: the grid's second dimension
CHUNK = 32  # steps a block stages at once (kChunk in the source)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library (compiled on first call, then cached)."""
    lib = load(SOURCE)
    fn = lib.mamba_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def mamba_scan_cuda(x: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y [B, T, D]`` in ``x``'s type, ``h_T [B, D, N]`` in fp32) on the
    card; raises if the launch is refused."""
    lib = library()
    Bsz, T, Dm = x.shape
    N = A.shape[1]
    y = torch.empty_like(x)
    h_out = torch.empty((Bsz, Dm, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.mamba_scan_launch(
        x.data_ptr(), delta.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), D.data_ptr(), y.data_ptr(), h_out.data_ptr(),
        Bsz, T, Dm, N, DTYPE_CODES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan CUDA launch failed: cudaError {rc}")
    return y, h_out
