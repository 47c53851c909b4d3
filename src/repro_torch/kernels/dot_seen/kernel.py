"""CUDA kernel for Hopper: batched dot-seen test against a dense clock.

Replaces the Pallas TPU kernel ``repro/kernels/dot_seen/kernel.py``
(``dot_seen_pallas`` → ``_kernel``).  The kernel itself is
``csrc/dot_seen.cu``: one thread per dot reads its actor's run row and
compares int32s, exact over all of int32 (the TPU kernel's f32 one-hot
gather was exact only below 2²⁴).  Its source note gives the bound.

This module builds the source with ``nvcc`` at first use (see
:mod:`repro_torch.kernels.build`) and launches it through :mod:`ctypes`
on PyTorch's current stream.  It does not synchronise, and it allocates
only the output.  Callers go through :func:`repro_torch.kernels.dot_seen.
ops.dot_seen`, which checks the arguments.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from ..build import load

SOURCE = Path(__file__).resolve().parent / "csrc" / "dot_seen.cu"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library (compiled on first call, then cached: a
    launch must not re-read and re-hash the source)."""
    lib = load(SOURCE)
    fn = lib.dot_seen_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def dot_seen_cuda(starts: torch.Tensor, ends: torch.Tensor,
                  actors: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """bool[N] on the card; raises if the launch is refused."""
    n_actors, n_runs = starts.shape
    n = actors.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=actors.device)
    stream = torch.cuda.current_stream(actors.device).cuda_stream
    rc = library().dot_seen_launch(
        starts.data_ptr(), ends.data_ptr(), actors.data_ptr(),
        counters.data_ptr(), out.data_ptr(), n_actors, n_runs, n, stream)
    if rc != 0:
        raise RuntimeError(f"dot_seen CUDA launch failed: cudaError {rc}")
    return out
