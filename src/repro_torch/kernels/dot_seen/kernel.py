"""CUDA kernel for Hopper: batched dot-seen test against a dense clock.

Replaces the Pallas TPU kernel ``repro/kernels/dot_seen/kernel.py``
(``dot_seen_pallas`` → ``_kernel``).  The kernel itself is
``csrc/dot_seen.cu``: a warp per dot strides its actor's run row with
coalesced loads and stops at the first hit by a vote, reading the rows
from shared memory where they fit; it compares int32s, exact over all of
int32 (the TPU kernel's f32 one-hot gather was exact only below 2²⁴).
:func:`plan` picks the grid and the staging from the shapes; the source
note gives the bound.

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
from typing import NamedTuple

import torch

from ..build import load

SOURCE = Path(__file__).resolve().parent / "csrc" / "dot_seen.cu"

THREADS = 256          # a block's threads (kThreads in the source)
DOTS_PER_BLOCK = THREADS // 32  # a warp a dot
STAGE_INTS = 12 * 1024  # starts and ends staged in 48 KB (kStageInts)
UNROLL = 4  # runs a lane reads between two votes (kUnroll)


class Plan(NamedTuple):
    blocks: int
    staged: bool     # both arrays read from shared memory


def plan(n_actors: int, n_runs: int, n: int) -> Plan:
    """The launch's geometry, from the shapes alone: dot ``i`` is warp
    ``i % DOTS_PER_BLOCK`` of block ``i // DOTS_PER_BLOCK``."""
    return Plan(-(-n // DOTS_PER_BLOCK), 2 * n_actors * n_runs <= STAGE_INTS)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library (compiled on first call, then cached: a
    launch must not re-read and re-hash the source)."""
    lib = load(SOURCE)
    fn = lib.dot_seen_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def dot_seen_cuda(starts: torch.Tensor, ends: torch.Tensor,
                  actors: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """bool[N] on the card; raises if the launch is refused."""
    n_actors, n_runs = starts.shape
    n = actors.shape[0]
    geometry = plan(n_actors, n_runs, n)
    out = torch.empty((n,), dtype=torch.bool, device=actors.device)
    stream = torch.cuda.current_stream(actors.device).cuda_stream
    rc = library().dot_seen_launch(
        starts.data_ptr(), ends.data_ptr(), actors.data_ptr(),
        counters.data_ptr(), out.data_ptr(), n_actors, n_runs, n,
        int(geometry.staged), geometry.blocks, stream)
    if rc != 0:
        raise RuntimeError(f"dot_seen CUDA launch failed: cudaError {rc}")
    return out
