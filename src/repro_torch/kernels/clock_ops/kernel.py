"""CUDA kernels for Hopper: the interval clock-lattice merge and popcount.

Replaces the Pallas TPU kernels ``repro/kernels/clock_ops/kernel.py``
(``join_pallas`` / ``subtract_pallas`` / ``intersect_pallas`` →
``_merge_kernel``, and ``popcount_pallas`` → ``_popcount_kernel``).  The
kernels are ``csrc/clock_ops.cu``.  The merge is one launch, a block per
actor row: it brings each side to sorted, disjoint runs (one block-wide
test on rows that already are), flags the edges that start or end an
output run by binary searches, ranks them by block scans and writes the
*canonical* row — sorted maximal runs, empty ``(1, 0)`` slots last — with
no sort after it.  A row's workspace lives in shared memory, or in a
scratch buffer in global memory when the row is too wide.  Popcount sums a
row with a group of threads sized to fill the card, by 16-byte loads,
with int32 wrap.  The source note gives the bounds.

This module builds the source with ``nvcc`` at first use (see
:mod:`repro_torch.kernels.build`) and launches it through :mod:`ctypes`
on PyTorch's current stream.  It does not synchronise, and it allocates
only the outputs and, on the wide-row route, the merge's workspace.
Callers go through :mod:`repro_torch.kernels.clock_ops.ops`, which checks
the arguments.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from ..build import load

SOURCE = Path(__file__).resolve().parent / "csrc" / "clock_ops.cu"

MODES = {"or": 0, "andnot": 1, "and": 2}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library (compiled on first call, then cached)."""
    lib = load(SOURCE)
    lib.clock_merge_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.clock_merge_launch.restype = ctypes.c_int
    lib.clock_merge_route.argtypes = [ctypes.c_int] * 3
    lib.clock_merge_route.restype = ctypes.c_int
    lib.clock_merge_workspace_bytes.argtypes = [ctypes.c_int] * 2
    lib.clock_merge_workspace_bytes.restype = ctypes.c_longlong
    lib.clock_popcount_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.clock_popcount_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def _scratch_bytes(ra: int, rb: int, index: int) -> int:
    """Bytes of global workspace a row of the merge takes on card
    ``index``: 0 when the row fits a block's shared memory."""
    lib = library()
    route = lib.clock_merge_route(ra, rb, index)
    if route < 0:
        raise RuntimeError(f"clock_ops: cannot read the shared memory limit "
                           f"of cuda:{index}: cudaError {-route}")
    return 0 if route else lib.clock_merge_workspace_bytes(ra, rb)


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


def staged(ra: int, rb: int, device: torch.device) -> bool:
    """Whether a merge of rows of ``ra + rb`` runs keeps each row in a
    block's shared memory on ``device`` (else in global memory)."""
    return _scratch_bytes(ra, rb, _index(device)) == 0


def clock_merge_cuda(mode: str, a_s: torch.Tensor, a_e: torch.Tensor,
                     b_s: torch.Tensor, b_e: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The merge on the card, one launch: the canonical ``int32[A, Ra + Rb]``
    run pair (sorted maximal runs of the op's live counters, then ``(1,
    0)``), which is the plain version's output after
    :func:`~repro_torch.core.vclock.sort_runs`; raises if the launch is
    refused."""
    n_actors, ra = a_s.shape
    rb = b_s.shape[1]
    dev = a_s.device
    index = _index(dev)
    out_s = torch.empty((n_actors, ra + rb), dtype=torch.int32, device=dev)
    out_e = torch.empty_like(out_s)
    per_row = _scratch_bytes(ra, rb, index)
    scratch = (torch.empty(n_actors * per_row, dtype=torch.uint8, device=dev)
               if per_row else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = library().clock_merge_launch(
        a_s.data_ptr(), a_e.data_ptr(), b_s.data_ptr(), b_e.data_ptr(),
        out_s.data_ptr(), out_e.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        n_actors, ra, rb, MODES[mode], index, stream)
    if rc != 0:
        raise RuntimeError(f"clock_ops {mode} merge CUDA launch failed: "
                           f"cudaError {rc}")
    return out_s, out_e


def clock_popcount_cuda(starts: torch.Tensor, ends: torch.Tensor
                        ) -> torch.Tensor:
    """``int32[A]`` events per actor on the card; raises if the launch is
    refused."""
    n_actors, n_runs = starts.shape
    out = torch.empty((n_actors,), dtype=torch.int32, device=starts.device)
    stream = torch.cuda.current_stream(starts.device).cuda_stream
    rc = library().clock_popcount_launch(
        starts.data_ptr(), ends.data_ptr(), out.data_ptr(), n_actors, n_runs,
        stream)
    if rc != 0:
        raise RuntimeError(f"clock_ops popcount CUDA launch failed: "
                           f"cudaError {rc}")
    return out
