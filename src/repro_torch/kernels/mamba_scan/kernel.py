"""CUDA kernel for Hopper: the Mamba-1 selective scan.

Replaces the Pallas TPU kernel ``repro/kernels/mamba_scan/kernel.py``
(``mamba_scan_pallas`` → ``_mamba_kernel``).  The kernel itself is
``csrc/mamba_scan.cu``: a block of 64 channels walks T in chunks that
``cp.async`` stages in shared memory three deep, each thread keeps 4
states of a channel in registers, the exps (``ex2``) and ``Δ·x·B`` run
ahead of the one FMA a step that is serial, and ``y`` is summed from
per-thread partials once a chunk.  It reads fp32 or bf16 inputs, writes
``y`` in their type and the final state in fp32 (the Pallas kernel
returned only ``y``); its source note gives the bound.  Its train
variant (``with_edges=True``) also writes the state entering each chunk
of :data:`CHUNK` steps, which the backward reads.

The gradient (the JAX package has no Pallas backward: it differentiates
its jnp scan) is ``csrc/mamba_scan_bwd.cu``, launched by
:func:`mamba_scan_bwd_cuda`: it walks the chunks in reverse, recomputes
each chunk's states from its edge and runs the gradient of the state
backwards; the cross-channel sums ``dB``/``dC`` are written as one
partial per block of 64 channels and ``dA``/``dD`` as one per batch row,
which a second launch adds in a fixed order (no atomics: two launches
give the same bits).

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
BWD_SOURCE = SOURCE.with_name("mamba_scan_bwd.cu")

MAX_STATE = 32  # N: at most 8 groups of 4 states a channel
MAX_BATCH = 65535  # B: the grid's second dimension
CHUNK = 32  # steps a block stages at once (kChunk in the source)
CHANNELS = 64  # channels a block keeps (kChannels in the sources)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library (compiled on first call, then cached)."""
    lib = load(SOURCE)
    fn = lib.mamba_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mamba_scan_train_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def bwd_library() -> ctypes.CDLL:
    """The built backward library (compiled on first call, then cached)."""
    lib = load(BWD_SOURCE)
    fn = lib.mamba_scan_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def n_chunks(T: int) -> int:
    """Chunks of :data:`CHUNK` steps in ``T`` (the edges' third axis)."""
    return -(-T // CHUNK)


def mamba_scan_cuda(x: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                    *, with_edges: bool = False) -> Tuple[torch.Tensor, ...]:
    """``(y [B, T, D]`` in ``x``'s type, ``h_T [B, D, N]`` in fp32) on the
    card, and with ``with_edges`` the train variant's third output, the
    state entering each chunk ``[B, D, ceil(T / CHUNK), N]`` fp32; raises
    if the launch is refused."""
    lib = library()
    Bsz, T, Dm = x.shape
    N = A.shape[1]
    y = torch.empty_like(x)
    h_out = torch.empty((Bsz, Dm, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), delta.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr(), y.data_ptr(), h_out.data_ptr())
    tail = (Bsz, T, Dm, N, DTYPE_CODES[x.dtype], stream)
    if with_edges:
        edges = torch.empty((Bsz, Dm, n_chunks(T), N), dtype=torch.float32,
                            device=x.device)
        rc = lib.mamba_scan_train_launch(*args, edges.data_ptr(), *tail)
    else:
        rc = lib.mamba_scan_launch(*args, *tail)
    if rc != 0:
        raise RuntimeError(f"mamba_scan CUDA launch failed: cudaError {rc}")
    return (y, h_out, edges) if with_edges else (y, h_out)


def mamba_scan_bwd_cuda(x: torch.Tensor, delta: torch.Tensor,
                        A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                        D: torch.Tensor, dy: torch.Tensor, edges: torch.Tensor
                        ) -> Tuple[torch.Tensor, ...]:
    """``(dx, ddelta, dA, dBm, dCm, dD)`` on the card (each in its input's
    type), from the train variant's ``edges``; two launches (the gradient
    and the fixed-order sums of its partials), raises if one is
    refused."""
    lib = bwd_library()
    Bsz, T, Dm = x.shape
    N = A.shape[1]
    dev = x.device
    dx, ddelta = torch.empty_like(x), torch.empty_like(delta)
    dBm, dCm = torch.empty_like(Bm), torch.empty_like(Cm)
    dA, dD = torch.empty_like(A), torch.empty_like(D)
    n_blk = -(-Dm // CHANNELS)
    f32 = dict(dtype=torch.float32, device=dev)
    dbc_part = torch.empty((2, n_blk, Bsz, T, N), **f32)
    dA_part = torch.empty((Bsz, Dm, N), **f32)
    dD_part = torch.empty((Bsz, Dm), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.mamba_scan_bwd_launch(
        *(t.data_ptr() for t in (x, delta, A, Bm, Cm, D, dy, edges, dx,
                                 ddelta, dA, dBm, dCm, dD, dbc_part, dA_part,
                                 dD_part)),
        Bsz, T, Dm, N, DTYPE_CODES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan_bwd CUDA launch failed: cudaError {rc}")
    return dx, ddelta, dA, dBm, dCm, dD
