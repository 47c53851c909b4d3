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
variant (``with_edges=True``) also writes the state entering each window
of :data:`EDGE` steps, which the backward reads.

The gradient (the JAX package has no Pallas backward: it differentiates
its jnp scan) is ``csrc/mamba_scan_bwd.cu``, launched by
:func:`mamba_scan_bwd_cuda` on the plan of :func:`bwd_plan`: T is cut into
segments of whole windows, so that the grid (channel blocks × segments ×
batch rows) fills the card; a carry launch runs the gradient of the state
``g`` backwards over the steps after the first segment in pieces of at
most :data:`PIECE` steps and writes each piece's ``(L, P)``; the main
launch folds the later pieces into the ``g`` that enters its segment,
recomputes each window's states from its edge and runs ``g`` backwards;
the cross-channel sums ``dB``/``dC`` are written as one partial per
channel block and ``dA``/``dD`` as one per (batch row, segment), which a
third launch adds in a fixed order (no atomics: two launches give the
same bits).

This module builds the source with ``nvcc`` at first use (see
:mod:`repro_torch.kernels.build`) and launches it through :mod:`ctypes`
on PyTorch's current stream.  It does not synchronise, and it allocates
only the outputs and the backward's scratch.  Callers go through :func:`repro_torch.kernels.
mamba_scan.ops.mamba_scan`, which checks the arguments.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Tuple

import torch

from ..build import load
from ..flash_attention.kernel import DTYPE_CODES

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"
BWD_SOURCE = SOURCE.with_name("mamba_scan_bwd.cu")

MAX_STATE = 32  # N: at most 8 groups of 4 states a channel
MAX_BATCH = 65535  # B: the grid's last dimension
CHUNK = 32  # steps the forward stages at once (kChunk in the source)
CHANNELS = 64  # channels a block keeps (kChannels, kCB in the sources)
EDGE = 16  # steps between the train variant's edges: the backward's window
PIECE = 128  # at most this many steps in a piece of the backward's carry
MIN_BLOCKS = 256  # the backward's grid: one wave at two blocks an SM on 132 SMs


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
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mamba_scan_bwd_occupancy
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    return lib


def n_edges(T: int) -> int:
    """Windows of :data:`EDGE` steps in ``T`` (the edges' second axis)."""
    return -(-T // EDGE)


def edges_shape(B: int, T: int, D: int, N: int) -> Tuple[int, ...]:
    """The train variant's edges: ``[B, ceil(T / 16), ceil(N / 4), D, 4]``,
    state ``4k + i`` of channel ``d`` at ``[.., k, d, i]``."""
    return (B, n_edges(T), -(-N // 4), D, 4)


def edge_states(edges: torch.Tensor, N: int) -> torch.Tensor:
    """``edges`` as ``[B, ceil(T / 16), D, N]``: the state entering each
    window."""
    B, E, K, D, _ = edges.shape
    return edges.permute(0, 1, 3, 2, 4).reshape(B, E, D, 4 * K)[..., :N]


class BwdPlan(NamedTuple):
    """How the backward cuts its work (the kernels' own arithmetic)."""
    groups: int     # threads a channel, 4 states each: a power of two
    channels: int   # channels a block of the main launch keeps
    threads: int    # threads a block of the main launch
    n_blk: int      # channel blocks
    seg_len: int    # steps a segment (whole windows)
    n_seg: int      # segments of T
    piece_len: int  # steps a carry piece (divides seg_len)
    n_pieces: int   # pieces after the first segment (0: no carry launch)

    def scratch_shapes(self, B: int, T: int, D: int, N: int):
        """fp32 scratch: dB/dC partials, dA and dD partials, the carry."""
        return {"dbc_part": (2, self.n_blk, B, T, N),
                "dA_part": (B, self.n_seg, D, N),
                "dD_part": (B, self.n_seg, D),
                "carry": (2, B, self.n_pieces, D, N)}

    def exps_per_state_step(self, T: int) -> float:
        """Exps the design evaluates a state and step, by its arithmetic
        (not a measurement): 1.5 in the main launch (a window's first half
        twice), one in the carry's for every step after the first
        segment."""
        return 1.5 + max(0, T - self.seg_len) / T


def bwd_plan(B: int, T: int, D: int, N: int) -> BwdPlan:
    """The backward's plan: ``2^ceil(log2(N / 4))`` threads a channel, 64
    channels a block; T cut into at least two segments where it can, and
    into more until the grid has :data:`MIN_BLOCKS` blocks, none shorter
    than a window; segments longer than :data:`PIECE` steps are whole
    pieces of it."""
    groups = 1
    while 4 * groups < N:
        groups *= 2
    channels = CHANNELS
    n_blk = -(-D // channels)
    want = max(2, -(-MIN_BLOCKS // (n_blk * B)))
    per = -(-T // want)
    if per <= PIECE:
        seg_len = -(-per // EDGE) * EDGE
        piece_len = seg_len
    else:
        seg_len = -(-per // PIECE) * PIECE
        piece_len = PIECE
    n_seg = -(-T // seg_len)
    n_pieces = -(-(T - seg_len) // piece_len) if n_seg > 1 else 0
    return BwdPlan(groups, channels, channels * groups, n_blk, seg_len, n_seg,
                   piece_len, n_pieces)


def bwd_occupancy(N: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """The main launch's (blocks an SM holds at once, threads a block,
    dynamic shared memory a block) on the current card."""
    blocks, threads, smem = (ctypes.c_int() for _ in range(3))
    rc = bwd_library().mamba_scan_bwd_occupancy(
        N, DTYPE_CODES[dtype], ctypes.byref(blocks), ctypes.byref(threads),
        ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"mamba_scan_bwd occupancy failed: cudaError {rc}")
    return blocks.value, threads.value, smem.value


def mamba_scan_cuda(x: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                    *, with_edges: bool = False) -> Tuple[torch.Tensor, ...]:
    """``(y [B, T, D]`` in ``x``'s type, ``h_T [B, D, N]`` in fp32) on the
    card, and with ``with_edges`` the train variant's third output, the
    state entering each window (:func:`edges_shape`, fp32); raises if the
    launch is refused."""
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
        edges = torch.empty(edges_shape(Bsz, T, Dm, N), dtype=torch.float32,
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
    type), from the train variant's ``edges``: the carry (where T has more
    than one segment), the gradient and the fixed-order sums of its
    partials, on the plan of :func:`bwd_plan`.  The outputs and the
    scratch are allocated before any launch, so that a call can be
    captured in a CUDA graph; raises if a launch is refused."""
    Bsz, T, Dm = x.shape
    N = A.shape[1]
    plan = bwd_plan(Bsz, T, Dm, N)
    grads = tuple(torch.empty_like(t) for t in (x, delta, A, Bm, Cm, D))
    scratch = [torch.empty(shape, dtype=torch.float32, device=x.device)
               for shape in plan.scratch_shapes(Bsz, T, Dm, N).values()]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = bwd_library().mamba_scan_bwd_launch(
        *(t.data_ptr() for t in (x, delta, A, Bm, Cm, D, dy, edges, *grads,
                                 *scratch)),
        Bsz, T, Dm, N, plan.seg_len, plan.piece_len, plan.n_seg,
        plan.n_pieces, plan.n_blk, DTYPE_CODES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"mamba_scan_bwd CUDA launch failed: cudaError {rc}")
    return grads
