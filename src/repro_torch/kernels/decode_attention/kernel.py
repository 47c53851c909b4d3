"""CUDA kernels for Hopper: one query token against a KV cache, split-KV.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention/kernel.py``
(``decode_attention_pallas`` → ``_decode_kernel``).  The kernels are in
``csrc/decode_attention.cu``: ``decode_attention_kernel_split`` cuts each
row's cache into splits of ``L`` slots (:func:`plan_splits`, from the
shapes alone), one block per (split, kv head, batch row) reading
``cache_len`` on the device and streaming only the valid slots, each
writing a partial (max, sum, accumulator) to fp32 scratch
(:func:`scratch_shapes`); ``decode_attention_kernel_combine`` merges a
row's partials into the output.  A block serves at most 8 query heads
of its kv head's group: a larger group (``mistral-large-123b``'s 96 over
8 heads, G = 12) is cut into ``n_chunks`` chunks of blocks; the
launcher reports the grid it launched, and :data:`LAUNCHES` counts every
launch by it.  The source note gives the bound.

This module builds the source with ``nvcc`` at first use (see
:mod:`repro_torch.kernels.build`) and launches both kernels through
:mod:`ctypes` on PyTorch's current stream.  It does not synchronise, and it
allocates only the output and the scratch.  Callers go through
:func:`repro_torch.kernels.decode_attention.ops.decode_attention`, which
checks the arguments.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from ..build import load
from ..flash_attention.kernel import DTYPE_CODES

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"


# The split kernel's grid should fill every SM of an H100 (132) twice.
SMS = 132
MIN_BLOCKS = 2 * SMS
SPLIT_QUANTUM = 64


class Launch(NamedTuple):
    """A launch of the split kernel as the launcher reported it."""
    grid: tuple[int, int, int]  # (splits, Hkv * n_chunks, B)
    gmax: int                   # the query heads a block is built for
    chunk_heads: int            # the query heads a block serves
    n_chunks: int               # blocks a kv head's group is cut into


# Every launch of the split kernel, counted by its :class:`Launch`.
LAUNCHES: collections.Counter = collections.Counter()


def launches_by_group() -> dict[str, int]:
    """:data:`LAUNCHES` by whether a kv head's group of query heads was
    cut across blocks (``chunked``: a group above 8) or not (``whole``)."""
    out = {"whole": 0, "chunked": 0}
    for launch, n in LAUNCHES.items():
        out["chunked" if launch.n_chunks > 1 else "whole"] += n
    return out


def plan_splits(S: int, Hkv: int, B: int) -> tuple[int, int]:
    """``(L, n_splits)``: the cache's ``S`` slots cut into ``n_splits``
    splits of ``L`` slots, ``L`` a power-of-two multiple of 64 — the
    largest that still gives ``n_splits * Hkv * B >= MIN_BLOCKS`` blocks,
    or 64 where no ``L`` does.  Shapes only: ``cache_len`` stays on the
    device."""
    L = SPLIT_QUANTUM
    while L < S and -(-S // (2 * L)) * Hkv * B >= MIN_BLOCKS:
        L *= 2
    return L, -(-S // L)


def scratch_shapes(B: int, Hq: int, Hkv: int, S: int,
                   D: int) -> dict[str, tuple[int, ...]]:
    """The fp32 scratch the wrapper allocates: per (row, q head, split) the
    partial's max and sum (``ml``) and its accumulator (``acc``)."""
    _, n_splits = plan_splits(S, Hkv, B)
    return {"ml": (B, Hq, n_splits, 2), "acc": (B, Hq, n_splits, D)}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library (compiled on first call, then cached)."""
    lib = load(SOURCE)
    fn = lib.decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return lib


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, cache_len: torch.Tensor,
                          *, window: Optional[int],
                          scale: float) -> torch.Tensor:
    """``[B, Hq, D]`` on the card; raises if the launch is refused."""
    B, Hq, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    L, n_splits = plan_splits(S, Hkv, B)
    shapes = scratch_shapes(B, Hq, Hkv, S, D)
    out = torch.empty_like(q)
    part_ml = torch.empty(shapes["ml"], dtype=torch.float32, device=q.device)
    part_acc = torch.empty(shapes["acc"], dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    launched = (ctypes.c_int * 5)()
    rc = library().decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        cache_len.data_ptr(), out.data_ptr(), part_ml.data_ptr(),
        part_acc.data_ptr(), B, Hq, Hkv, S, D, L, n_splits,
        ctypes.c_float(scale), -1 if window is None else int(window),
        DTYPE_CODES[q.dtype], stream, launched)
    if rc != 0:
        raise RuntimeError(
            f"decode_attention CUDA launch failed: cudaError {rc}")
    LAUNCHES[Launch(tuple(launched[:3]), launched[3], launched[4],
                    launched[1] // Hkv)] += 1
    return out
