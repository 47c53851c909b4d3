"""Carry state from the JAX package into the port, as plain data.

The two packages share no objects, but their storage encodes keys and
values identically, so a state built by one can be replayed into the other
and both can answer the same queries.  The inputs are numpy arrays and
``(key, value)`` byte pairs — never objects of ``repro``.
"""
from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from .core.bigset import BigsetVnode
from .core.vclock import DenseClock
from .device import DeviceLike, resolve_device
from .storage.lsm import LsmStore


def dense_clock_from_numpy(starts, ends, device: DeviceLike = None) -> DenseClock:
    """A dense interval clock from ``int32[A, R]`` run arrays (for example
    ``np.asarray`` of a JAX ``DenseClock``'s fields), placed on ``device``."""
    dev = resolve_device(device)
    s = np.asarray(starts, dtype=np.int32)
    e = np.asarray(ends, dtype=np.int32)
    if s.ndim != 2 or s.shape != e.shape:
        raise ValueError("starts/ends must share one [A, R] shape")
    # torch.tensor copies: the arrays may be read-only views of JAX buffers
    return DenseClock(torch.tensor(s, device=dev), torch.tensor(e, device=dev))


def vnode_from_items(actor, items: Iterable[Tuple[bytes, bytes]]) -> BigsetVnode:
    """A port vnode holding exactly ``items`` — the ``(key, value)`` pairs
    of another vnode's ``store.scan()`` — written as one atomic batch."""
    store = LsmStore()
    store.put_batch([(bytes(k), bytes(v)) for k, v in items])
    return BigsetVnode(actor, store=store)
