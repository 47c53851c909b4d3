"""repro_torch — the bigset reproduction on PyTorch and CUDA.

The port of the JAX package :mod:`repro` to PyTorch, with the Pallas TPU
kernels rewritten by hand for Hopper.  It imports nothing of ``repro`` and
no ``jax``: the modules it shares with the JAX package are copies.  Entry
points run on the card unless the caller passes ``device="cpu"``.

Ported so far: the bigset serve path — ``core`` (with the dense interval
clock in ``core.vclock``), ``storage``, ``index``, ``query``, ``obs``,
``cluster`` (without ``membership``), ``serve.bigset_service``,
``launch.serve_bigset`` — and the ``dot_seen`` CUDA kernel.
"""
# core before index: index.postings -> core -> bigset -> index.postings
from . import core  # noqa: F401
from . import index  # noqa: F401

__all__ = ["core", "index"]
