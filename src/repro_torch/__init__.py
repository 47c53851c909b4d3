"""repro_torch — the bigset reproduction on PyTorch and CUDA.

The port of the JAX package :mod:`repro` to PyTorch, with the Pallas TPU
kernels rewritten by hand for Hopper.  It imports nothing of ``repro`` and
no ``jax``: the modules it shares with the JAX package are copies.  Entry
points run on the card unless the caller passes ``device="cpu"``.

Ported so far: the bigset serve path — ``core`` (with the dense interval
clock in ``core.vclock``), ``storage``, ``index``, ``query``, ``obs``,
``cluster``, ``serve.bigset_service``, ``launch.serve_bigset`` — with the
``dot_seen`` kernel; the ``clock_ops`` entry point; the model serve path
(``configs``, ``models``, ``serve.engine``, ``launch.serve``) with the
attention and scan kernels; and training of the dense, MoE, SSM and
hybrid families (``train``, ``checkpoint``, ``runtime``, ``launch.train``)
with the backward kernels of attention and of the scan.  ``ROADMAP.md``
lists what is left.
"""
# core before index: index.postings -> core -> bigset -> index.postings
from . import core  # noqa: F401
from . import index  # noqa: F401

__all__ = ["core", "index"]
