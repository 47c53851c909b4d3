"""Hand-written Hopper kernels of the port, each beside its plain version.

* ``dot_seen`` — batched dot-membership filter (the bigset read fold),
  CUDA C++ in ``dot_seen/csrc/dot_seen.cu``;
* ``flash_attention`` — blocked prefill attention (causal / sliding
  window, GQA), CUDA C++ in ``flash_attention/csrc/flash_attention.cu``,
  and its backward (training, through a ``torch.autograd.Function``) in
  ``flash_attention/csrc/flash_attention_bwd.cu``;
* ``decode_attention`` — one token against a KV cache, CUDA C++ in
  ``decode_attention/csrc/decode_attention.cu``;
* ``mamba_scan`` — the Mamba-1 selective scan, returning the final state
  beside ``y``, CUDA C++ in ``mamba_scan/csrc/mamba_scan.cu``; its
  ``mamba_step`` (one decode token) is plain PyTorch;
* ``clock_ops`` — the interval clock lattice (``join``, ``subtract``,
  ``intersect``: a boundary-sweep run merge; ``popcount``), CUDA C++ in
  ``clock_ops/csrc/clock_ops.cu``.

This package imports none of them (``dot_seen`` and ``clock_ops`` pull in
``core``): import the subpackage, e.g. ``from repro_torch.kernels.mamba_scan
import mamba_scan``.  Each subpackage is ``kernel.py`` (builds the CUDA
source and launches it),
``ops.py`` (the public wrapper: plain version for CPU tensors, the kernel
for CUDA tensors, a :class:`~.ledger.DispatchStats` ledger) and ``ref.py``
(the plain PyTorch version).
"""
