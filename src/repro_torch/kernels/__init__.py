"""Hand-written Hopper kernels of the port, each beside its plain version.

* ``dot_seen`` — batched dot-membership filter (the bigset read fold),
  CUDA C++ in ``dot_seen/csrc/dot_seen.cu``.

Each subpackage is ``kernel.py`` (builds the CUDA source and launches it),
``ops.py`` (the public wrapper: plain version for CPU tensors, the kernel
for CUDA tensors) and ``ref.py`` (the plain PyTorch version).
"""
