"""modppl_tpu_torch: the PyTorch / CUDA port of modppl_tpu.

The sub-packages mirror ``modppl_tpu`` (``core``, ``dists``, ``modeling``,
``inference``, ``parallel``, ``ops``, ``models``) so every module has an
obvious counterpart in the JAX package, which stays the reference. The port
imports ``torch`` and never ``jax``.

Its hand-written CUDA kernels live in ``csrc/`` and are built by
``ops/_build.py`` at first use on a CUDA tensor. On CPU tensors each kernel
wrapper runs the kernel's plain PyTorch version instead.
"""
