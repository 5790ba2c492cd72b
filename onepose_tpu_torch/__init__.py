"""PyTorch port of onepose_tpu's frame→pose path, for NVIDIA Hopper.

The JAX package ``onepose_tpu`` is the reference; this package mirrors its
layout (``models/``, ``ops/``, ``pipeline.py``, ``inference.py``) and never
imports JAX. Its hand-written CUDA kernels live in ``csrc/`` and are built
at first use by ``ops._kernels``.
"""
