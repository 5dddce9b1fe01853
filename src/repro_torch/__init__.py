"""PyTorch/CUDA port of the Lance structural-encodings reproduction.

A package of its own beside the JAX reference ``repro``: it imports torch,
numpy and the standard library, never jax and nothing of ``repro``.  Its
layout mirrors the reference's (``core``, ``store``, ``dataset``,
``kernels``), so each module's counterpart sits at the same path.
"""
