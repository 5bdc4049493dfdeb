"""PyTorch/CUDA port of the Nitsum serving system for one NVIDIA H100.

Mirrors ``repro`` module by module; ``repro`` (JAX) stays the reference.
The package imports torch and nothing of JAX or of ``repro``.
"""
