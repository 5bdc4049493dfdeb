"""Hand-written CUDA kernels for Hopper (sm_90a), one folder each:

  ref.py - the plain PyTorch version (CPU tensors, tests, the on-card oracle)
  ops.py - the wrapper: checks inputs, launches the kernel on CUDA tensors,
           counts launches; CPU tensors take ref.py

Sources live in ``repro_torch/csrc``; ``_build`` compiles them with nvcc.
"""
