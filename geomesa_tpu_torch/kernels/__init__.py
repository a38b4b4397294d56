"""Hand-written CUDA kernels for Hopper and their wrappers.

Each kernel's source lives in ``csrc/`` and builds with nvcc at first use
(``build.py``); its wrapper module checks inputs, launches on PyTorch's
current stream, counts launches, and runs the plain PyTorch version only for
tensors on the CPU.
"""
