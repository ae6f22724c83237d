"""Hand-written kernels for Hopper — CUDA C++ in ``csrc/`` behind ``ctypes``
wrappers, Triton in ``staircase_fused`` and ``rglru`` — their plain PyTorch
versions, and the dispatch in ``ops``."""
