"""Hand-written kernels for Hopper — CUDA C++ in ``csrc/`` behind ``ctypes``
wrappers (``matmul_tiled``, ``flash_attention``, ``rwkv6``, ``moe_gmm``),
Triton in ``staircase_fused`` and ``rglru`` — their plain PyTorch
versions, and the dispatch in ``ops``."""
