"""Hand-written kernels for Hopper — CUDA C++ in ``csrc/`` behind ``ctypes``
wrappers (``matmul_tiled``, ``flash_attention``, ``rwkv6``, ``moe_gmm``,
``rglru``), Triton in ``staircase_fused`` — their plain PyTorch versions,
and the dispatch in ``ops``."""
