"""Hand-written CUDA kernels for Hopper (``csrc/``), their ``ctypes``
wrappers, their plain PyTorch versions, and the dispatch in ``ops``."""
