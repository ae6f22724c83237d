"""PyTorch and CUDA port of ``repro`` for NVIDIA Hopper.

It keeps ``repro``'s module names and parameter layout, imports neither JAX
nor ``repro``, and runs its kernels on the card (``csrc/``)."""
