"""Plain PyTorch versions of the port's kernels: the contract each kernel
must match (``repro.kernels.ref``'s counterpart). Each is defined beside its
kernel's wrapper and collected here."""

from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.matmul_tiled import matmul_ref
from repro_torch.kernels.moe_gmm import moe_gmm_ref
from repro_torch.kernels.rglru import rglru_ref
from repro_torch.kernels.rwkv6 import rwkv6_ref
from repro_torch.kernels.staircase_fused import staircase_ref

__all__ = ["attention_ref", "matmul_ref", "moe_gmm_ref", "rglru_ref",
           "rwkv6_ref", "staircase_ref"]
