"""The GPU's spec for the tail model's GPU form (paper Eq. 3 over SMs).

``repro`` maps the paper's SM count S onto a TPU's tile (``hardware.py``).
On a GPU the paper's own quantities come back: a non-persistent kernel's
grid of B thread blocks (CTAs) runs in waves of S SMs times the CTAs an SM
holds at once, L = dL * ceil(B / S). ``GpuSpec`` is a ``HardwareSpec`` (so
``fused_coeffs``, the roofline terms and ``table_cache.hardware_fingerprint``
read it as they read a TPU's) whose defaults are the H100 SXM5 data sheet;
``cores_per_chip`` is the SM count S, ``vmem_bytes`` the shared memory an SM
has. ``lane`` and the sublanes keep the port's GEMM output tile
(``kernels.matmul_tiled``), so the TPU-form model still reads a GPU spec.
``tail_model.CtaWaveModel`` is the model a GPU spec selects.

``repro_torch.core.hardware`` imports ``H100_SXM`` from here into its
registry; it defines ``HardwareSpec`` before it does, and the package's
``__init__`` imports it first, so the cycle resolves.
"""

from __future__ import annotations

import dataclasses
import functools

from repro_torch.core.hardware import HardwareSpec
from repro_torch.kernels.matmul_tiled import BLOCK_M, BLOCK_N


@dataclasses.dataclass(frozen=True)
class GpuSpec(HardwareSpec):
    """A CUDA card: S SMs (``cores_per_chip``), shared memory per SM
    (``vmem_bytes``), L2, HBM bytes and bandwidth, the bf16 peak."""

    name: str = "h100_sxm"
    peak_flops_bf16: float = 989e12      # dense bf16 tensor cores
    hbm_bandwidth: float = 3.35e12       # HBM3
    ici_bandwidth_per_link: float = 0.0  # no ICI; NVLink is not modeled
    ici_links: int = 0
    hbm_bytes: int = 80 * 10**9          # 80 GB HBM3
    vmem_bytes: int = 228 * 1024         # shared memory per SM (Hopper)
    mxu_dim: int = BLOCK_N               # no systolic array: the GEMM tile
    lane: int = BLOCK_N                  # the GEMM's output-tile columns
    sublane_fp32: int = BLOCK_M          # the GEMM's prefill tile rows,
    sublane_bf16: int = BLOCK_M          # for every dtype
    cores_per_chip: int = 132            # SMs of the SXM5 part
    l2_bytes: int = 50 * 10**6           # L2 cache

    @property
    def sm_count(self) -> int:
        """S of paper Eq. 3."""
        return self.cores_per_chip

    @property
    def smem_per_sm(self) -> int:
        return self.vmem_bytes

    @classmethod
    def from_device(cls, device="cuda") -> "GpuSpec":
        """The spec of a CUDA card as PyTorch reads it: its SM count,
        shared memory per SM, L2 and memory; the peak and the bandwidth
        stay the SXM5 data sheet's (a PCIe H100 has 114 SMs)."""
        import torch
        props = torch.cuda.get_device_properties(torch.device(device))
        base = cls()
        return cls(
            name=f"cuda:{props.name}",
            cores_per_chip=int(props.multi_processor_count),
            vmem_bytes=int(getattr(props, "shared_memory_per_multiprocessor",
                                   base.vmem_bytes)),
            l2_bytes=int(getattr(props, "L2_cache_size", base.l2_bytes)),
            hbm_bytes=int(props.total_memory))


@functools.lru_cache(maxsize=None)
def device_spec(device: int) -> GpuSpec:
    """``GpuSpec.from_device`` of CUDA device ``device``, read once: the
    spec a kernel wrapper prices its grid with at each launch."""
    return GpuSpec.from_device(f"cuda:{device}")


def is_gpu(hw: HardwareSpec) -> bool:
    """True for a spec that selects the tail model's GPU form."""
    return isinstance(hw, GpuSpec)


# The card the port serves on: SXM5 data-sheet defaults.
H100_SXM = GpuSpec()
