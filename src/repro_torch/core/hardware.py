"""Hardware specifications for the wave-quantization (tail-effect) model
(``repro.core.hardware``'s counterpart: the four TPU entries unchanged, plus
``H100_SXM``, the card the port runs on, and the other GPU platforms of
paper Tables 4/5, defined in ``core.gpu``).

The paper parameterizes its latency model by the GPU's SM count ``S``
(Titan-V: 80, P6000: 30, Jetson Nano: 1).  On TPU the scheduling granule is
not an SM wave but a *tile*: the MXU consumes 128x128 systolic tiles, the VPU
operates on (sublane x lane) = (8, 128) fp32 / (16, 128) bf16 registers, and a
mesh axis of size ``n`` quantizes a sharded dimension to ``ceil(d / n)`` per
device.  ``HardwareSpec`` carries everything the tail model and the roofline
need, so the same optimizer runs unchanged across platforms (paper Tables 4/5:
"no one-fit-all DNN configuration exists even for the same model running on
different GPU platforms").
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-chip constants used by the tail model and roofline."""

    name: str
    # Roofline terms (per chip).
    peak_flops_bf16: float        # FLOP/s
    hbm_bandwidth: float          # bytes/s
    ici_bandwidth_per_link: float  # bytes/s, one direction per link
    ici_links: int                # links per chip participating in a ring
    hbm_bytes: int                # HBM capacity per chip
    vmem_bytes: int               # VMEM (fast scratch) per core

    # Quantization granules (the TPU analogue of the paper's SM count S).
    mxu_dim: int = 128            # systolic array is mxu_dim x mxu_dim
    lane: int = 128               # last-dim vector register quantum
    sublane_fp32: int = 8         # second-to-last-dim quantum, fp32
    sublane_bf16: int = 16        # second-to-last-dim quantum, bf16
    cores_per_chip: int = 1       # TensorCores (v4 megacore fuses 2 -> 1 logical)

    def sublane(self, dtype_bits: int) -> int:
        return self.sublane_fp32 if dtype_bits >= 32 else self.sublane_bf16

    @property
    def ici_bandwidth(self) -> float:
        """Aggregate ICI bytes/s per chip (all links)."""
        return self.ici_bandwidth_per_link * self.ici_links


# Graded target platform (constants fixed by the assignment brief).
TPU_V5E = HardwareSpec(
    name="tpu_v5e",
    peak_flops_bf16=197e12,
    hbm_bandwidth=819e9,
    ici_bandwidth_per_link=50e9,
    ici_links=4,
    hbm_bytes=16 * 1024**3,
    vmem_bytes=128 * 1024**2,
)

# Additional platforms for the generality study (paper Tables 4/5 analogue).
TPU_V4 = HardwareSpec(
    name="tpu_v4",
    peak_flops_bf16=275e12,
    hbm_bandwidth=1228e9,
    ici_bandwidth_per_link=50e9,
    ici_links=6,
    hbm_bytes=32 * 1024**3,
    vmem_bytes=128 * 1024**2,
)

TPU_V5P = HardwareSpec(
    name="tpu_v5p",
    peak_flops_bf16=459e12,
    hbm_bandwidth=2765e9,
    ici_bandwidth_per_link=100e9,
    ici_links=6,
    hbm_bytes=95 * 1024**3,
    vmem_bytes=128 * 1024**2,
)

# A deliberately small "embedded-class" spec, mirroring the paper's Jetson
# Nano row: one skinny core, to show the optimizer adapts the quantum.
TPU_LITE = HardwareSpec(
    name="tpu_lite",
    peak_flops_bf16=10e12,
    hbm_bandwidth=100e9,
    ici_bandwidth_per_link=0.0,
    ici_links=0,
    hbm_bytes=4 * 1024**3,
    vmem_bytes=32 * 1024**2,
)

# The card the port serves on and the other GPU platforms of Tables 4/5,
# each a ``gpu.GpuSpec``: the tail model's GPU form
# (``tail_model.CtaWaveModel``) plans for them. Imported here, after
# ``HardwareSpec``, which ``gpu`` subclasses.
from repro_torch.core.gpu import GPU_PLATFORMS, H100_SXM  # noqa: E402,F401

REGISTRY: Dict[str, HardwareSpec] = {
    s.name: s for s in (TPU_V5E, TPU_V4, TPU_V5P, TPU_LITE, *GPU_PLATFORMS)
}


def get_hardware(name: str) -> HardwareSpec:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown hardware {name!r}; available: {sorted(REGISTRY)}"
        ) from None
