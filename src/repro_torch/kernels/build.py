"""Build and load the port's kernels.

Each ``csrc/<name>.cu`` holds one kernel behind a plain C interface; the
headers ``csrc/*.cuh`` hold what several share (``gemm_sm90.cuh``, the GEMM
mainloop of ``matmul_tiled`` and ``moe_gmm``; ``rwkv6_common.cuh``, the
TF32 split, ``mma.sync`` and ``cp.async`` helpers of ``rwkv6`` and
``rwkv6_bwd``; ``rglru_common.cuh``, the ``cp.async`` helpers and the
tensor map of ``rglru_scan`` and ``rglru_scan_bwd``). It is compiled with
``nvcc``
into ``<name>-<hash>.so`` under the build directory (``build/kernels`` at
the repo root, or ``$REPRO_TORCH_BUILD_DIR``) the first time its wrapper
runs, and loaded with ``ctypes``. The file name carries a hash of the
source, of every header and of the flags, so an edited source or header
builds anew and an unchanged one is built once per checkout. Nothing is
built when this module is imported: the CPU tests import every module and
have no ``nvcc``.

The Triton kernels (``TRITON_KERNELS``: kernel name -> the module under
``kernels/`` that launches it) are compiled by Triton at their first launch; :func:`import_triton` points Triton's cache at
``build/triton`` under the repo root (unless ``$TRITON_CACHE_DIR`` is set)
before it imports Triton, so the compiled kernel stays in the gitignored
``build/``.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a wrapper adds
one right after the launch returned without error, and nowhere else. Each
counts one per call: a product in the decode form of ``matmul_tiled`` or
``moe_gmm`` sums its K chunks inside the same launch, and a call of
``flash_attention_bwd`` is one launch of both its roles, and a call of
``adamw`` is its three passes. The matmul
backward's products launch ``matmul_tiled``'s kernel and count under
``matmul_tiled_bwd``, the grouped matmul's launch ``moe_gmm``'s and count
under ``moe_gmm_bwd``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

CUDA_SOURCES = ("matmul_tiled", "flash_attention", "rwkv6",  # csrc/<name>.cu
                "moe_gmm", "rglru_scan", "flash_attention_bwd",
                "rglru_scan_bwd", "rwkv6_bwd")
TRITON_KERNELS = {"staircase_fused": "staircase_fused",      # kernels/<v>.py
                  "staircase_cta": "staircase_fused", "adamw": "adamw"}
# launches counted apart from their library's name: the backward's products
# of the matmul (csrc/matmul_tiled.cu) and of the grouped matmul
# (csrc/moe_gmm.cu)
EXTRA_COUNTS = ("matmul_tiled_bwd", "moe_gmm_bwd")
LAUNCHES: Dict[str, int] = {k: 0 for k in CUDA_SOURCES
                            + tuple(TRITON_KERNELS) + EXTRA_COUNTS}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR",
                               REPO_ROOT / "build" / "kernels"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the port's CUDA "
        "kernels are built on the machine that has the card")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return build_dir() / f"{name}-{digest[:16]}.so"


def compile_source(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists."""
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)      # atomic: a concurrent build sees all or none
    return out


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use.
    ``bind`` sets ``argtypes``/``restype`` of its functions once."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(compile_source(name)))
            bind(lib)
            _LIBS[name] = lib
        return lib


def import_triton():
    """The ``triton`` module, with its kernel cache under ``build/triton``
    unless the caller set ``$TRITON_CACHE_DIR``. Raises where Triton is
    missing: a CUDA tensor then has no kernel to take."""
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(REPO_ROOT / "build" / "triton"))
    try:
        import triton
    except ImportError as e:
        raise RuntimeError(
            "triton is not installed: the port's Triton kernels run on the "
            "machine that has the card") from e
    return triton


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
