"""Tile-quantized matmul: the CUDA kernel's wrapper and its plain version.

Replaces ``matmul_pallas`` (``src/repro/kernels/matmul_tiled.py``, body
``matmul_kernel``) with ``csrc/matmul_tiled.cu``, whose mainloop
(``csrc/gemm_sm90.cuh``) it shares with ``moe_gmm``: a ring of four
shared-memory stages filled by TMA and drained by ``wgmma`` on the tensor
cores, fp32 accumulation, bf16 output. :func:`schedule` picks one of two
forms from M alone:

- prefill (M > ``DECODE_BLOCK_M``): one CTA per (128, 64) output tile,
  the whole of K looped inside it;
- decode (M <= ``DECODE_BLOCK_M``): one CTA per (64, 64) tile and K chunk
  of the fixed length ``SPLIT_K``; each chunk's fp32 partial goes to a
  workspace and the tile's last CTA sums them in chunk order. The chunks
  start at multiples of ``SPLIT_K`` whatever K and N are, so every
  output's sum order depends on K alone: a repeat is bit-equal, and a
  product cut to fewer rows of w (or columns) equals its zero-padded form.

Ragged M, N and K are masked in the kernel, so unlike ``repro``'s
``ops.matmul`` nothing is padded on the host. The grid is not persistent:
its CTA count (:func:`grid_blocks`) is the B of paper Eq. 3, and the wave
tail over the card's SMs shows in the kernel's time.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import build

NAME = "matmul_tiled"
BLOCK_M = 128         # the prefill tile; csrc/matmul_tiled.cu checks it
BLOCK_N = 64
DECODE_BLOCK_M = 64   # M at or below this takes the decode form
SPLIT_K = 256         # the decode form's K chunk
BLOCK_K = 64          # K per ring stage
# Each form's CTA as ``csrc/gemm_sm90.cuh`` builds it: threads, dynamic
# shared memory bytes, and the CTAs an SM holds at once (a prefill CTA asks
# for more than half of the SM's 228 KiB, so it runs alone on its SM, the
# one CTA an SM of paper Eq. 3; the 4-stage ring of the decode form leaves
# room for three). :func:`form` reads the same on the card, where it is
# checked against these; on the CPU it returns them.
FORMS = {"prefill": {"threads": 256, "smem_bytes": 117248, "ctas_per_sm": 1},
         "decode": {"threads": 256, "smem_bytes": 66640, "ctas_per_sm": 3}}

# the loads the last launch took: "tma", or "elementwise" where the base or
# the strides are not 16-byte aligned
LAST = {"loads": None}
# per device: the decode form's fp32 partials and its tile counters (zero
# between launches: the last CTA of a tile resets its own), shared by the
# launches of both GEMM wrappers in stream order; a buffer that grows keeps
# its predecessor alive, since a captured CUDA graph may still use it
_WS: Dict[int, torch.Tensor] = {}
_COUNTERS: Dict[int, torch.Tensor] = {}
_RETIRED: List[torch.Tensor] = []


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: (M, K) @ (K, N) accumulated in fp32, cast to x.dtype."""
    return (x.float() @ w.float()).to(x.dtype)


def kernel_form(m: int, k: int) -> Tuple[bool, int]:
    """(decode form?, number of K chunks) of an (m, k) @ (k, n) product."""
    if m <= DECODE_BLOCK_M:
        return True, -(-k // SPLIT_K)
    return False, 1 if k else 0


def schedule(m: int, n: int, k: int) -> Tuple[str, List[Tuple[int, int]]]:
    """The kernel's form for an (m, k) @ (k, n) product and the K ranges
    its CTAs sum, in the order their partials are added. N plays no part."""
    decode, splits = kernel_form(m, k)
    if decode:
        return "decode", [(i * SPLIT_K, min(k, (i + 1) * SPLIT_K))
                          for i in range(splits)]
    return "prefill", [(0, k)] * splits


def grid_blocks(m: int, n: int, k: int) -> int:
    """CTAs the kernel launches for (m, k) @ (k, n): paper Eq. 3's B, the
    decode form's K chunks included."""
    form, chunks = schedule(m, n, k)
    bm = DECODE_BLOCK_M if form == "decode" else BLOCK_M
    return -(-m // bm) * -(-n // BLOCK_N) * len(chunks)


def workspace(device: int, floats: int, tiles: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode form's scratch on CUDA device ``device``: at least
    ``floats`` fp32 partials and ``tiles`` zeroed int32 tile counters,
    cached per device. While a CUDA graph is being captured a buffer that
    must grow is allocated for the graph alone (it keeps what it
    allocates), and the cache is left as it is."""
    ws, cnt = _WS.get(device), _COUNTERS.get(device)
    if ws is not None and ws.numel() >= floats and cnt.numel() >= tiles:
        return ws, cnt
    dev = torch.device("cuda", device)
    if torch.cuda.is_current_stream_capturing():
        return (torch.empty(floats, dtype=torch.float32, device=dev),
                torch.zeros(tiles, dtype=torch.int32, device=dev))
    if ws is not None:
        _RETIRED.extend((ws, cnt))
    ws = torch.empty(max(floats, 1 << 20, 0 if ws is None else ws.numel()),
                     dtype=torch.float32, device=dev)
    cnt = torch.zeros(max(tiles, 1 << 16, 0 if cnt is None else cnt.numel()),
                      dtype=torch.int32, device=dev)
    _WS[device], _COUNTERS[device] = ws, cnt
    return ws, cnt


def raw_stream(device: int) -> int:
    """The current stream of CUDA device ``device``, as a pointer: the
    call that PyTorch's own Triton launches use, a few us cheaper than a
    device guard around ``torch.cuda.current_stream()``."""
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if get is None:
        return torch.cuda.current_stream(device).cuda_stream
    return get(device)


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.matmul_tiled_bf16.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                      ci, ci, vp]
    lib.matmul_tiled_bf16.restype = ci
    lib.matmul_tiled_error_string.argtypes = [ci]
    lib.matmul_tiled_error_string.restype = ctypes.c_char_p
    lib.matmul_tiled_form.argtypes = [ci, ci, vp]
    lib.matmul_tiled_form.restype = ci
    got = []
    for fn in (lib.matmul_tiled_block_m, lib.matmul_tiled_block_n,
               lib.matmul_tiled_decode_block_m, lib.matmul_tiled_split_k,
               lib.matmul_tiled_block_k):
        fn.argtypes = []
        fn.restype = ci
        got.append(fn())
    if got != [BLOCK_M, BLOCK_N, DECODE_BLOCK_M, SPLIT_K, BLOCK_K]:
        raise RuntimeError(f"matmul_tiled.cu tiles {got} differ from "
                           f"BLOCK_M, BLOCK_N, DECODE_BLOCK_M, SPLIT_K, "
                           f"BLOCK_K")


def read_form(name: str, bind, kind: str, device) -> dict:
    """Form ``kind`` ("prefill" or "decode") of the GEMM library ``name``
    (``matmul_tiled`` or ``moe_gmm``, bound by ``bind``) on ``device``:
    :data:`FORMS` on the CPU; on a CUDA device what ``<name>_form`` reads
    there, with registers and spilled bytes a thread."""
    if kind not in FORMS:
        raise ValueError(f"form kind {kind!r} not in {tuple(FORMS)}")
    dev = torch.device(device)
    if dev.type == "cpu":
        return dict(FORMS[kind])
    if dev.type != "cuda":
        raise ValueError(f"no GEMM form for device {dev}")
    lib = build.load(name, bind)
    out = (ctypes.c_int * 5)()
    err = getattr(lib, f"{name}_form")(int(kind == "decode"),
                                       dev.index or 0, out)
    if err:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name}_form({kind}) failed: {msg}")
    return dict(zip(("threads", "registers", "smem_bytes", "ctas_per_sm",
                     "spill_bytes"), out))


def form(kind: str, device="cuda") -> dict:
    """The kernel's form ``kind`` ("prefill" or "decode") on ``device``:
    threads a CTA, dynamic shared memory bytes and CTAs an SM holds (paper
    Eq. 3's CTAs an SM), plus registers and spilled bytes a thread on a
    CUDA device; :data:`FORMS` on the CPU."""
    return read_form(NAME, _bind, kind, device)


def matmul_tiled(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: x (M, K) bf16 @ w (K, N) bf16 -> (M, N) bf16,
    on CUDA tensors, on the current stream. Launches on one stream at a
    time per device: the decode form's scratch is shared."""
    if not (x.is_cuda and w.is_cuda) or x.device != w.device:
        raise ValueError(f"matmul_tiled: x and w must lie on one CUDA "
                         f"device, got {x.device} and {w.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"matmul_tiled: takes bf16, got {x.dtype} and "
                        f"{w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_tiled: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not multiply")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("matmul_tiled: x and w must be contiguous")
    m, k = x.shape
    n = w.shape[1]
    decode, splits = kernel_form(m, k)
    if -(-m // (DECODE_BLOCK_M if decode else BLOCK_M)) * splits > 65535:
        raise ValueError(f"matmul_tiled: M={m}, K={k} exceed the grid's y "
                         f"limit")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    dev = x.get_device()
    ws_p = cnt_p = 0
    if splits > 1:
        ws, cnt = workspace(dev, splits * m * n, -(-n // BLOCK_N))
        ws_p, cnt_p = ws.data_ptr(), cnt.data_ptr()
    vec = int(k % 8 == 0 and n % 8 == 0 and x.data_ptr() % 16 == 0
              and w.data_ptr() % 16 == 0)
    lib = build.load(NAME, _bind)
    r = lib.matmul_tiled_bf16(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                              ws_p, cnt_p, m, n, k, int(decode), splits, vec,
                              dev, raw_stream(dev))
    if r < 0:
        raise RuntimeError(f"matmul_tiled launch failed: "
                           f"{lib.matmul_tiled_error_string(-r).decode()}")
    LAST["loads"] = "tma" if r else "elementwise"
    build.LAUNCHES[NAME] += 1
    return out
