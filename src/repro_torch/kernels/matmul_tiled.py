"""Tile-quantized matmul: the CUDA kernel's wrapper and its plain version.

Replaces ``matmul_pallas`` (``src/repro/kernels/matmul_tiled.py``, body
``matmul_kernel``) with ``csrc/matmul_tiled.cu``, whose mainloop
(``csrc/gemm_sm90.cuh``) it shares with ``moe_gmm``: a ring of four
shared-memory stages filled by TMA and drained by ``wgmma`` on the tensor
cores, fp32 accumulation, bf16 output. :func:`schedule` picks one of two
forms from M alone:

- prefill (M > ``DECODE_BLOCK_M``): one CTA per output tile of one of
  ``PREFILL_TILES`` ((64, 64), (128, 64) or (256, 64) rows x columns; the
  caller's ``tile``, (128, 64) when it names none), the whole of K looped
  inside it, one CTA an SM whatever the tile. The tile autotuner
  (``kernels.autotune``) picks one by paper Eq. 3 over the card's SMs. A
  tile changes which CTA computes an output, not the order of its K sum;
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
NAME_BWD = "matmul_tiled_bwd"   # the backward's dX and dW products
BLOCK_M = 128         # the default prefill tile; csrc/matmul_tiled.cu checks
BLOCK_N = 64
DECODE_BLOCK_M = 64   # M at or below this takes the decode form
SPLIT_K = 256         # the decode form's K chunk
BLOCK_K = 64          # K per ring stage
# (rows, columns) of the output tile a CTA computes: the prefill tiles,
# smallest first (csrc/gemm_sm90.cuh's PREFILL_TILES; the library is
# checked against them), the default one, and the decode form's one tile
PREFILL_TILES = ((64, BLOCK_N), (128, BLOCK_N), (256, BLOCK_N))
DEFAULT_TILE = (BLOCK_M, BLOCK_N)
DECODE_TILE = (DECODE_BLOCK_M, BLOCK_N)
# Each form's CTA, per (form, tile), as ``csrc/gemm_sm90.cuh`` builds it:
# threads, dynamic shared memory bytes, and the CTAs an SM holds at once
# (every prefill tile asks for more than half of the SM's 228 KiB, so it
# runs alone on its SM, the one CTA an SM of paper Eq. 3; the 4-stage ring
# of the decode form leaves room for three). :func:`form` reads the same on
# the card, where it is checked against these; on the CPU it returns them.
FORMS = {("prefill", (64, 64)): {"threads": 256, "smem_bytes": 117248,
                                 "ctas_per_sm": 1},
         ("prefill", (128, 64)): {"threads": 256, "smem_bytes": 117248,
                                  "ctas_per_sm": 1},
         ("prefill", (256, 64)): {"threads": 256, "smem_bytes": 164944,
                                  "ctas_per_sm": 1},
         ("decode", (64, 64)): {"threads": 256, "smem_bytes": 66640,
                                "ctas_per_sm": 3}}

# the loads the last launch took ("tma", or "elementwise" where the base or
# the strides are not 16-byte aligned); ``ops.TILES`` records its tile
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


def matmul_bwd_ref(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    """Plain version of the backward of ``x @ w``: (dX = dY W^T, dW = X^T
    dY), each accumulated in fp32 and cast to its input's dtype."""
    return ((dy.float() @ w.float().T).to(x.dtype),
            (x.float().T @ dy.float()).to(w.dtype))


def matmul_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
               need=(True, True)):
    """The backward of ``x @ w`` on the kernel: dX = dY @ W^T and dW = X^T
    @ dY (where ``need`` asks for them), each a launch of
    :func:`matmul_tiled` on the default tile, counted under ``NAME_BWD``.
    The kernel reads both operands K-major, so W^T and X^T are transposed
    copies made contiguous first (dY is contiguous already)."""
    dy = dy.contiguous()
    dx = matmul_tiled(dy, w.t().contiguous(), count=NAME_BWD) \
        if need[0] else None
    dw = matmul_tiled(x.t().contiguous(), dy, count=NAME_BWD) \
        if need[1] else None
    return dx, dw


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


def launch_tile(m: int, tile=None) -> Tuple[int, int]:
    """The output tile an (m, k) @ (k, n) product launches with: in the
    decode form (m <= ``DECODE_BLOCK_M``) its one tile, ``DECODE_TILE``;
    else ``tile``, ``DEFAULT_TILE`` when None. Raises for a tile the form
    does not have."""
    if m <= DECODE_BLOCK_M:
        if tile is not None and tuple(tile) != DECODE_TILE:
            raise ValueError(f"the decode form (M={m}) has the one tile "
                             f"{DECODE_TILE}, not {tuple(tile)}")
        return DECODE_TILE
    t = DEFAULT_TILE if tile is None else tuple(int(v) for v in tile)
    if t not in PREFILL_TILES:
        raise ValueError(f"no prefill tile {t}: the kernel has "
                         f"{PREFILL_TILES}")
    return t


def grid_blocks(m: int, n: int, k: int, tile=None) -> int:
    """CTAs the kernel launches for (m, k) @ (k, n) on ``tile`` (as
    :func:`launch_tile` resolves it): paper Eq. 3's B, the decode form's K
    chunks included."""
    _, chunks = schedule(m, n, k)
    bm, bn = launch_tile(m, tile)
    return -(-m // bm) * -(-n // bn) * len(chunks)


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
                                      ci, ci, ci, vp]
    lib.matmul_tiled_bf16.restype = ci
    lib.matmul_tiled_error_string.argtypes = [ci]
    lib.matmul_tiled_error_string.restype = ctypes.c_char_p
    lib.matmul_tiled_form.argtypes = [ci, ci, ci, vp]
    lib.matmul_tiled_form.restype = ci
    check_tiles(lib, "matmul_tiled")
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


def check_tiles(lib: ctypes.CDLL, name: str) -> None:
    """Raise unless the library ``name``'s prefill tiles (``<name>_tiles``)
    are :data:`PREFILL_TILES`' rows."""
    fn = getattr(lib, f"{name}_tiles")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    buf = (ctypes.c_int * 8)()
    n = fn(buf, 8)
    got = list(buf[:min(n, 8)])
    if got != [t[0] for t in PREFILL_TILES]:
        raise RuntimeError(f"{name}.cu prefill tiles {got} differ from "
                           f"PREFILL_TILES {PREFILL_TILES}")


def form_key(kind: str, tile=None) -> Tuple[str, Tuple[int, int]]:
    """The :data:`FORMS` key of form ``kind`` on ``tile`` (the form's
    default tile when None)."""
    if kind == "decode":
        t = DECODE_TILE if tile is None else tuple(tile)
    elif kind == "prefill":
        t = DEFAULT_TILE if tile is None else tuple(tile)
    else:
        raise ValueError(f"form kind {kind!r} not in ('prefill', 'decode')")
    if (kind, t) not in FORMS:
        raise ValueError(f"the {kind} form has no tile {t}")
    return kind, t


def read_form(name: str, bind, kind: str, device, tile=None) -> dict:
    """Form ``kind`` ("prefill" or "decode") on ``tile`` of the GEMM
    library ``name`` (``matmul_tiled`` or ``moe_gmm``, bound by ``bind``)
    on ``device``: its :data:`FORMS` entry on the CPU; on a CUDA device
    what ``<name>_form`` reads there, with registers and spilled bytes a
    thread."""
    key = form_key(kind, tile)
    dev = torch.device(device)
    if dev.type == "cpu":
        return dict(FORMS[key])
    if dev.type != "cuda":
        raise ValueError(f"no GEMM form for device {dev}")
    lib = build.load(name, bind)
    out = (ctypes.c_int * 5)()
    err = getattr(lib, f"{name}_form")(int(kind == "decode"), key[1][0],
                                       dev.index or 0, out)
    if err:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name}_form({kind}, {key[1]}) failed: {msg}")
    return dict(zip(("threads", "registers", "smem_bytes", "ctas_per_sm",
                     "spill_bytes"), out))


def form(kind: str, device="cuda", tile=None) -> dict:
    """The kernel's form ``kind`` ("prefill" or "decode") on ``tile`` (the
    form's default when None) on ``device``: threads a CTA, dynamic shared
    memory bytes and CTAs an SM holds (paper Eq. 3's CTAs an SM), plus
    registers and spilled bytes a thread on a CUDA device; :data:`FORMS`
    on the CPU."""
    return read_form(NAME, _bind, kind, device, tile)


def matmul_tiled(x: torch.Tensor, w: torch.Tensor, tile=None, *,
                 count: str = NAME) -> torch.Tensor:
    """Launch the kernel: x (M, K) bf16 @ w (K, N) bf16 -> (M, N) bf16,
    on CUDA tensors, on the current stream, on ``tile`` (one of
    ``PREFILL_TILES``, ``DEFAULT_TILE`` when None; the decode form's one
    tile at M <= ``DECODE_BLOCK_M``). A tile the kernel does not have
    raises. Launches on one stream at a time per device: the decode form's
    scratch is shared. The launch counts under ``count`` in
    ``build.LAUNCHES`` (``NAME_BWD`` for the backward's products)."""
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
    bm = launch_tile(m, tile)[0]
    if -(-m // bm) * splits > 65535:
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
                              bm, dev, raw_stream(dev))
    if r < 0:
        raise RuntimeError(f"matmul_tiled launch failed: "
                           f"{lib.matmul_tiled_error_string(-r).decode()}")
    LAST["loads"] = "tma" if r else "elementwise"
    build.LAUNCHES[count] += 1
    return out
