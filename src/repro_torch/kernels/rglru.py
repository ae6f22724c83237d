"""RG-LRU linear recurrence: the CUDA kernel's wrapper and its plain version
(``repro.kernels.rglru``'s counterpart).

Both compute, per batch row and channel, in fp32::

    h_t = a_t * h_{t-1} + b_t,   h_{-1} = h0,   y_t = h_t

over (B, T, W) ``a`` and ``b`` and a (B, W) ``h0``, and return
``(y, h_last)``, ``h_last`` being ``y[:, -1]`` (``h0`` when T is 0).

``rglru_scan`` launches ``csrc/rglru_scan.cu``, which replaces
``rglru_pallas`` (``src/repro/kernels/rglru.py:43``, body
``_rglru_kernel``). The TPU kernel walks a sequential (batch, width block,
time chunk) grid and keeps ``h`` in VMEM scratch between time chunks; on
the card blocks run in parallel and in no order, so one CTA of 4 warps owns
a (batch row, 32 channels) strip for all of T. The work is bound by bytes
(each step reads ``a_t``, ``b_t`` and writes ``y_t``, 12 B a channel), and
what bounds a sequential walk of T is the latency of its loads: the Triton
kernel this replaced waited for each step's loads in turn, and its time grew
with T, not with W (``PERF.md`` §6). So the kernel keeps
windows of ``window`` steps in flight in a ring of ``stages`` shared-memory
slots, loaded by TMA or by ``cp.async`` (a ragged W, or a base not 16-byte
aligned); within a window each warp scans a quarter from zero, the warps'
carries are folded in order, and each warp re-walks its quarter from its
carry and writes ``y``. :func:`form` is the host's choice of those sizes.
A ragged W and T are masked, where the TPU wrapper asserts that W divides
into blocks.

``rglru_ref`` is the plain version: the sequential recurrence in torch.

The backward (:func:`rglru_scan_bwd`, ``csrc/rglru_scan_bwd.cu``) has no
Pallas counterpart: ``repro`` trains through plain JAX. From the forward's
``a``, its output ``y``, ``h0`` and the gradients ``dy`` and ``dh_last`` it
walks the reverse recurrence ``g_t = dy_t + a_{t+1} g_{t+1}`` (``g_{T-1} =
dy_{T-1} + dh_last``) and returns ``da_t = g_t y_{t-1}`` (``h0`` at t =
0), ``db_t = g_t`` and ``dh0 = a_0 g_0``: a thread per (batch row,
channel), each block of steps' loads issued at once. Its plain version
:func:`rglru_bwd_ref` rounds each product and sum where the kernel does,
so the two are bit-equal on the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["rglru_ref", "rglru_scan", "form", "rglru_bwd_ref",
           "rglru_scan_bwd"]

NAME = "rglru_scan"
NAME_BWD = "rglru_scan_bwd"
CHANNELS = 32      # channels a CTA (one lane each); csrc/rglru_scan.cu
WARPS = 4          # checks these three
MAX_STAGES = 2     # ring slots; more measured no faster (PERF.md §6)
WINDOWS = (32, 64, 128)   # window steps the kernel is compiled for


def rglru_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """Plain version: the sequential recurrence in fp32 on the inputs'
    device (``repro.kernels.ref.rglru_ref``)."""
    h = h0.float()
    af, bf = a.float(), b.float()
    ys = []
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        ys.append(h)
    if not ys:
        return af.new_empty(a.shape), h
    return torch.stack(ys, dim=1), h


def rglru_bwd_ref(a: torch.Tensor, y: torch.Tensor, h0: torch.Tensor,
                  dy: torch.Tensor, dh_last=None):
    """Plain backward in fp32: (da, db (B, T, W), dh0 (B, W)) from the
    forward's ``a``, output ``y`` and ``h0`` and the gradients ``dy`` and
    ``dh_last`` (None: zeros). T = 0 passes ``dh_last`` through to dh0."""
    af, yf, dyf = a.float(), y.float(), dy.float()
    ag = torch.zeros_like(h0, dtype=torch.float32) if dh_last is None \
        else dh_last.float()
    da, db = torch.empty_like(af), torch.empty_like(af)
    for t in reversed(range(a.shape[1])):
        g = dyf[:, t] + ag
        db[:, t] = g
        da[:, t] = g * (yf[:, t - 1] if t else h0.float())
        ag = af[:, t] * g
    return da, db, ag


def smem_bytes(window: int, stages: int) -> int:
    """Dynamic shared memory of a CTA: 128 B of alignment slack, the ring
    (stages x {a, b} x window x CHANNELS fp32), an mbarrier per slot, the
    warps' carry maps and the hand-over of h between windows."""
    return (128 + stages * 2 * window * CHANNELS * 4 + 8 * MAX_STAGES
            + WARPS * CHANNELS * 8 + CHANNELS * 4)


def form(b: int, t: int, w: int, *, aligned: bool = True) -> dict:
    """The kernel's form for (B, T, W) inputs, chosen on the host: CTAs
    (one per batch row and strip of ``CHANNELS`` channels), channels a CTA,
    warps, window steps (the smallest of ``WINDOWS`` that holds T, else the
    largest), ring slots (``MAX_STAGES``, or fewer where T takes fewer
    windows), dynamic shared memory bytes, and the copy route: ``"tma"``
    where W is a
    multiple of 4 (16-byte rows) and the bases are 16-byte aligned
    (``aligned``), else ``"cp.async"``."""
    ctas = b * -(-w // CHANNELS)
    window = next((s for s in WINDOWS if s >= t), WINDOWS[-1])
    windows = max(1, -(-t // window))
    stages = min(windows, MAX_STAGES)
    return {"ctas": ctas, "channels": CHANNELS, "warps": WARPS,
            "window": window, "stages": stages,
            "smem_bytes": smem_bytes(window, stages),
            "route": "tma" if aligned and w % 4 == 0 else "cp.async"}


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan_forward.argtypes = [vp] * 5 + [ci] * 6 + [vp]
    lib.rglru_scan_forward.restype = ci
    lib.rglru_scan_error_string.argtypes = [ci]
    lib.rglru_scan_error_string.restype = ctypes.c_char_p
    lib.rglru_scan_attrs.argtypes = [ci, ci, ctypes.POINTER(ci)]
    lib.rglru_scan_attrs.restype = ci
    for fn in (lib.rglru_scan_channels, lib.rglru_scan_warps,
               lib.rglru_scan_max_stages):
        fn.argtypes = []
        fn.restype = ci
    if (lib.rglru_scan_channels(), lib.rglru_scan_warps(),
            lib.rglru_scan_max_stages()) != (CHANNELS, WARPS, MAX_STAGES):
        raise RuntimeError("rglru_scan.cu limits differ from CHANNELS / "
                           "WARPS / MAX_STAGES")


def attrs(window: int, stages: int) -> dict:
    """The compiled kernel at this window and ring on the current CUDA
    device (``cudaFuncGetAttributes`` and the occupancy API): threads a
    CTA, registers a thread, dynamic shared memory bytes, CTAs an SM
    holds, bytes spilled a thread."""
    lib = build.load(NAME, _bind)
    out = (ctypes.c_int * 5)()
    err = lib.rglru_scan_attrs(window, stages, out)
    if err:
        msg = lib.rglru_scan_error_string(err).decode()
        raise RuntimeError(f"rglru_scan_attrs({window}, {stages}) failed: "
                           f"{msg}")
    return dict(zip(("threads", "registers", "smem_bytes", "ctas_per_sm",
                     "spill_bytes"), out))


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """Launch the kernel on the current stream: (B, T, W) fp32 ``a`` and
    ``b`` and a (B, W) fp32 ``h0``, contiguous, on one CUDA device ->
    (y (B, T, W) fp32, h_last (B, W) fp32). Checks nothing that needs the
    host to wait, so it can be captured in a CUDA graph."""
    args = (a, b, h0)
    if not all(t.is_cuda and t.device == a.device for t in args):
        raise ValueError("rglru_scan: a, b and h0 must lie on one CUDA "
                         "device")
    if any(t.dtype != torch.float32 for t in args):
        raise TypeError(f"rglru_scan: takes fp32, got {a.dtype}, {b.dtype} "
                        f"and {h0.dtype}")
    if a.dim() != 3 or b.shape != a.shape or h0.shape != (a.shape[0],
                                                          a.shape[2]):
        raise ValueError(f"rglru_scan: a and b must be (B, T, W) and h0 "
                         f"(B, W), got {tuple(a.shape)}, {tuple(b.shape)} "
                         f"and {tuple(h0.shape)}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("rglru_scan: inputs must be contiguous")
    bsz, t, w = a.shape
    if bsz > 2 ** 31 - 1 or w * t >= 2 ** 31 or bsz * w >= 2 ** 31:
        raise ValueError(f"rglru_scan: shape {tuple(a.shape)} out of range")
    y = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    if bsz == 0 or w == 0:
        return y, h_last
    if t == 0:
        return y, h_last.copy_(h0)
    f = form(bsz, t, w, aligned=a.data_ptr() % 16 == 0
             and b.data_ptr() % 16 == 0)
    lib = build.load(NAME, _bind)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rglru_scan_forward(
            a.data_ptr(), b.data_ptr(), h0.data_ptr(), y.data_ptr(),
            h_last.data_ptr(), bsz, t, w, f["window"], f["stages"],
            int(f["route"] == "tma"), stream)
    if err:
        raise RuntimeError(f"rglru_scan launch failed: "
                           f"{lib.rglru_scan_error_string(err).decode()}")
    build.LAUNCHES[NAME] += 1
    return y, h_last


def _bind_bwd(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan_backward.argtypes = [vp] * 8 + [ci] * 3 + [vp]
    lib.rglru_scan_backward.restype = ci
    lib.rglru_scan_bwd_error_string.argtypes = [ci]
    lib.rglru_scan_bwd_error_string.restype = ctypes.c_char_p
    lib.rglru_scan_bwd_attrs.argtypes = [ctypes.POINTER(ci)]
    lib.rglru_scan_bwd_attrs.restype = ci


def bwd_attrs() -> dict:
    """The compiled backward kernel on the current CUDA device: threads a
    CTA, registers a thread, CTAs an SM holds, bytes spilled a thread."""
    lib = build.load(NAME_BWD, _bind_bwd)
    out = (ctypes.c_int * 4)()
    err = lib.rglru_scan_bwd_attrs(out)
    if err:
        msg = lib.rglru_scan_bwd_error_string(err).decode()
        raise RuntimeError(f"rglru_scan_bwd_attrs failed: {msg}")
    return dict(zip(("threads", "registers", "ctas_per_sm", "spill_bytes"),
                    out))


def rglru_scan_bwd(a: torch.Tensor, y: torch.Tensor, h0: torch.Tensor,
                   dy: torch.Tensor, dh_last=None):
    """Launch the backward kernel on the current stream: (B, T, W) fp32
    ``a``, ``y`` (the forward's output) and ``dy``, (B, W) fp32 ``h0`` and
    ``dh_last`` (or None), contiguous, on one CUDA device -> (da, db
    (B, T, W), dh0 (B, W)) fp32. One launch, counted under ``NAME_BWD``."""
    states = (h0,) + (() if dh_last is None else (dh_last,))
    args = (a, y, dy) + states
    if not all(t.is_cuda and t.device == a.device for t in args):
        raise ValueError("rglru_scan_bwd: every input must lie on one CUDA "
                         "device")
    if any(t.dtype != torch.float32 for t in args):
        raise TypeError("rglru_scan_bwd: takes fp32")
    if a.dim() != 3 or y.shape != a.shape or dy.shape != a.shape or any(
            t.shape != (a.shape[0], a.shape[2]) for t in states):
        raise ValueError(f"rglru_scan_bwd: a, y and dy must be (B, T, W) and "
                         f"h0, dh_last (B, W), got {tuple(a.shape)}, "
                         f"{tuple(y.shape)}, {tuple(dy.shape)}, "
                         f"{tuple(h0.shape)}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("rglru_scan_bwd: inputs must be contiguous")
    bsz, t, w = a.shape
    if bsz >= 2 ** 31 or w * t >= 2 ** 31:
        raise ValueError(f"rglru_scan_bwd: shape {tuple(a.shape)} out of "
                         f"range")
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty_like(h0)
    if bsz == 0 or w == 0:
        return da, db, dh0
    if t == 0:
        return da, db, dh0.zero_() if dh_last is None else dh0.copy_(dh_last)
    lib = build.load(NAME_BWD, _bind_bwd)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rglru_scan_backward(
            a.data_ptr(), y.data_ptr(), h0.data_ptr(), dy.data_ptr(),
            None if dh_last is None else dh_last.data_ptr(), da.data_ptr(),
            db.data_ptr(), dh0.data_ptr(), bsz, t, w, stream)
    if err:
        raise RuntimeError(f"rglru_scan_bwd launch failed: "
                           f"{lib.rglru_scan_bwd_error_string(err).decode()}")
    build.LAUNCHES[NAME_BWD] += 1
    return da, db, dh0
