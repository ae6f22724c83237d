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
0), ``db_t = g_t`` and ``dh0 = a_0 g_0``. A CTA of one warp owns a
(batch row, strip of 32 channels) pair, a lane a channel, and walks T from
the end in windows that a ring of shared-memory slots brings in ahead of
the walk (TMA, or ``cp.async`` where the forward's route rules say so),
``y`` one step earlier than ``a`` and ``dy`` so a step's ``y_{t-1}`` lies
in its slot; on the TMA route ``da`` and ``db`` go out of the slot by TMA
stores. :func:`bwd_form` picks the window and the ring's depth so that
the grid takes the fewest waves of SMs (paper Eq. 3). Its plain version :func:`rglru_bwd_ref` rounds each product
and sum where the kernel does, so the two are bit-equal on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

__all__ = ["rglru_ref", "rglru_scan", "form", "rglru_bwd_ref",
           "bwd_form", "rglru_scan_bwd"]

NAME = "rglru_scan"
NAME_BWD = "rglru_scan_bwd"
CHANNELS = 32      # channels a CTA (one lane each); csrc/rglru_scan.cu
WARPS = 4          # checks these three
MAX_STAGES = 2     # ring slots; more measured no faster (PERF.md §6)
WINDOWS = (32, 64, 128)   # window steps the kernel is compiled for
# the backward's compiled forms (csrc/rglru_scan_bwd.cu; _bind_bwd checks
# them): a CTA of one warp, a lane a channel, window steps, and 1 to
# BWD_MAX_STAGES ring slots within a CTA's shared memory
BWD_CHANNELS = 32
BWD_WINDOWS = (32, 64)
BWD_MAX_STAGES = 4
MAX_SMEM = 232448       # a CTA's shared memory on sm_90
# what an SM of sm_90 holds, for counting CTAs an SM: shared memory
# reserved a CTA, CTAs, threads and registers resident at once; and the
# most registers a thread of the backward kernel takes (its launch bounds)
CTA_RESERVED_SMEM = 1024
MAX_CTAS_SM = 32
MAX_THREADS_SM = 2048
REGISTERS_SM = 65536
BWD_MAX_REGISTERS = 128


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


def bwd_smem_bytes(window: int, stages: int) -> int:
    """Dynamic shared memory of a backward CTA: 128 B of alignment slack,
    the ring (stages x {a, dy, y} x window x ``BWD_CHANNELS`` fp32) and an
    mbarrier a slot."""
    return 128 + stages * 3 * window * BWD_CHANNELS * 4 + 8 * BWD_MAX_STAGES


def bwd_forms() -> list:
    """Every (window, stages) the backward kernel is compiled for."""
    return [(tw, s) for tw in BWD_WINDOWS
            for s in range(1, BWD_MAX_STAGES + 1)
            if bwd_smem_bytes(tw, s) <= MAX_SMEM]


def bwd_ctas_per_sm(smem: int, smem_per_sm: Optional[int] = None) -> int:
    """Backward CTAs of ``smem`` bytes of dynamic shared memory an SM
    holds at once (``core.gpu.H100_SXM``'s shared memory when None), at
    ``BWD_MAX_REGISTERS`` a thread: the compiled kernel holds at least as
    many (``bwd_attrs``)."""
    from repro_torch.core.gpu import H100_SXM
    smem_per_sm = H100_SXM.smem_per_sm if smem_per_sm is None \
        else smem_per_sm
    return min(smem_per_sm // (smem + CTA_RESERVED_SMEM), MAX_CTAS_SM,
               MAX_THREADS_SM // BWD_CHANNELS,
               REGISTERS_SM // (BWD_CHANNELS * BWD_MAX_REGISTERS))


def bwd_form(b: int, t: int, w: int, *, aligned: bool = True,
             sms: Optional[int] = None,
             smem_per_sm: Optional[int] = None) -> dict:
    """The backward kernel's form for (B, T, W) inputs, chosen on the host
    by paper Eq. 3 over ``sms`` SMs (``core.gpu.H100_SXM``'s when None).
    The grid is one CTA per batch row and strip of ``BWD_CHANNELS``
    channels; over the compiled forms (:func:`bwd_forms`) with no more
    ring slots than T has windows, it takes the one with the fewest waves
    of ``sms`` x CTAs an SM, then the most steps in flight a CTA (window x
    slots, up to T), then the smaller window. Returns its CTAs, channels,
    window steps, ring slots, dynamic shared memory bytes, the host's
    prediction of CTAs an SM, waves and the busiest SM's CTAs
    (``ceil(CTAs / sms)``), and the copy route (``"tma"`` where W is a
    multiple of 4 and the bases are 16-byte aligned, ``aligned``; else
    ``"cp.async"``, as :func:`form`)."""
    from repro_torch.core.gpu import H100_SXM
    from repro_torch.core.tail_model import ceil_div
    sms = H100_SXM.sm_count if sms is None else sms
    ctas = b * ceil_div(w, BWD_CHANNELS)
    best = None
    for window, stages in bwd_forms():
        if stages > max(1, ceil_div(t, window)):
            continue
        smem = bwd_smem_bytes(window, stages)
        per_sm = bwd_ctas_per_sm(smem, smem_per_sm)
        waves = ceil_div(ctas, sms * per_sm)
        key = (waves, -min(window * stages, t), window)
        if best is None or key < best[0]:
            best = (key, {"ctas": ctas, "channels": BWD_CHANNELS,
                          "window": window, "stages": stages,
                          "smem_bytes": smem, "ctas_per_sm": per_sm,
                          "waves": waves,
                          "busiest_ctas": ceil_div(ctas, sms)})
    f = best[1]
    f["route"] = "tma" if aligned and w % 4 == 0 else "cp.async"
    return f


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
    lib.rglru_scan_backward.argtypes = [vp] * 8 + [ci] * 6 + [vp]
    lib.rglru_scan_backward.restype = ci
    lib.rglru_scan_bwd_error_string.argtypes = [ci]
    lib.rglru_scan_bwd_error_string.restype = ctypes.c_char_p
    lib.rglru_scan_bwd_attrs.argtypes = [ci] * 3 + [ctypes.POINTER(ci)]
    lib.rglru_scan_bwd_attrs.restype = ci
    lib.rglru_scan_bwd_smem.argtypes = [ci] * 2
    lib.rglru_scan_bwd_smem.restype = ci
    for fn in (lib.rglru_scan_bwd_channels, lib.rglru_scan_bwd_max_stages):
        fn.argtypes = []
        fn.restype = ci
    # the compiled forms and their shared memory are bwd_form's
    compiled = {(tw, s): lib.rglru_scan_bwd_smem(tw, s)
                for tw in (16,) + BWD_WINDOWS + (128,)
                for s in range(1, BWD_MAX_STAGES + 2)}
    want = {k: bwd_smem_bytes(*k) if k in bwd_forms() else -1
            for k in compiled}
    if (lib.rglru_scan_bwd_channels(), lib.rglru_scan_bwd_max_stages()) \
            != (BWD_CHANNELS, BWD_MAX_STAGES) or compiled != want:
        raise RuntimeError("rglru_scan_bwd.cu forms differ from "
                           "BWD_CHANNELS / BWD_WINDOWS / BWD_MAX_STAGES / "
                           "bwd_smem_bytes")


def bwd_attrs(window: int, stages: int, route: str = "tma") -> dict:
    """The compiled backward kernel in a form, on a route, on the current
    CUDA device (``cudaFuncGetAttributes`` and the occupancy API): threads
    a CTA, registers a thread, dynamic shared memory bytes, CTAs an SM
    holds, bytes spilled a thread."""
    lib = build.load(NAME_BWD, _bind_bwd)
    out = (ctypes.c_int * 5)()
    err = lib.rglru_scan_bwd_attrs(window, stages, int(route == "tma"), out)
    if err:
        msg = lib.rglru_scan_bwd_error_string(err).decode()
        raise RuntimeError(f"rglru_scan_bwd_attrs({window}, {stages}, "
                           f"{route}) failed: {msg}")
    return dict(zip(("threads", "registers", "smem_bytes", "ctas_per_sm",
                     "spill_bytes"), out))


def rglru_scan_bwd(a: torch.Tensor, y: torch.Tensor, h0: torch.Tensor,
                   dy: torch.Tensor, dh_last=None):
    """Launch the backward kernel on the current stream: (B, T, W) fp32
    ``a``, ``y`` (the forward's output) and ``dy``, (B, W) fp32 ``h0`` and
    ``dh_last`` (or None), contiguous, on one CUDA device -> (da, db
    (B, T, W), dh0 (B, W)) fp32. One launch, counted under ``NAME_BWD``."""
    return launch_bwd(a, y, h0, dy, dh_last)


def launch_bwd(a: torch.Tensor, y: torch.Tensor, h0: torch.Tensor,
               dy: torch.Tensor, dh_last=None, form=None):
    """:func:`rglru_scan_bwd` in a given form: ``form`` (a dict with
    ``window``, ``stages`` and ``route``) or, where None,
    :func:`bwd_form`'s. The TMA route needs W a multiple of 4 and 16-byte
    aligned bases, else raises. Counted under ``NAME_BWD``."""
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
    aligned = all(x.data_ptr() % 16 == 0 for x in (a, y, dy))
    f = bwd_form(bsz, t, w, aligned=aligned) if form is None else form
    if f["route"] == "tma" and not (aligned and w % 4 == 0):
        raise ValueError("rglru_scan_bwd: the TMA route needs W % 4 == 0 "
                         "and 16-byte aligned a, y and dy")
    lib = build.load(NAME_BWD, _bind_bwd)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rglru_scan_backward(
            a.data_ptr(), y.data_ptr(), h0.data_ptr(), dy.data_ptr(),
            None if dh_last is None else dh_last.data_ptr(), da.data_ptr(),
            db.data_ptr(), dh0.data_ptr(), bsz, t, w, f["window"],
            f["stages"], int(f["route"] == "tma"), stream)
    if err:
        raise RuntimeError(f"rglru_scan_bwd launch failed: "
                           f"{lib.rglru_scan_bwd_error_string(err).decode()}")
    build.LAUNCHES[NAME_BWD] += 1
    return da, db, dh0
