"""RG-LRU linear recurrence: the Triton kernel's wrapper and its plain
version (``repro.kernels.rglru``'s counterpart).

Both compute, per batch row and channel, in fp32::

    h_t = a_t * h_{t-1} + b_t,   h_{-1} = h0,   y_t = h_t

over (B, T, W) ``a`` and ``b`` and a (B, W) ``h0``, and return
``(y, h_last)``, ``h_last`` being ``y[:, -1]`` (``h0`` when T is 0).

``rglru_scan`` launches the Triton kernel that replaces ``rglru_pallas``
(``src/repro/kernels/rglru.py``, body ``_rglru_kernel``). The TPU kernel
walks a sequential (batch, width block, time chunk) grid and keeps ``h`` in
VMEM scratch between time chunks; on the card blocks run in parallel and in
no order, so one program owns a (batch row, ``BLOCK_W`` channels) strip and
loops over all of T itself, ``h`` in registers. The work is elementwise and
sequential in T, with no product and no reduction across channels: it is
bound by bytes (each step reads ``a_t``, ``b_t`` and writes ``y_t``, 12 B
per channel). A ragged W is masked, where the TPU wrapper asserts that W
divides into blocks.

The grid is B x ceil(W / BLOCK_W) programs: at recurrentgemma-2b's prefill
(B = 4, W = 2560) that is 80 programs on the H100's 132 SMs, less than one
wave, the paper's tail effect; the T loop is sequential inside each.

Triton is imported, and the kernel compiled, at the first launch
(``build.import_triton``), never when this module is imported.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build

__all__ = ["rglru_ref", "rglru_scan", "grid_programs"]

NAME = "rglru_scan"
BLOCK_W = 128     # channels per program (the TPU kernel's block_w)


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


def grid_programs(batch: int, width: int) -> int:
    """Programs the kernel launches: paper Eq. 3's B for this kernel."""
    return batch * -(-width // BLOCK_W)


# triton.language, bound by ``_kernel`` before the kernel is compiled (see
# ``staircase_fused``): importing it here would import triton with this
# module.
tl = None


def _rglru_kernel(a_ptr, b_ptr, h0_ptr, y_ptr, h_ptr, T, W,
                  BLOCK_W: tl.constexpr):
    row = tl.program_id(0)
    w = tl.program_id(1) * BLOCK_W + tl.arange(0, BLOCK_W)
    mask = w < W
    h = tl.load(h0_ptr + row * W + w, mask=mask, other=0.0)
    base = row.to(tl.int64) * T * W + w
    for t in range(T):
        off = base + t * W
        a = tl.load(a_ptr + off, mask=mask, other=0.0)
        b = tl.load(b_ptr + off, mask=mask, other=0.0)
        h = a * h + b
        tl.store(y_ptr + off, h, mask=mask)
    tl.store(h_ptr + row * W + w, h, mask=mask)


@functools.lru_cache(maxsize=None)
def _kernel():
    global tl
    triton = build.import_triton()
    import triton.language
    tl = triton.language
    return triton.jit(_rglru_kernel)


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
    kernel = _kernel()
    grid = (bsz, -(-w // BLOCK_W))
    with torch.cuda.device(a.device):
        kernel[grid](a, b, h0, y, h_last, t, w, BLOCK_W=BLOCK_W,
                     num_warps=4)
    build.LAUNCHES[NAME] += 1
    return y, h_last
