"""Small VGG-style convnet, the paper's Table 2 testbed
(``repro.models.convnet``'s counterpart).

Widths are set per conv layer so that the pruning baselines (HRank, SOFT)
and the tail-effect optimizer can resize it. The parameter layout is
``repro``'s: ``conv{i}`` holds ``kernel`` (HWIO, 3x3) and ``bias``;
``head`` holds ``w`` and ``b``, so ``interop.params_from_jax`` carries the
reference's params across unchanged.

A conv is the im2col product that ``repro``'s docstring gives:
(B*H*W, 9*Cin) @ (9*Cin, Cout), the columns built from the SAME-padded
NHWC input in (kh, kw, cin) order, so that ``kernel.reshape(9*Cin, Cout)``
is the right operand. The wave-quantization ``LayerShape`` of conv layer i
is then tokens = B*H_i*W_i, d_in = 9*Cin_i, width = Cout_i
(:func:`conv_layer_shapes`). The product follows ``x.dtype``, as
``repro`` casts the kernel to it:

- fp32 (training and eval, as in ``repro``): ``torch.matmul`` in fp32.
  ``repro`` computes this conv outside any Pallas kernel. It assumes
  ``torch.get_float32_matmul_precision()`` is ``"highest"`` (PyTorch's
  default), so the card does not round the operands to TF32;
- any other dtype (bf16 at inference): ``ops.matmul``, which on the card
  is ``matmul_tiled`` (the hand-written Hopper GEMM) and on the CPU its
  plain version, as every MLP projection of the LMs. K (9*Cin) and N
  (Cout) are zero-padded to multiples of 8 so that every row is a
  multiple of 16 bytes and the GEMM takes its TMA loads at any width; N
  is sliced back after the product. Padding to 8 leaves ceil(N / 64) and
  the decode form's K chunks (multiples of 256) as they were, so the
  grid is the B that ``CtaWaveModel`` prices. This route has no
  gradient (a ctypes launch has none), so it raises on a tensor that
  requires grad rather than detach it silently.

The head stays ``torch.matmul``, as ``repro`` computes it outside any
kernel.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import PARAM_DTYPE, dense_init

# Conv widths straddle lane-tile (128) boundaries so the staircase has
# stairs to climb, as VGG16's 64..512 filter range (paper Table 2).
DEFAULT_WIDTHS = (128, 192, 320, 448)
# the kernel route pads K and N to multiples of this (16-byte bf16 rows)
ALIGN = 8


def conv_names(widths=None) -> list:
    widths = widths or DEFAULT_WIDTHS
    return [f"conv{i}" for i in range(len(widths))]


def init_convnet(gen: torch.Generator, widths=None, n_classes: int = 10,
                 in_channels: int = 3, image: int = 32) -> dict:
    """Random params on ``gen``'s device, with ``repro``'s fan-in scaling
    (the draws are not ``jax.random``'s)."""
    widths = tuple(widths or DEFAULT_WIDTHS)
    params: dict = {}
    cin = in_channels
    for i, w in enumerate(widths):
        params[f"conv{i}"] = {
            "kernel": dense_init(gen, (3, 3, cin, w), in_axis_size=9 * cin),
            "bias": torch.zeros((w,), dtype=PARAM_DTYPE, device=gen.device),
        }
        cin = w
    # spatial: pool /2 after every 2 convs
    feat = image // (2 ** (len(widths) // 2))
    params["head"] = {
        "w": dense_init(gen, (feat * feat * cin, n_classes)),
        "b": torch.zeros((n_classes,), dtype=PARAM_DTYPE, device=gen.device),
    }
    return params


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def im2col(x: torch.Tensor, k: Optional[int] = None) -> torch.Tensor:
    """(B, H, W, C) -> (B*H*W, k) columns of the 3x3 SAME conv, in (kh, kw,
    cin) order, zero columns after the 9*C taps up to ``k`` (9*C when
    None)."""
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = [xp[:, i:i + h, j:j + w, :] for i in range(3) for j in range(3)]
    if k is not None and k > 9 * c:
        taps.append(x.new_zeros((b, h, w, k - 9 * c)))
    return torch.cat(taps, dim=-1).reshape(b * h * w, -1)


def conv_operand(kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The kernel route's weight: (3, 3, Cin, Cout) -> (9*Cin, Cout) in
    ``dtype``, zero-padded to multiples of ``ALIGN`` both ways."""
    k9, cout = 9 * kernel.shape[2], kernel.shape[3]
    wm = kernel.reshape(k9, cout).to(dtype)
    return F.pad(wm, (0, _round_up(cout, ALIGN) - cout,
                      0, _round_up(k9, ALIGN) - k9)).contiguous()


def conv_operands(params: dict, dtype: torch.dtype) -> list:
    """Every conv layer's :func:`conv_operand`, built once for repeated
    forwards (``forward_convnet(operands=)``)."""
    out = []
    while f"conv{len(out)}" in params:
        out.append(conv_operand(params[f"conv{len(out)}"]["kernel"], dtype))
    return out


def conv3x3(x: torch.Tensor, kernel: torch.Tensor, *,
            operand: Optional[torch.Tensor] = None,
            force: Optional[str] = None, loads: Optional[list] = None
            ) -> torch.Tensor:
    """The 3x3 SAME conv at stride 1 of NHWC ``x`` by the HWIO ``kernel``
    as one im2col product (see the module docstring for its two routes).
    ``operand`` is the kernel route's prepared weight (built from
    ``kernel`` when None); ``force`` goes to ``ops.matmul``; ``loads``, a
    list, gets the loads the kernel route's launch took (None where the
    plain version ran)."""
    b, h, w, cin = x.shape
    cout = kernel.shape[-1]
    if x.dtype == torch.float32:
        y = im2col(x) @ kernel.reshape(9 * cin, cout).to(x.dtype)
        return y.reshape(b, h, w, cout)
    wm = conv_operand(kernel, x.dtype) if operand is None else operand
    cols = im2col(x, wm.shape[0])
    if torch.is_grad_enabled() and (cols.requires_grad or wm.requires_grad):
        raise RuntimeError(
            "convnet: the kernel route (ops.matmul) has no gradient; run it "
            "under torch.no_grad(), or train in fp32")
    y = ops.matmul(cols, wm, force=force)
    if loads is not None:
        from repro_torch.kernels import matmul_tiled as mt
        loads.append(mt.LAST["loads"] if y.is_cuda and force is None
                     else None)
    return y[:, :cout].reshape(b, h, w, cout)


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool at stride 2, VALID, over NHWC."""
    b, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def forward_convnet(params: dict, x: torch.Tensor,
                    collect_acts: bool = False, *,
                    operands: Optional[list] = None,
                    force: Optional[str] = None,
                    loads: Optional[list] = None):
    """x: (B, H, W, C). Returns (logits, acts dict). ``operands``
    (:func:`conv_operands` in ``x.dtype``), ``force`` and ``loads`` go to
    each :func:`conv3x3`."""
    acts = {}
    i = 0
    while f"conv{i}" in params:
        p = params[f"conv{i}"]
        x = conv3x3(x, p["kernel"], force=force, loads=loads,
                    operand=None if operands is None else operands[i])
        x = torch.relu(x + p["bias"].to(x.dtype))
        if collect_acts:
            acts[f"conv{i}"] = x
        if i % 2 == 1:
            x = max_pool2(x)
        i += 1
    x = x.reshape(x.shape[0], -1)
    logits = x @ params["head"]["w"].to(x.dtype) \
        + params["head"]["b"].to(x.dtype)
    return logits, acts


def convnet_loss(params: dict, batch: dict):
    """(mean cross-entropy, accuracy), both fp32 0-dim tensors."""
    logits, _ = forward_convnet(params, batch["images"])
    lf = logits.float()
    labels = batch["labels"].long()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, 1, labels[:, None])[:, 0]
    loss = torch.mean(logz - gold)
    acc = torch.mean((torch.argmax(lf, -1) == labels).float())
    return loss, acc


def prune_convnet(params: dict, indices: dict) -> dict:
    """Structured prune: keep the given output-filter indices per layer,
    slicing the next layer's input channels to match."""
    out = {}
    prev_keep = None
    i = 0
    while f"conv{i}" in params:
        p = params[f"conv{i}"]
        kern = p["kernel"]
        if prev_keep is not None:
            kern = kern[:, :, prev_keep, :]
        keep = indices.get(f"conv{i}")
        if keep is not None:
            prev_keep = torch.as_tensor(np.asarray(keep), dtype=torch.long,
                                        device=kern.device)
            kern = kern[..., prev_keep]
            bias = p["bias"][prev_keep]
        else:
            bias = p["bias"]
            prev_keep = None
        out[f"conv{i}"] = {"kernel": kern, "bias": bias}
        i += 1
    # head input: channels interleaved with spatial dims (feat*feat*C)
    head_w = params["head"]["w"]
    if prev_keep is not None:
        cin_old = params[f"conv{i - 1}"]["kernel"].shape[-1]
        spatial = head_w.shape[0] // cin_old
        hw = head_w.reshape(spatial, cin_old, -1)[:, prev_keep]
        head_w = hw.reshape(spatial * len(prev_keep), -1)
    out["head"] = {"w": head_w, "b": params["head"]["b"]}
    return out


@functools.lru_cache(maxsize=8)
def _class_patterns(n_classes: int, image: int) -> np.ndarray:
    return np.random.default_rng(1234).standard_normal(
        (n_classes, image, image, 3)).astype(np.float32)


def synthetic_cifar(step: int, batch: int = 64, image: int = 32,
                    n_classes: int = 10, seed: int = 0, device="cpu"):
    """Learnable synthetic image task: class k = base pattern k + noise.
    ``repro``'s numpy draws, bit for bit: fp32 images and int32 labels, as
    tensors on ``device``."""
    rng = np.random.default_rng((seed, step))
    base = _class_patterns(n_classes, image)
    labels = rng.integers(0, n_classes, size=(batch,))
    images = base[labels] + 0.8 * rng.standard_normal(
        (batch, image, image, 3)).astype(np.float32)
    return {"images": torch.from_numpy(images).to(device),
            "labels": torch.from_numpy(labels.astype(np.int32)).to(device)}


def conv_layer_shapes(widths, batch: int = 64, image: int = 32,
                      in_channels: int = 3, shard: int = 1):
    """LayerShape list for the tail model (im2col mapping)."""
    from repro_torch.core.tail_model import LayerShape
    out = []
    cin = in_channels
    hw = image
    for i, w in enumerate(widths):
        out.append(LayerShape(
            name=f"conv{i}", tokens=batch * hw * hw, d_in=9 * cin,
            width=w, shard_out=shard))
        cin = w
        if i % 2 == 1:
            hw //= 2
    return out


def count_conv_params(widths, in_channels: int = 3, image: int = 32,
                      n_classes: int = 10) -> int:
    total = 0
    cin = in_channels
    for w in widths:
        total += 9 * cin * w + w
        cin = w
    feat = image // (2 ** (len(widths) // 2))
    total += feat * feat * cin * n_classes + n_classes
    return total


def count_conv_flops(widths, batch: int = 1, image: int = 32,
                     in_channels: int = 3) -> float:
    total = 0.0
    cin = in_channels
    hw = image
    for i, w in enumerate(widths):
        total += 2.0 * batch * hw * hw * 9 * cin * w
        cin = w
        if i % 2 == 1:
            hw //= 2
    return total
