"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips where there is no CUDA device. On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul_tiled as mt
from repro_torch.models import transformer as tfm

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def randn(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda").bfloat16()


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (7, 33, 9), (63, 64, 65),
                                   (64, 64, 64), (65, 129, 63),
                                   (4, 1024, 2816), (512, 2816, 1024)])
def test_matmul_kernel_vs_plain(gen, m, k, n):
    x, w = randn(gen, m, k), randn(gen, k, n)
    before = ops.LAUNCHES["matmul_tiled"]
    got = mt.matmul_tiled(x, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["matmul_tiled"] == before + 1
    want = mt.matmul_ref(x, w).float()
    # one fp32 sum per output, rounded to bf16 in both: two bf16 steps
    tol = 2.0 ** -7 * max(want.abs().max().item(), 1.0)
    assert (got.float() - want).abs().max().item() <= tol


def test_matmul_kernel_unaligned_input(gen):
    """A 16-byte-misaligned x takes the kernel's element-wise loads."""
    m, k, n = 33, 64, 72
    buf = randn(gen, m * k + 1)
    x = buf[1:].view(m, k)
    w = randn(gen, k, n)
    got = mt.matmul_tiled(x, w).float()
    want = mt.matmul_ref(x, w).float()
    assert (got - want).abs().max().item() <= 2.0 ** -7 * want.abs().max()


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("mask,window", [("causal", 0), ("local", 40),
                                         ("none", 0)])
@pytest.mark.parametrize("b,sq,skv,h,kv", [(1, 1, 1, 2, 1),
                                           (2, 63, 63, 4, 4),
                                           (2, 65, 65, 4, 2),
                                           (1, 100, 200, 8, 2),
                                           (4, 128, 128, 16, 16)])
def test_flash_kernel_vs_plain(gen, dh, mask, window, b, sq, skv, h, kv):
    q, k, v = randn(gen, b, sq, h, dh), randn(gen, b, skv, kv, dh), \
        randn(gen, b, skv, kv, dh)
    got = fa.flash_attention(q, k, v, mask_kind=mask, window=window)
    torch.cuda.synchronize()
    want = fa.attention_ref(q, k, v, mask_kind=mask, window=window)
    assert (got.float() - want.float()).abs().max().item() <= 4e-2


def test_flash_kernel_causal_longer_queries(gen):
    """Rows past Skv see every key under a causal mask."""
    q, k, v = randn(gen, 1, 130, 4, 64), randn(gen, 1, 100, 2, 64), \
        randn(gen, 1, 100, 2, 64)
    got = fa.flash_attention(q, k, v)
    want = fa.attention_ref(q, k, v)
    assert (got.float() - want.float()).abs().max().item() <= 4e-2


def test_flash_kernel_refusals(gen):
    q = randn(gen, 1, 8, 2, 64)
    with pytest.raises(TypeError):
        fa.flash_attention(q.float(), q.float(), q.float())
    q32 = randn(gen, 1, 8, 2, 32)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q32, q32, q32)
    with pytest.raises(ValueError, match="local"):
        fa.flash_attention(q, q[:, :4].contiguous(), q[:, :4].contiguous(),
                           mask_kind="local", window=2)
    with pytest.raises(TypeError):
        mt.matmul_tiled(q.float().view(16, 64), q.float().view(64, 16))


def test_prefill_on_kernels_vs_plain(gen):
    cfg = reduced_config(get_config("qwen1.5-0.5b"), n_layers=2,
                         d_model=256, n_heads=4, d_ff=512, vocab=250)
    params = tfm.cast_params(tfm.init_params(cfg, gen), "cuda")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(3, 37))).cuda()
    ops.reset_launches()
    got, _ = tfm.forward(params, cfg, tokens=toks, mode="prefill")
    assert ops.LAUNCHES == {"matmul_tiled": 3 * cfg.n_layers,
                            "flash_attention": cfg.n_layers}
    want, _ = tfm.forward(params, cfg, tokens=toks, mode="prefill",
                          force="plain")
    v = cfg.vocab_size
    err = (got[..., :v].float() - want[..., :v].float()).abs().max().item()
    assert err <= 4e-2 * max(1.0, want[..., :v].float().abs().max().item())
