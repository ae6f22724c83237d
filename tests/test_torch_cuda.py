"""The port's CUDA and Triton kernels on the card, against their plain
versions, and the planner on the card against the same planner on the CPU.

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
from repro_torch.kernels import staircase_fused as sf
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
                            "flash_attention": cfg.n_layers,
                            "staircase_fused": 0}
    want, _ = tfm.forward(params, cfg, tokens=toks, mode="prefill",
                          force="plain")
    v = cfg.vocab_size
    err = (got[..., :v].float() - want[..., :v].float()).abs().max().item()
    assert err <= 4e-2 * max(1.0, want[..., :v].float().abs().max().item())


# ---------------------------------------------------------------------------
# the staircase kernel (Triton) and the planner on the card
# ---------------------------------------------------------------------------
def staircase_inputs(rows, cols, lane, seed=0):
    """int32 widths in [1, 50000) with width 1 and exact multiples of
    shard x lane in the first columns, shards 1-3 and 8, fp32 columns."""
    rng = np.random.default_rng(seed)
    so = rng.choice([1, 2, 3, 8], size=(rows, 1))
    w = rng.integers(1, 50000, size=(rows, cols))
    w[:, 0] = 1
    if cols > 1:
        w[:, 1] = so[:, 0] * lane * rng.integers(1, 20, size=rows)
    cols_f = [rng.random((rows, 1)) * 1e-4 for _ in range(3)]
    return tuple(torch.from_numpy(a).cuda().to(t) for a, t in
                 ((w, torch.int32), (so, torch.int32),
                  *((c, torch.float32) for c in cols_f)))


@pytest.mark.parametrize("rows,cols,lane", [(1, 1, 128), (3, 5, 128),
                                            (8, 128, 128), (13, 200, 128),
                                            (40, 257, 64), (24, 3, 64),
                                            (37, 1000, 96),
                                            (1024, 1024, 64)])
def test_staircase_kernel_vs_plain(gen, rows, cols, lane):
    """Waves exact; latency and occupancy within rtol 1e-6 (fp32 kernel vs
    the fp64 plain version on the same fp32 inputs)."""
    args = staircase_inputs(rows, cols, lane)
    before = ops.LAUNCHES["staircase_fused"]
    lat, wv, occ = sf.staircase_fused(*args, lane=lane)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["staircase_fused"] == before + 1
    assert (lat.dtype, wv.dtype, occ.dtype) == (torch.float32, torch.int32,
                                                torch.float32)
    rlat, rwv, rocc = sf.staircase_ref(*args, lane=lane)
    assert torch.equal(wv.long(), rwv)
    assert ((lat.double() - rlat).abs() <= 1e-6 * rlat.abs()).all()
    assert ((occ.double() - rocc).abs() <= 1e-6 * rocc.abs()).all()


@pytest.mark.parametrize("itype", [torch.int64, torch.int32])
def test_staircase_dispatch_checks_and_casts(gen, itype):
    """The int32 domain is checked in int64 whatever the inputs' integer
    type, and the kernel's ceil-divisions do not overflow at its top."""
    w = torch.tensor([[1, 64, 65]], dtype=itype, device="cuda")
    so = torch.ones(1, 1, dtype=itype, device="cuda")
    c = torch.full((1, 1), 1e-6, dtype=torch.float64, device="cuda")
    lat, wv, occ = ops.staircase_latency(w, so, c, c, c, lane=64)
    assert wv.tolist() == [[1, 1, 2]] and lat.dtype == torch.float32
    top = torch.tensor([[2 ** 31 - 1, 2 ** 31 - 2, 2 ** 31 - 64]],
                       dtype=itype, device="cuda")
    for shard in (1, 3, 2 ** 31 - 1):
        s = torch.full((1, 1), shard, dtype=itype, device="cuda")
        _, wv, occ = ops.staircase_latency(top, s, c, c, c, lane=64)
        _, rwv, rocc = sf.staircase_ref(top, s, c, c, c, lane=64)
        assert torch.equal(wv.long(), rwv) and (wv > 0).all()
        assert ((occ.double() - rocc).abs() <= 1e-6 * rocc).all()
    bad = [(-w, so), (w, so * 0)]
    if itype == torch.int64:
        bad += [(w + 2 ** 31 - 1, so), (w, so + 2 ** 31 - 1)]
    for bad_w, bad_so in bad:
        with pytest.raises(ValueError, match="2\\*\\*31"):
            ops.staircase_latency(bad_w, bad_so, c, c, c, lane=64)
    with pytest.raises(TypeError):
        sf.staircase_fused(w, so, c, c, c, lane=64)


def test_planner_on_the_card_equals_the_cpu(gen):
    from repro_torch.core import H100_SXM
    from repro_torch.serving import ServingWidthPlanner, TrafficClass, \
        serving_templates
    cfg = get_config("qwen1.5-0.5b")
    traffic = [TrafficClass("decode", 4), TrafficClass("short", 128),
               TrafficClass("prefill", 8192, delta=0.9)]
    tpl, mods = serving_templates(cfg, H100_SXM, tokens=512,
                                  sites=("mlp", "attn"))
    ops.reset_launches()
    card = ServingWidthPlanner(H100_SXM, tpl, modules=mods).plan(traffic)
    assert ops.LAUNCHES["staircase_fused"] == len(traffic)
    cpu = ServingWidthPlanner(H100_SXM, tpl, modules=mods,
                              device="cpu").plan(traffic)
    for name in cpu:
        assert card[name].widths == cpu[name].widths
        assert card[name].satisfied == cpu[name].satisfied
        assert abs(card[name].latency_s - cpu[name].latency_s) <= \
            1e-6 * cpu[name].latency_s
