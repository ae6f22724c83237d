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
from repro_torch.kernels import moe_gmm as mg
from repro_torch.kernels import rglru as rg
from repro_torch.kernels import rwkv6 as rw
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
                            "staircase_fused": 0, "rglru_scan": 0,
                            "rwkv6": 0, "moe_gmm": 0}
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


# ---------------------------------------------------------------------------
# the recurrences: RG-LRU (Triton) and RWKV6 (CUDA), and both families
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,t,w", [(2, 64, 128), (1, 32, 256), (3, 16, 128),
                                   (4, 128, 2560), (2, 37, 2500), (4, 1, 2560),
                                   (1, 5, 1)])
def test_rglru_kernel_vs_plain(gen, b, t, w):
    """tests/test_kernels.py:73-75's sweep, the main path's shape, a ragged
    W and T = 1. The same fp32 FMA chain in both: 1e-5 (the reference's)."""
    a = torch.rand(b, t, w, generator=gen, device="cuda") * 0.699 + 0.3
    x = torch.randn(b, t, w, generator=gen, device="cuda")
    h0 = torch.randn(b, w, generator=gen, device="cuda")
    before = ops.LAUNCHES["rglru_scan"]
    y, h = rg.rglru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rglru_scan"] == before + 1
    ry, rh = rg.rglru_ref(a, x, h0)
    torch.testing.assert_close(y, ry, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, rh, rtol=1e-5, atol=1e-5)


def test_rglru_kernel_refusals(gen):
    x = torch.randn(2, 4, 8, generator=gen, device="cuda")
    with pytest.raises(TypeError):
        rg.rglru_scan(x.bfloat16(), x.bfloat16(), x[:, 0].bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        rg.rglru_scan(x.transpose(1, 2), x.transpose(1, 2), x[:, :, 0])
    y, h = rg.rglru_scan(x[:, :0].contiguous(), x[:, :0].contiguous(),
                         x[:, 0].contiguous())
    assert y.shape == (2, 0, 8) and torch.equal(h, x[:, 0])


def rwkv_inputs(gen, b, t, h, dh, lw=None, s0=False, dtype=torch.float32):
    r, k, v = (torch.randn(b, t, h, dh, generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    if lw is None:
        lw = -torch.exp(torch.clamp(torch.randn(
            b, t, h, dh, generator=gen, device="cuda"), -8, 1))
    else:
        lw = torch.full((b, t, h, dh), lw, device="cuda")
    u = 0.1 * torch.randn(h, dh, generator=gen, device="cuda")
    st = torch.randn(b, h, dh, dh, generator=gen, device="cuda") \
        if s0 else None
    return r, k, v, lw, u, st


@pytest.mark.parametrize("b,t,h,dh,lw,s0,dtype", [
    (2, 64, 2, 64, None, False, torch.float32),
    (1, 32, 4, 32, None, False, torch.float32),
    (2, 128, 1, 64, None, False, torch.float32),
    (4, 128, 32, 64, None, False, torch.bfloat16),   # the main path
    (2, 97, 4, 64, None, True, torch.bfloat16),      # ragged last chunk
    (1, 1, 2, 64, None, True, torch.float32),
    (2, 40, 2, 16, -54.6, True, torch.float32),
    (2, 40, 2, 16, -8.0, False, torch.float32),
    (2, 40, 2, 16, -3.4e-4, True, torch.float32),
    (1, 33, 2, 128, None, True, torch.float32),
    (1, 70, 2, 128, None, True, torch.float32),
])
def test_rwkv6_kernel_vs_plain(gen, b, t, h, dh, lw, s0, dtype):
    """The kernel against its plain version on the card: finite at the
    decay extremes, within 2e-4 of the largest value (the reference's fp32
    tolerance; both accumulate in fp32, in other orders)."""
    args = rwkv_inputs(gen, b, t, h, dh, lw, s0, dtype)
    before = ops.LAUNCHES["rwkv6"]
    o, s = rw.rwkv6(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rwkv6"] == before + 1
    ro, rs = rw.rwkv6_ref(*args)
    for got, want in ((o, ro), (s, rs)):
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4 * max(
            1.0, want.abs().max().item()))


def test_rwkv6_kernel_chunks_and_refusals(gen):
    # head dim 128 at chunk 64 takes the most shared memory a CTA may ask
    for dh, chunks in ((128, (64,)), (64, (1, 16, 64))):
        args = rwkv_inputs(gen, 1, 70, 2, dh, s0=True)
        want = rw.rwkv6_ref(*args)
        for chunk in chunks:
            for got, w in zip(rw.rwkv6(*args, chunk=chunk), want):
                torch.testing.assert_close(got, w, rtol=2e-4, atol=2e-4 * max(
                    1.0, w.abs().max().item()))
    with pytest.raises(ValueError, match="chunk"):
        rw.rwkv6(*args, chunk=65)
    r = torch.zeros(1, 4, 2, 256, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        rw.rwkv6(r, r, r, r, torch.zeros(2, 256, device="cuda"))
    with pytest.raises(TypeError):
        rw.rwkv6(args[0].bfloat16(), *args[1:])


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-1.6b"])
def test_recurrent_family_on_the_card_vs_cpu(gen, arch):
    """A reduced config served on the card agrees with the CPU's plain
    path; the prefill's launch counts are exact."""
    from repro_torch.serving import Request, ServeEngine
    cfg = reduced_config(get_config(arch))
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(3, 70)))
    with torch.inference_mode():
        cpu, _ = tfm.forward(tfm.cast_params(params, "cpu"), cfg,
                             tokens=toks, mode="prefill")
        ops.reset_launches()
        card, _ = tfm.forward(tfm.cast_params(params, "cuda"), cfg,
                              tokens=toks.cuda(), mode="prefill")
    kinds = cfg.layer_kinds()
    assert ops.LAUNCHES == {
        "matmul_tiled": 3 * sum(k != "rwkv" for k in kinds),
        "flash_attention": kinds.count("attn"), "staircase_fused": 0,
        "rglru_scan": kinds.count("rglru"), "rwkv6": kinds.count("rwkv"),
        "moe_gmm": 0}
    v = cfg.vocab_size
    card, cpu = card[..., :v].float().cpu(), cpu[..., :v].float()
    assert (card - cpu).abs().max().item() <= 4e-2 * max(
        1.0, cpu.abs().max().item())
    reqs = [Request(prompt=p.numpy().astype(np.int32), max_new_tokens=4)
            for p in toks[:, :9]]
    on_card = ServeEngine(params, cfg, max_len=16, device="cuda").generate(
        reqs)
    assert all(len(r.tokens) == 4 for r in on_card)


# ---------------------------------------------------------------------------
# the grouped expert matmul (CUDA) and the MoE family
# ---------------------------------------------------------------------------
def moe_tol(want):
    """Kernel and plain version both sum in fp32 and round once to bf16:
    one bf16 step apart at most, 2^-7 of an element; 1e-2 of the largest
    |out|."""
    return 1e-2 * max(want.float().abs().max().item(), 1e-30)


@pytest.mark.parametrize("e,c,d,f,broadcast", [
    (4, 128, 256, 128, False), (2, 256, 128, 256, False),
    (8, 128, 128, 128, False),                    # test_kernels.py:107-117
    (2, 33, 31, 32, False), (1, 31, 33, 33, False),
    (2, 65, 64, 63, False),                       # test_kernels.py:157-165
    (1, 1, 1, 1, False), (3, 7, 9, 5, True),
    (32, 512, 1024, 512, True), (32, 512, 512, 1024, False),
    (32, 4, 1024, 512, True), (32, 4, 512, 1024, False),
    (32, 161, 1024, 512, False), (32, 2, 1024, 512, False),
])
def test_moe_gmm_kernel_vs_plain(gen, e, c, d, f, broadcast):
    """bf16 sweeps, the ragged edges and granite-moe-1b-a400m's full-width
    shapes (dense prefill and decode with x broadcast over the experts,
    the capacity buffers of 161 and 2 rows)."""
    x = randn(gen, c, d).expand(e, c, d) if broadcast else randn(gen, e, c, d)
    w = randn(gen, e, d, f)
    before = ops.LAUNCHES["moe_gmm"]
    got = mg.moe_gmm(x, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["moe_gmm"] == before + 1
    want = mg.moe_gmm_ref(x, w)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= moe_tol(want)
    if broadcast:
        assert torch.equal(got, mg.moe_gmm(x.contiguous(), w))


def test_moe_gmm_kernel_strides_and_alignment(gen):
    """A row stride past D (a slice of wider rows) and a 16-byte-misaligned
    x take the kernel's element-wise loads."""
    wide = randn(gen, 3, 20, 72)
    w = randn(gen, 3, 64, 40)
    for x in (wide[:, :, :64], randn(gen, 3 * 20 * 64 + 1)[1:]
              .view(3, 20, 64)):
        want = mg.moe_gmm_ref(x, w)
        got = mg.moe_gmm(x, w)
        assert (got.float() - want.float()).abs().max().item() <= \
            moe_tol(want)


def test_moe_gmm_kernel_refusals(gen):
    x, w = randn(gen, 2, 8, 16), randn(gen, 2, 16, 8)
    with pytest.raises(TypeError):
        mg.moe_gmm(x.float(), w.float())
    with pytest.raises(ValueError, match="CUDA"):
        mg.moe_gmm(x.cpu(), w)
    with pytest.raises(ValueError, match="multiply"):
        mg.moe_gmm(x, randn(gen, 2, 15, 8))
    with pytest.raises(ValueError, match="multiply"):
        mg.moe_gmm(x, randn(gen, 3, 16, 8))
    with pytest.raises(ValueError, match="unit stride"):
        mg.moe_gmm(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError, match="contiguous"):
        mg.moe_gmm(x, w.transpose(1, 2).contiguous().transpose(1, 2))
    assert mg.moe_gmm(x[:, :0], w).shape == (2, 0, 8)
    assert torch.equal(mg.moe_gmm(x[:, :, :0], w[:, :0]),
                       torch.zeros(2, 8, 8, dtype=torch.bfloat16,
                                   device="cuda"))


@pytest.mark.parametrize("strategy", ["auto", "capacity"])
def test_moe_family_on_the_card_vs_cpu(gen, strategy):
    """granite reduced with 16 experts (top-8) on the card against the
    CPU's plain path, with exact launch counts for one prefill: 3
    ``moe_gmm`` and one flash attention per layer, no MLP product."""
    from repro_torch.serving import Request, ServeEngine
    cfg = reduced_config(get_config("granite-moe-1b-a400m"), d_model=256,
                         d_ff=512, n_experts=16)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(3, 37)))
    with torch.inference_mode():
        cpu, _ = tfm.forward(tfm.cast_params(params, "cpu"), cfg,
                             tokens=toks, mode="prefill",
                             moe_strategy=strategy)
        ops.reset_launches()
        card, _ = tfm.forward(tfm.cast_params(params, "cuda"), cfg,
                              tokens=toks.cuda(), mode="prefill",
                              moe_strategy=strategy)
    assert ops.LAUNCHES == {"matmul_tiled": 0,
                            "flash_attention": cfg.n_layers,
                            "staircase_fused": 0, "rglru_scan": 0,
                            "rwkv6": 0, "moe_gmm": 3 * cfg.n_layers}
    v = cfg.vocab_size
    card, cpu = card[..., :v].float().cpu(), cpu[..., :v].float()
    assert (card - cpu).abs().max().item() <= 4e-2 * max(
        1.0, cpu.abs().max().item())
    reqs = [Request(prompt=p.numpy().astype(np.int32), max_new_tokens=4)
            for p in toks[:, :9]]
    ops.reset_launches()
    on_card = ServeEngine(params, cfg, max_len=16, device="cuda").generate(
        reqs)
    assert all(len(r.tokens) == 4 for r in on_card)
    assert ops.LAUNCHES["moe_gmm"] == 3 * cfg.n_layers * 4
