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


@pytest.mark.parametrize("m,k,n", [
    (1, 1, 1), (7, 33, 9), (63, 64, 65), (64, 64, 64), (65, 129, 63),
    (4, 1024, 2816), (512, 2816, 1024),
    # the decode form's chunks: K below, at and above SPLIT_K, a ragged
    # last chunk (600, 2752), element-wise loads where K % 8 != 0 (255, 257)
    (4, 248, 64), (4, 255, 72), (4, 256, 64), (4, 257, 72), (4, 264, 136),
    (4, 600, 200), (1, 2752, 1024), (4, 7680, 2560),
    # M across the decode/prefill switch (64 | 65) and the prefill tile (128)
    (1, 520, 136), (64, 520, 136), (65, 520, 136), (128, 600, 200),
    (129, 600, 200), (512, 1024, 2816),
    # w past 24 MiB: the prefill CTAs run in bands of columns (a ragged
    # last band; TMA and element-wise loads)
    (300, 4096, 6400), (129, 4097, 6401)])
def test_matmul_kernel_vs_plain(gen, m, k, n):
    x, w = randn(gen, m, k), randn(gen, k, n)
    before = ops.LAUNCHES["matmul_tiled"]
    got = mt.matmul_tiled(x, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["matmul_tiled"] == before + 1
    assert mt.LAST["loads"] == ("tma" if k % 8 == 0 and n % 8 == 0
                                else "elementwise")
    want = mt.matmul_ref(x, w).float()
    # one fp32 sum per output, rounded to bf16 in both: two bf16 steps
    tol = 2.0 ** -7 * max(want.abs().max().item(), 1.0)
    assert (got.float() - want).abs().max().item() <= tol


def test_matmul_kernel_unaligned_input(gen):
    """A 16-byte-misaligned x takes the kernel's element-wise loads, in
    both forms."""
    for m, k, n in ((33, 64, 72), (100, 600, 72)):
        buf = randn(gen, m * k + 1)
        x = buf[1:].view(m, k)
        w = randn(gen, k, n)
        got = mt.matmul_tiled(x, w).float()
        assert mt.LAST["loads"] == "elementwise"
        want = mt.matmul_ref(x, w).float()
        assert (got - want).abs().max().item() <= \
            2.0 ** -7 * want.abs().max()


@pytest.mark.parametrize("m,k,n", [(4, 2816, 1024), (4, 600, 72),
                                   (512, 1024, 2816), (100, 130, 70),
                                   (300, 4096, 6400)])
def test_matmul_kernel_repeats_bit_equal(gen, m, k, n):
    """No float atomics: the decode form's chunks are summed in a fixed
    order by whichever CTA ends last, so two launches give the same bits;
    the tile counters are left zeroed for the next launch."""
    x, w = randn(gen, m, k), randn(gen, k, n)
    first = mt.matmul_tiled(x, w)
    for _ in range(3):
        assert torch.equal(first, mt.matmul_tiled(x, w))
    torch.cuda.synchronize()
    if len(mt.schedule(m, n, k)[1]) > 1:
        assert int(mt._COUNTERS[x.device.index].abs().sum()) == 0


@pytest.mark.parametrize("m", [4, 512])
def test_matmul_kernel_sliced_equals_zero_padded(gen, m):
    """The planner's narrowed widths on the card: a product whose K (w's
    rows) or N (w's columns) is cut from 2816 to 2752 is bit-equal to the
    full-shape product on zero-padded inputs, in both forms: the chunks
    start at fixed offsets, so zeros add exact zeros in the same order."""
    full, cut = 2816, 2752
    x, w = randn(gen, m, cut), randn(gen, cut, 1024)
    xp = torch.zeros(m, full, dtype=x.dtype, device="cuda")
    wp = torch.zeros(full, 1024, dtype=w.dtype, device="cuda")
    xp[:, :cut], wp[:cut] = x, w
    assert torch.equal(mt.matmul_tiled(x, w), mt.matmul_tiled(xp, wp))
    x2, w2 = randn(gen, m, 1024), randn(gen, 1024, cut)
    w2p = torch.zeros(1024, full, dtype=w2.dtype, device="cuda")
    w2p[:, :cut] = w2
    assert torch.equal(mt.matmul_tiled(x2, w2),
                       mt.matmul_tiled(x2, w2p)[:, :cut])


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("mask,window", [("causal", 0), ("local", 40),
                                         ("none", 0)])
@pytest.mark.parametrize("b,sq,skv,h,kv", [(1, 1, 1, 2, 1),
                                           (2, 63, 63, 4, 4),
                                           (2, 65, 65, 4, 2),
                                           (1, 100, 200, 8, 2),
                                           (4, 128, 128, 16, 16),
                                           # granite's prefill (GQA 16 on
                                           # 8); kv tails past a block that
                                           # TMA zero-fills
                                           (4, 128, 128, 16, 8),
                                           (1, 64, 65, 4, 2),
                                           (2, 200, 200, 4, 2)])
def test_flash_kernel_vs_plain(gen, dh, mask, window, b, sq, skv, h, kv):
    q, k, v = randn(gen, b, sq, h, dh), randn(gen, b, skv, kv, dh), \
        randn(gen, b, skv, kv, dh)
    got = fa.flash_attention(q, k, v, mask_kind=mask, window=window)
    torch.cuda.synchronize()
    want = fa.attention_ref(q, k, v, mask_kind=mask, window=window)
    assert (got.float() - want.float()).abs().max().item() <= 4e-2


@pytest.mark.parametrize("sq,dh", [(130, 64), (300, 64), (300, 128)])
def test_flash_kernel_causal_longer_queries(gen, sq, dh):
    """Rows past Skv see every key under a causal mask; at Sq = 300 query
    blocks 2-4 start past the last key and the last one is ragged."""
    q, k, v = randn(gen, 1, sq, 4, dh), randn(gen, 1, 100, 2, dh), \
        randn(gen, 1, 100, 2, dh)
    got = fa.flash_attention(q, k, v)
    want = fa.attention_ref(q, k, v)
    assert (got.float() - want.float()).abs().max().item() <= 4e-2


def one_hot_attention(dh: int, skv: int = 128, seed: int = 1):
    """Inputs whose scores are one-hot: key j is +e_(j % 64) for j < 64 and
    -e_(j % 64) after, query i is c * (+-e) of the key pi(i) it picks, with
    c large enough that every other score is at least 30 nats lower. So
    softmax(q k^T) v is v[pi] up to bf16 rounding: a check of the P @ V
    operand's layout (keys, and dh's columns across swizzle atoms). CPU
    tensors (q, k, v bf16; pi) from numpy."""
    rng = np.random.default_rng(seed)
    pi = rng.permutation(skv)
    c = 32.0 * dh ** 0.5                # score c / sqrt(dh) = 32
    k = np.zeros((1, skv, 1, dh), np.float32)
    q = np.zeros((1, skv, 1, dh), np.float32)
    for j in range(skv):
        k[0, j, 0, j % 64] = 1.0 if j < 64 else -1.0
    for i, j in enumerate(pi):
        q[0, i, 0, j % 64] = c * (1.0 if j < 64 else -1.0)
    v = rng.standard_normal((1, skv, 1, dh)).astype(np.float32)
    return tuple(torch.from_numpy(a).bfloat16() for a in (q, k, v)) + \
        (torch.from_numpy(pi),)


@pytest.mark.parametrize("dh", [64, 128])
def test_flash_kernel_pv_identity(gen, dh):
    """One-hot scores return the chosen rows of V: the MN-major V operand
    (its keys and, at dh 128, its second swizzle atom) is read right."""
    q, k, v, pi = (t.cuda() for t in one_hot_attention(dh))
    got = fa.flash_attention(q, k, v, mask_kind="none")
    torch.cuda.synchronize()
    assert (got[0, :, 0].float() - v[0, pi, 0].float()).abs().max() <= 1e-2


@pytest.mark.parametrize("mask,window", [("causal", 0), ("local", 200),
                                         ("none", 0)])
def test_flash_kernel_long_sequence(gen, mask, window):
    """S = 1024 at dh 128: 16 kv blocks through a 2-stage ring, so every
    stage is refilled 7 times (the free barriers' parity), the products
    overlap the softmax across 16 blocks, and whole blocks skip the
    mask."""
    q, k, v = randn(gen, 1, 1024, 4, 128), randn(gen, 1, 1024, 2, 128), \
        randn(gen, 1, 1024, 2, 128)
    got = fa.flash_attention(q, k, v, mask_kind=mask, window=window)
    want = fa.attention_ref(q, k, v, mask_kind=mask, window=window)
    assert (got.float() - want.float()).abs().max().item() <= 4e-2


@pytest.mark.parametrize("b,sq,skv,h,kv,dh,mask", [
    (4, 128, 128, 16, 8, 64, "causal"), (1, 1024, 1024, 4, 2, 128, "none"),
    (2, 200, 200, 4, 2, 64, "local")])
def test_flash_kernel_repeats_bit_equal(gen, b, sq, skv, h, kv, dh, mask):
    """No atomics and a fixed order of kv blocks: two launches on the same
    inputs give the same bits."""
    q, k, v = randn(gen, b, sq, h, dh), randn(gen, b, skv, kv, dh), \
        randn(gen, b, skv, kv, dh)
    first = fa.flash_attention(q, k, v, mask_kind=mask, window=48)
    assert torch.equal(first, fa.flash_attention(q, k, v, mask_kind=mask,
                                                 window=48))


@pytest.mark.parametrize("dh,stages", [(64, 4), (128, 2)])
def test_flash_kernel_form(gen, dh, stages):
    """The form the source promises: one consumer warpgroup and one
    producer warp, its K/V ring, at least 2 CTAs an SM, no spills."""
    f = fa.form(dh)
    assert f["threads"] == 160 and f["stages"] == stages
    assert f["ctas_per_sm"] >= 2 and f["spill_bytes"] == 0
    assert {k: f[k] for k in fa.FORMS[dh]} == fa.FORMS[dh]


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
                            "staircase_fused": 0, "staircase_cta": 0, "rglru_scan": 0,
                            "rwkv6": 0, "moe_gmm": 0,
                            "flash_attention_bwd": 0, "matmul_tiled_bwd": 0,
                            "moe_gmm_bwd": 0, "rglru_scan_bwd": 0,
                            "rwkv6_bwd": 0, "adamw": 0}
    want, _ = tfm.forward(params, cfg, tokens=toks, mode="prefill",
                          force="plain")
    v = cfg.vocab_size
    err = (got[..., :v].float() - want[..., :v].float()).abs().max().item()
    assert err <= 4e-2 * max(1.0, want[..., :v].float().abs().max().item())


# ---------------------------------------------------------------------------
# M-RoPE (qwen2-vl-7b) and the encoder-decoder (seamless-m4t-medium)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,sq,skv,h,kv,dh,mask", [
    # seamless: cross-attention of 128 decoder rows onto 150 encoder frames,
    # and the encoder's self-attention (600 rows, not a multiple of 64)
    (4, 128, 150, 16, 16, 64, "none"), (4, 150, 150, 16, 16, 64, "none"),
    # qwen2-vl-7b's prefill: GQA 28 on 4, a group of 7
    (4, 128, 128, 28, 4, 128, "causal")])
def test_flash_kernel_new_family_shapes(gen, b, sq, skv, h, kv, dh, mask):
    q, k, v = randn(gen, b, sq, h, dh), randn(gen, b, skv, kv, dh), \
        randn(gen, b, skv, kv, dh)
    got = fa.flash_attention(q, k, v, mask_kind=mask)
    torch.cuda.synchronize()
    want = fa.attention_ref(q, k, v, mask_kind=mask)
    assert (got.float() - want.float()).abs().max().item() <= 4e-2
    assert torch.equal(got, fa.flash_attention(q, k, v, mask_kind=mask))


@pytest.mark.parametrize("m,k,n", [
    (m, k, n) for m in (4, 512)
    for k, n in ((3584, 18944), (18944, 3584), (1024, 4096), (4096, 1024))
] + [(m, k, n) for m in (128, 600) for k, n in ((1024, 4096), (4096, 1024))])
def test_matmul_kernel_new_family_shapes(gen, m, k, n):
    """qwen2-vl-7b's MLP products (K or N = 18944) and seamless's (d_ff
    4096) at prefill and decode: seamless's decoder prefill runs M = 4 x 32,
    its encoder M = 4 x 150."""
    x, w = randn(gen, m, k), randn(gen, k, n)
    got = mt.matmul_tiled(x, w)
    torch.cuda.synchronize()
    want = mt.matmul_ref(x, w).float()
    tol = 2.0 ** -7 * max(want.abs().max().item(), 1.0)
    assert (got.float() - want).abs().max().item() <= tol


def grid_positions(b, s, gh=4, gw=8):
    """(B, S, 3) M-RoPE positions: a ``gh x gw`` vision grid at t = 0, then
    text at max + 1 onward on all three axes."""
    i = np.arange(s)
    n = gh * gw
    text = max(gh, gw) + i - n
    pos = np.stack([np.where(i < n, 0, text), np.where(i < n, i // gw, text),
                    np.where(i < n, i % gw, text)], -1)
    return torch.from_numpy(np.broadcast_to(pos, (b, s, 3)).copy())


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "seamless-m4t-medium"])
def test_new_family_on_the_card_vs_cpu(gen, arch):
    """A reduced config at head dim 64 (grid positions for qwen2-vl,
    encoder frames for seamless): the card's prefill and three
    teacher-forced decode steps agree with the CPU's plain path, and the
    prefill's launch counts are exact (seamless: two products a GeLU MLP,
    a flash attention a layer of its encoder and two a decoder layer,
    causal and cross)."""
    cfg = reduced_config(get_config(arch), d_model=256, n_heads=4, d_ff=512,
                         vocab=250)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(3, 40)))
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(3, 3)))
    kw = {}
    if cfg.is_encdec:
        kw["src_embeds"] = torch.from_numpy(
            (0.02 * rng.standard_normal((3, 70, cfg.d_model))).astype(
                np.float32))
    else:
        kw["positions"] = grid_positions(3, 43)
    out = {}
    for dev in ("cpu", "cuda"):
        p = tfm.cast_params(params, dev)
        extra = {k: v[:, :40].to(dev) if k == "positions" else v.to(dev)
                 for k, v in kw.items()}
        with torch.inference_mode():
            ops.reset_launches()
            logits, st = tfm.forward(p, cfg, tokens=toks.to(dev),
                                     mode="prefill", **extra)
            launches = dict(ops.LAUNCHES)
            st = {g: {k: {n: torch.nn.functional.pad(
                t, (0, 0, 0, 0, 0, 3)) if n in ("k", "v") else t
                for n, t in d.items()} for k, d in sub.items()}
                for g, sub in st.items()}
            steps = [logits[:, -1]]
            for t in range(3):
                pos3 = None if cfg.is_encdec else \
                    kw["positions"][:, 40 + t:41 + t].to(dev)
                lg, st = tfm.decode_step(p, cfg, feed[:, t].to(dev), 40 + t,
                                         st, positions=pos3)
                steps.append(lg)
        out[dev] = ([s_[:, :cfg.vocab_size].float().cpu() for s_ in steps],
                    launches)
    mlp = 3 if cfg.mlp_gated else 2
    enc = cfg.encoder_layers
    assert out["cuda"][1] == {
        "matmul_tiled": mlp * (cfg.n_layers + enc),
        "flash_attention": cfg.n_layers * (2 if enc else 1) + enc,
        "staircase_fused": 0, "staircase_cta": 0, "rglru_scan": 0,
        "rwkv6": 0, "moe_gmm": 0,
                            "flash_attention_bwd": 0, "matmul_tiled_bwd": 0,
                            "moe_gmm_bwd": 0, "rglru_scan_bwd": 0,
                            "rwkv6_bwd": 0, "adamw": 0}
    for card, cpu in zip(out["cuda"][0], out["cpu"][0]):
        assert bool(torch.isfinite(card).all())
        assert (card - cpu).abs().max().item() <= 4e-2 * max(
            1.0, cpu.abs().max().item())


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


# ---------------------------------------------------------------------------
# the GPU form: the CTA-wave kernel (Triton), the GEMM forms, Fig. 5
# ---------------------------------------------------------------------------
def cta_inputs(rows, cols, shards=(1, 2, 3, 8), seed=0):
    """int32 widths in [1, 50000) with width 1 and exact multiples of
    shard x 64 first, ``g`` as the port's GEMM gives it (1-64 row tiles x
    1-16 K chunks), slots 132 x 1-3, fp32 coefficient columns."""
    rng = np.random.default_rng(seed)
    so = rng.choice(shards, size=(rows, 1))
    w = rng.integers(1, 50000, size=(rows, cols))
    w[:, 0] = 1
    if cols > 1:
        w[:, 1] = so[:, 0] * 64 * rng.integers(1, 20, size=rows)
    g = rng.integers(1, 65, size=(rows, 1)) * rng.integers(1, 17,
                                                           size=(rows, 1))
    sl = 132 * rng.integers(1, 4, size=(rows, 1))
    cols_f = [rng.random((rows, 1)) * 1e-5 for _ in range(3)]
    return tuple(torch.from_numpy(a).cuda().to(t) for a, t in
                 ((w, torch.int32), (so, torch.int32), (g, torch.int32),
                  (sl, torch.int32),
                  *((c, torch.float32) for c in cols_f)))


@pytest.mark.parametrize("rows,cols,shards", [
    (1, 1, (1,)), (3, 5, (1, 2)), (24, 3, (1,)), (24, 45, (1,)),
    (40, 257, (1, 2, 3, 8)), (37, 1000, (3,)), (1024, 1024, (1, 2, 3, 8))])
def test_staircase_cta_kernel_vs_plain(gen, rows, cols, shards):
    """Waves and tiles exact; latency within rtol 1e-6 (fp32 kernel vs
    the fp64 plain version on the same fp32 inputs)."""
    args = cta_inputs(rows, cols, shards)
    before = ops.LAUNCHES["staircase_cta"]
    lat, wv, tiles = sf.staircase_cta(*args, block_n=64)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["staircase_cta"] == before + 1
    assert (lat.dtype, wv.dtype, tiles.dtype) == (
        torch.float32, torch.int32, torch.int32)
    rlat, rwv, rtiles = sf.staircase_cta_ref(*args, block_n=64)
    assert torch.equal(wv.long(), rwv) and torch.equal(tiles.long(), rtiles)
    assert ((lat.double() - rlat).abs() <= 1e-6 * rlat.abs()).all()


def test_staircase_cta_dispatch_checks_and_casts(gen):
    """The int32 domain (g x tiles included) is checked in int64 and the
    inputs cast; a CPU tensor takes the plain version."""
    w = torch.tensor([[1, 64, 65, 8448]], device="cuda")
    one = torch.ones(1, 1, dtype=torch.int64, device="cuda")
    c = torch.full((1, 1), 1e-6, dtype=torch.float64, device="cuda")
    lat, wv, tiles = ops.staircase_cta_latency(w, one, one * 4, one * 264,
                                               c, c, c, block_n=64)
    assert tiles.tolist() == [[1, 1, 2, 132]]
    assert wv.tolist() == [[1, 1, 1, 2]] and lat.dtype == torch.float32
    for bad in [dict(w=-w), dict(so=one * 0), dict(sl=one * 0),
                dict(g=-one), dict(g=one * 2 ** 30)]:
        kw = dict(w=w, so=one, g=one, sl=one) | bad
        with pytest.raises(ValueError, match="2\\*\\*31"):
            ops.staircase_cta_latency(kw["w"], kw["so"], kw["g"], kw["sl"],
                                      c, c, c, block_n=64)
    with pytest.raises(TypeError):
        sf.staircase_cta(w, one, one, one, c, c, c, block_n=64)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("module", [mt, mg])
def test_gemm_forms_read_on_the_card(gen, module, kind):
    """Each GEMM library's form on the card, on every tile of the form:
    the threads, shared bytes and CTAs an SM of ``matmul_tiled.FORMS``
    (one CTA an SM on every prefill tile), no spills."""
    for (k, tile), want in mt.FORMS.items():
        if k != kind:
            continue
        got = module.form(kind, tile=tile)
        assert {n: got[n] for n in want} == want, (tile, got)
        assert got["spill_bytes"] == 0 and 0 < got["registers"] <= 255
        assert kind == "decode" or got["ctas_per_sm"] == 1
        assert module.form(kind, "cpu", tile) == want
    assert module.form(kind) == module.form(kind, tile=None)


def test_cta_model_kernel_backend_equals_numpy(gen):
    """``CtaWaveModel``'s kernel backend on the card against its numpy
    engine: equal waves, latency within rtol 1e-6, stacked and per
    layer."""
    from repro_torch.core import H100_SXM, LayerShape
    from repro_torch.core.tail_model import CtaWaveModel
    rng = np.random.default_rng(1)
    layers = [LayerShape(f"l{i}", tokens=int(rng.integers(1, 5000)),
                         d_in=int(rng.integers(1, 8000)), width=1,
                         shard_out=int(rng.choice([1, 2, 3])),
                         experts=int(rng.choice([1, 1, 4])))
              for i in range(30)]
    widths = [rng.integers(1, 20000, size=int(rng.integers(1, 80)))
              for _ in layers]
    ker = CtaWaveModel(H100_SXM, backend="kernel")
    ref = CtaWaveModel(H100_SXM)
    a = ker.evaluate_model_batch(layers, widths)
    b = ref.evaluate_model_batch(layers, widths)
    assert np.array_equal(a.waves, b.waves)
    np.testing.assert_allclose(a.latency_s, b.latency_s, rtol=1e-6)
    assert ker.table_variant == ref.table_variant + "-kernel-cuda"


def test_measured_profile_on_the_card(gen):
    """``measured_profile`` times the GEMM at each width: positive and
    finite, with the model's waves and the replays' spread beside each
    time."""
    from repro_torch.core import H100_SXM, LayerShape
    from repro_torch.core.profiler import measured_profile
    from repro_torch.core.tail_model import CtaWaveModel
    layer = LayerShape("ffn", tokens=512, d_in=1024, width=2816)
    prof = measured_profile(layer, [64, 2816], hw=H100_SXM, reps=5,
                            repeats=3)
    assert prof.source == "measured"
    assert np.isfinite(prof.latency_s).all() and (prof.latency_s > 0).all()
    assert prof.waves.tolist() == CtaWaveModel(H100_SXM).evaluate_batch(
        layer, [64, 2816]).waves.tolist()
    assert (prof.throughput > 0).all()
    assert prof.spread_s.shape == (2,) and (prof.spread_s >= 0).all()


@pytest.mark.parametrize("spec,kernel", [("tpu_v5e", "staircase_fused"),
                                         ("h100_sxm", "staircase_cta")])
def test_planner_on_the_card_equals_the_cpu(gen, spec, kernel):
    """A TPU spec plans in the TPU form on ``staircase_fused``, the H100 in
    the GPU form on ``staircase_cta``: one launch per class either way,
    and the plans the CPU makes (the GPU form on its numpy engine)."""
    from repro_torch.core import get_hardware
    from repro_torch.serving import ServingWidthPlanner, TrafficClass, \
        serving_templates
    hw = get_hardware(spec)
    cfg = get_config("qwen1.5-0.5b")
    traffic = [TrafficClass("decode", 4), TrafficClass("short", 128),
               TrafficClass("prefill", 8192, delta=0.9)]
    tpl, mods = serving_templates(cfg, hw, tokens=512,
                                  sites=("mlp", "attn"))
    ops.reset_launches()
    card = ServingWidthPlanner(hw, tpl, modules=mods).plan(traffic)
    assert ops.LAUNCHES[kernel] == len(traffic)
    assert sum(ops.LAUNCHES.values()) == len(traffic)
    cpu = ServingWidthPlanner(hw, tpl, modules=mods,
                              device="cpu").plan(traffic)
    for name in cpu:
        assert card[name].widths == cpu[name].widths
        assert card[name].satisfied == cpu[name].satisfied
        assert abs(card[name].latency_s - cpu[name].latency_s) <= \
            1e-6 * cpu[name].latency_s


# ---------------------------------------------------------------------------
# the recurrences: RG-LRU and RWKV6 (CUDA), and both families
# ---------------------------------------------------------------------------
def rglru_inputs(gen, b, t, w):
    a = torch.rand(b, t, w, generator=gen, device="cuda") * 0.699 + 0.3
    x = torch.randn(b, t, w, generator=gen, device="cuda")
    h0 = torch.randn(b, w, generator=gen, device="cuda")
    return a, x, h0


@pytest.mark.parametrize("b,t,w", [(2, 64, 128), (1, 32, 256), (3, 16, 128),
                                   (4, 128, 2560), (2, 37, 2500), (4, 1, 2560),
                                   (1, 5, 1), (2, 97, 2501), (1, 2048, 2560),
                                   (1, 300, 64), (4, 300, 2560),
                                   (2, 300, 2501), (4, 2048, 2560)])
def test_rglru_kernel_vs_plain(gen, b, t, w):
    """tests/test_kernels.py:73-75's sweep, the main path's shape, ragged W
    (TMA where rows are 16-byte multiples, cp.async where not), T = 1, a
    ragged T, several windows at batch 1 and above it (by TMA and by
    cp.async). The same fp32 FMA chain in both, the kernel
    re-walking quarter windows from folded carries: 1e-5 (the
    reference's)."""
    a, x, h0 = rglru_inputs(gen, b, t, w)
    before = ops.LAUNCHES["rglru_scan"]
    y, h = rg.rglru_scan(a, x, h0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rglru_scan"] == before + 1
    ry, rh = rg.rglru_ref(a, x, h0)
    torch.testing.assert_close(y, ry, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h, rh, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,t,w", [(4, 128, 2560), (2, 97, 2501),
                                   (1, 300, 64)])
def test_rglru_kernel_repeats_bit_equal(gen, b, t, w):
    """No atomics and a fixed order: two launches give the same bits, and
    h_last is y's last step."""
    args = rglru_inputs(gen, b, t, w)
    y, h = rg.rglru_scan(*args)
    y2, h2 = rg.rglru_scan(*args)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert torch.equal(h, y[:, -1])


def test_rglru_kernel_unaligned_base(gen):
    """A contiguous view 4 bytes past a 16-byte boundary takes the cp.async
    route; the same result as TMA on the aligned copy and as the plain
    version, within 1e-5."""
    a, x, h0 = rglru_inputs(gen, 2, 150, 256)
    store = torch.empty(a.numel() + 1, device="cuda")
    au = store[1:].view_as(a)
    au.copy_(a)
    assert au.data_ptr() % 16 == 4 and au.is_contiguous()
    assert rg.form(2, 150, 256)["route"] == "tma"
    assert rg.form(2, 150, 256, aligned=False)["route"] == "cp.async"
    want = rg.rglru_scan(a, x, h0)
    for got, w, r in zip(rg.rglru_scan(au, x, h0), want,
                         rg.rglru_ref(a, x, h0)):
        torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got, r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,t,w", [(4, 128, 2560), (1, 2048, 2560),
                                   (4, 1, 2560), (1, 64, 256)])
def test_rglru_kernel_form(gen, b, t, w):
    """The host's form against the compiled kernel: 4 warps, the shared
    memory the host counts, no spills, and enough CTAs an SM for the form's
    ring (all 320 of recurrentgemma-2b's prefill resident at once)."""
    f = rg.form(b, t, w)
    got = rg.attrs(f["window"], f["stages"])
    assert got["threads"] == 32 * f["warps"] == 128
    assert got["smem_bytes"] == f["smem_bytes"] and got["spill_bytes"] == 0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert got["ctas_per_sm"] >= 1
    if (b, t, w) == (4, 128, 2560):
        assert f["ctas"] == 320 and got["ctas_per_sm"] * sms >= 320


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
    (2, 40, 3, 16, None, True, torch.bfloat16),     # dh 16: one 16-wide tile
    (2, 33, 4, 64, None, True, torch.bfloat16),     # one row past a chunk
    (2, 96, 4, 64, -54.6, True, torch.float32),     # fp32: not exact in TF32
    (2, 96, 4, 64, -3.4e-4, True, torch.float32),
    (2, 50, 2, 96, None, True, torch.bfloat16),     # 2 value blocks
    (2, 45, 2, 20, None, True, torch.bfloat16),     # rows of 40 and 72 B:
    (2, 45, 2, 18, None, False, torch.float32),     # element-wise loads
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


@pytest.mark.parametrize("dh,chunk,t", [
    (64, 1, 20), (64, 15, 47), (64, 16, 49), (64, 17, 52), (64, 64, 129),
    (32, 64, 70), (128, 64, 130), (128, 17, 40)])
def test_rwkv6_kernel_chunks(gen, dh, chunk, t):
    """Chunks around the 16-row sub-chunk edge, up to 64 rows (4 sub-chunks,
    every off-diagonal factor), dh 128 at chunk 64 (the most shared memory:
    one chunk buffer), T one row past a chunk; bf16 and fp32 inputs."""
    for dtype in (torch.bfloat16, torch.float32):
        args = rwkv_inputs(gen, 2, t, 2, dh, s0=True, dtype=dtype)
        want = rw.rwkv6_ref(*args, chunk=chunk)
        for got, w in zip(rw.rwkv6(*args, chunk=chunk), want):
            assert torch.isfinite(got).all()
            torch.testing.assert_close(got, w, rtol=2e-4, atol=2e-4 * max(
                1.0, w.abs().max().item()))


def test_rwkv6_kernel_unaligned_base(gen):
    """A contiguous view 4 bytes past a 16-byte boundary: element-wise
    loads, the same result as the aligned copy."""
    args = rwkv_inputs(gen, 2, 40, 2, 64, s0=True)
    store = torch.empty(args[0].numel() + 1, device="cuda")
    r = store[1:].view_as(args[0])
    r.copy_(args[0])
    assert r.data_ptr() % 16 == 4 and r.is_contiguous()
    want = rw.rwkv6(*args)
    for got, w in zip(rw.rwkv6(r, *args[1:]), want):
        torch.testing.assert_close(got, w, rtol=2e-4, atol=2e-4 * max(
            1.0, w.abs().max().item()))


@pytest.mark.parametrize("b,t,h,dh,dtype", [
    (4, 128, 32, 64, torch.bfloat16), (2, 97, 4, 128, torch.float32)])
def test_rwkv6_kernel_repeats_bit_equal(gen, b, t, h, dh, dtype):
    """No atomics and a fixed order of sums: two launches on the same
    inputs give the same bits."""
    args = rwkv_inputs(gen, b, t, h, dh, s0=True, dtype=dtype)
    first = rw.rwkv6(*args)
    for got, want in zip(rw.rwkv6(*args), first):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dh,chunk,dtype,stages,value_block", [
    (64, 32, torch.bfloat16, 2, 64), (128, 64, torch.float32, 1, 32)])
def test_rwkv6_kernel_form(gen, dh, chunk, dtype, stages, value_block):
    """The form the source promises: 16 warps; VALUE_BLOCK value columns
    and two chunk buffers where they fit, half the columns and one buffer
    at dh 128, chunk 64, fp32 (the most shared memory); no spills."""
    f = rw.form(dh, chunk, dtype)
    assert f["threads"] == 512 and f["spill_bytes"] == 0
    assert f["value_block"] == value_block and f["stages"] == stages
    assert f["smem_bytes"] <= 232448 and f["ctas_per_sm"] >= 1
    assert rw.VALUE_BLOCK == 64


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
        "flash_attention": kinds.count("attn"), "staircase_fused": 0, "staircase_cta": 0,
        "rglru_scan": kinds.count("rglru"), "rwkv6": kinds.count("rwkv"),
        "moe_gmm": 0, "flash_attention_bwd": 0, "matmul_tiled_bwd": 0,
        "moe_gmm_bwd": 0, "rglru_scan_bwd": 0, "rwkv6_bwd": 0, "adamw": 0}
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
    # the decode form's chunks over D (below, at, above SPLIT_K, ragged),
    # C across the switch, and the stride-0 x in both forms
    (4, 4, 248, 64, True), (4, 4, 256, 64, False), (4, 4, 264, 72, True),
    (4, 64, 600, 64, True), (4, 65, 600, 64, True), (4, 129, 264, 72, False),
])
def test_moe_gmm_kernel_vs_plain(gen, e, c, d, f, broadcast):
    """bf16 sweeps, the ragged edges, the split edges and
    granite-moe-1b-a400m's full-width shapes (dense prefill and decode with
    x broadcast over the experts, the capacity buffers of 161 and 2
    rows)."""
    x = randn(gen, c, d).expand(e, c, d) if broadcast else randn(gen, e, c, d)
    w = randn(gen, e, d, f)
    before = ops.LAUNCHES["moe_gmm"]
    got = mg.moe_gmm(x, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["moe_gmm"] == before + 1
    assert mg.LAST["loads"] == ("tma" if d % 8 == 0 and f % 8 == 0
                                else "elementwise")
    want = mg.moe_gmm_ref(x, w)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= moe_tol(want)
    if broadcast:
        assert torch.equal(got, mg.moe_gmm(x.contiguous(), w))


@pytest.mark.parametrize("c", [4, 161, 512])
def test_moe_gmm_kernel_repeats_and_pads_bit_equal(gen, c):
    """Two launches give the same bits, and D cut from 1024 to 960 equals
    the zero-padded full D bit for bit (decode and prefill forms)."""
    e, d, cut, f = 32, 1024, 960, 512
    x, w = randn(gen, c, cut).expand(e, c, cut), randn(gen, e, cut, f)
    got = mg.moe_gmm(x, w)
    assert torch.equal(got, mg.moe_gmm(x, w))
    xp = torch.zeros(c, d, dtype=x.dtype, device="cuda")
    wp = torch.zeros(e, d, f, dtype=w.dtype, device="cuda")
    xp[:, :cut], wp[:, :cut] = x[0], w
    assert torch.equal(got, mg.moe_gmm(xp.expand(e, c, d), wp))


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


# ---------------------------------------------------------------------------
# the GEMMs' prefill tiles (the tile autotuner's candidates)
# ---------------------------------------------------------------------------
NEW_TILES = [t for t in mt.PREFILL_TILES if t != mt.DEFAULT_TILE]


@pytest.mark.parametrize("tile", NEW_TILES)
@pytest.mark.parametrize("m,k,n", [
    (65, 129, 63), (128, 600, 200), (129, 600, 200), (257, 520, 136),
    (100, 130, 70), (512, 1024, 2816), (512, 2816, 1024), (512, 1024, 2112),
    (300, 4096, 6400), (129, 4097, 6401)])
def test_matmul_tile_vs_plain_and_default(gen, tile, m, k, n):
    """Each prefill tile on ragged M, N, K, element-wise loads, w in bands
    and the main path's shapes: held against the plain version, and bit
    for bit against the default tile (a tile changes which CTA computes
    an output, not its K order)."""
    x, w = randn(gen, m, k), randn(gen, k, n)
    before = ops.LAUNCHES["matmul_tiled"]
    got = ops.matmul(x, w, tile=tile)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["matmul_tiled"] == before + 1
    assert ops.TILES["matmul"] == tile
    assert mt.LAST["loads"] == ("tma" if k % 8 == 0 and n % 8 == 0
                                else "elementwise")
    want = mt.matmul_ref(x, w).float()
    tol = 2.0 ** -7 * max(want.abs().max().item(), 1.0)
    assert (got.float() - want).abs().max().item() <= tol
    assert torch.equal(got, ops.matmul(x, w))
    assert ops.TILES["matmul"] == mt.DEFAULT_TILE
    assert torch.equal(got, mt.matmul_tiled(x, w, tile))


@pytest.mark.parametrize("tile", NEW_TILES)
def test_matmul_tile_unaligned_input(gen, tile):
    """A 16-byte-misaligned x takes the element-wise loads on each tile."""
    m, k, n = 300, 600, 72
    x = randn(gen, m * k + 1)[1:].view(m, k)
    w = randn(gen, k, n)
    got = mt.matmul_tiled(x, w, tile)
    assert mt.LAST["loads"] == "elementwise"
    want = mt.matmul_ref(x, w).float()
    assert (got.float() - want).abs().max().item() <= \
        2.0 ** -7 * want.abs().max()
    assert torch.equal(got, mt.matmul_tiled(x, w))


@pytest.mark.parametrize("tile", NEW_TILES)
@pytest.mark.parametrize("e,c,d,f,broadcast", [
    (2, 65, 64, 63, False), (3, 300, 520, 136, True),
    (32, 512, 1024, 512, True), (32, 512, 512, 1024, False),
    (32, 161, 1024, 512, False)])
def test_moe_gmm_tile_vs_plain_and_default(gen, tile, e, c, d, f,
                                           broadcast):
    """Each prefill tile of the grouped matmul, a broadcast x among them
    (granite's dense prefill), against the plain version and bit for bit
    against the default tile."""
    x = randn(gen, c, d).expand(e, c, d) if broadcast else randn(gen, e, c, d)
    w = randn(gen, e, d, f)
    got = ops.moe_gmm(x, w, tile=tile)
    torch.cuda.synchronize()
    assert ops.TILES["moe_gmm"] == tile
    want = mg.moe_gmm_ref(x, w)
    assert (got.float() - want.float()).abs().max().item() <= moe_tol(want)
    assert torch.equal(got, mg.moe_gmm(x, w))


def test_gemm_tile_refusals(gen):
    """A tile the kernel lacks raises; the decode form has one tile."""
    x, w = randn(gen, 128, 64), randn(gen, 64, 64)
    with pytest.raises(ValueError, match="no prefill tile"):
        mt.matmul_tiled(x, w, (32, 64))
    with pytest.raises(ValueError, match="decode form"):
        mt.matmul_tiled(x[:4], w, (128, 64))
    assert mt.matmul_tiled(x[:4], w, mt.DECODE_TILE).shape == (4, 64)
    with pytest.raises(ValueError, match="no prefill tile"):
        mg.moe_gmm(x.expand(2, 128, 64), w.expand(2, 64, 64).contiguous(),
                   (128, 128))


def test_autotuned_sliced_equals_masked(gen):
    """Under the autotuner's tiles (``ops.kernel_context(hw=H100_SXM)``)
    the planner's narrowed products equal their zero-padded full shapes
    bit for bit, though the two may take other tiles: an FFN's up cut
    from 2816 to 2112 columns, its down from 2816 to 2112 rows."""
    from repro_torch.core import H100_SXM
    x, w = randn(gen, 512, 1024), randn(gen, 1024, 2816)
    cut = 2112
    wp = w.clone()
    wp[:, cut:] = 0
    with ops.kernel_context(hw=H100_SXM):
        full = ops.matmul(x, wp)
        tiles = [ops.TILES["matmul"]]
        sliced = ops.matmul(x, w[:, :cut].contiguous())
        tiles.append(ops.TILES["matmul"])
        assert torch.equal(full[:, :cut], sliced)
        h, wd = randn(gen, 512, 2816), randn(gen, 2816, 1024)
        hp, wdp = h.clone(), wd.clone()
        hp[:, cut:], wdp[cut:] = 0, 0
        down_full = ops.matmul(hp, wdp)
        tiles.append(ops.TILES["matmul"])
        down_cut = ops.matmul(h[:, :cut].contiguous(),
                              wd[:cut].contiguous())
        tiles.append(ops.TILES["matmul"])
    assert torch.equal(down_full, down_cut), tiles


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
                            "staircase_fused": 0, "staircase_cta": 0, "rglru_scan": 0,
                            "rwkv6": 0, "moe_gmm": 3 * cfg.n_layers,
                            "flash_attention_bwd": 0, "matmul_tiled_bwd": 0,
                            "moe_gmm_bwd": 0, "rglru_scan_bwd": 0,
                            "rwkv6_bwd": 0, "adamw": 0}
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


# ---------------------------------------------------------------------------
# the step cache: whole prefill and decode steps as CUDA graphs
# ---------------------------------------------------------------------------
# reduced families the kernels take (head dim 64 where flash attention runs)
CACHED = {"qwen1.5-0.5b": dict(d_model=256, d_ff=1024, vocab=250),
          "recurrentgemma-2b": {}, "rwkv6-1.6b": {},
          "granite-moe-1b-a400m": dict(d_model=256, d_ff=512, vocab=250,
                                       n_experts=16)}


def cached_family(arch, seed=0):
    cfg = reduced_config(get_config(arch), **CACHED[arch])
    params = tfm.cast_params(
        tfm.init_params(cfg, torch.Generator().manual_seed(seed)), "cuda")
    return cfg, params


def serve_requests(cfg, lens, seed=0, new=6):
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, size=(n,))
                    .astype(np.int32), max_new_tokens=new) for n in lens]


def clone_states(st):
    if isinstance(st, dict):
        return {k: clone_states(v) for k, v in st.items()}
    return st.clone()


def states_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(states_equal(a[k], b[k])
                                            for k in a)
    return torch.equal(a, b)


@pytest.mark.parametrize("arch", sorted(CACHED))
def test_cached_steps_equal_eager_bit_for_bit(gen, arch):
    """A reduced family through ServeEngine with a warm cache: the eager
    engine's tokens and exact launch counts, no miss, fallback or capture
    while serving; a replayed prefill and decode step bit-equal to the
    eager ones on the same inputs."""
    from repro_torch.serving import ServeEngine, WidthVariantCompileCache
    cfg, params = cached_family(arch)
    reqs = serve_requests(cfg, (12, 9, 4, 7))
    eager = ServeEngine(params, cfg, max_len=24, device="cuda")
    cache = WidthVariantCompileCache(cfg)
    cached = ServeEngine(params, cfg, max_len=24, device="cuda",
                         compile_cache=cache)
    assert cached.warm_compile([], [(4, 12)]) == 2
    assert all(e.outcome == "compiled" for e in cache.events)
    count = cache.tracer.count
    ops.reset_launches()
    want = eager.generate(reqs)
    launches = dict(ops.LAUNCHES)
    ops.reset_launches()
    got = cached.generate(reqs)
    assert dict(ops.LAUNCHES) == launches
    for a, b in zip(want, got):
        assert np.array_equal(a.tokens, b.tokens)
    assert cache.stats["misses"] == cache.stats["fallbacks"] == 0
    assert cache.stats["hits"] == 6 and cache.tracer.count == count

    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(4, 12))).cuda()
    with torch.inference_mode():
        logits, st = tfm.forward(params, cfg, tokens=toks, mode="prefill")
        st = eager._ensure_states(st)
    c_logits, _ = cache.prefill(params, toks)
    assert torch.equal(c_logits, logits)
    cur = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)
    st_c = clone_states(st)
    with torch.inference_mode():
        e_logits, st = tfm.decode_step(params, cfg, cur, 12, st)
    c_logits, st_c = cache.decode(params, cur, 12, st_c)
    assert torch.equal(c_logits, e_logits) and states_equal(st_c, st)


def device_kernels_named(fn, name):
    """How many kernels whose name holds ``name`` one call of ``fn`` runs
    on the device, read from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and name in e.key)


def test_replay_adds_the_captured_launches(gen):
    """A replay launches nothing through the wrappers; the cache adds the
    launches its capture recorded, once per replay, and they are the
    kernels one replay runs on the device."""
    from repro_torch.serving import WidthVariantCompileCache
    from repro_torch.serving.compile_cache import decode_state_struct
    cfg, params = cached_family("qwen1.5-0.5b")
    cache = WidthVariantCompileCache(cfg)
    toks = torch.zeros((2, 8), dtype=torch.long, device="cuda")
    cur = torch.zeros(2, dtype=torch.long, device="cuda")
    st = decode_state_struct(cfg, 2, 16, device="cuda")
    before = dict(ops.LAUNCHES)
    assert cache.precompile("prefill", cache.full_key, (2, 8),
                            (params, toks))
    assert cache.precompile("decode", cache.full_key, (2,),
                            (params, cur, 0, st))
    warm = {k: ops.LAUNCHES[k] - before[k] for k in before}
    # the warm-ups launched once each; the captures counted nothing
    assert warm["flash_attention"] == cfg.n_layers
    assert warm["matmul_tiled"] == 2 * 3 * cfg.n_layers
    ops.reset_launches()
    cache.prefill(params, toks)
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    assert ops.LAUNCHES["matmul_tiled"] == 3 * cfg.n_layers
    for t in range(3):
        _, st = cache.decode(params, cur, 8 + t, st)
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    assert ops.LAUNCHES["matmul_tiled"] == 3 * cfg.n_layers * 4
    assert cache.stats["hits"] == 4
    prefill = lambda: cache.prefill(params, toks)           # noqa: E731
    decode = lambda: cache.decode(params, cur, 11, st)      # noqa: E731
    assert device_kernels_named(prefill, "flash_attention_kernel") \
        == cfg.n_layers
    assert device_kernels_named(prefill, "gemm_sm90") == 3 * cfg.n_layers
    assert device_kernels_named(decode, "flash_attention_kernel") == 0
    assert device_kernels_named(decode, "gemm_sm90") == 3 * cfg.n_layers


def test_replays_interleaved_with_eager_gemms_bit_equal(gen):
    """The GEMMs' decode-form scratch is shared by eager launches and
    every graph: replays of a captured decode step (its w_down in 4 K
    chunks) between eager decode steps of the same shapes, and a captured
    decode-form product between eager ones, give each run's own bits."""
    from repro_torch.serving import ServeEngine, WidthVariantCompileCache
    from repro_torch.serving.compile_cache import decode_state_struct
    cfg, params = cached_family("qwen1.5-0.5b")
    assert mt.kernel_form(4, cfg.d_ff) == (True, 4)
    cache = WidthVariantCompileCache(cfg)
    cache.precompile("decode", cache.full_key, (4,),
                     (params, torch.zeros(4, dtype=torch.long,
                                          device="cuda"), 0,
                      decode_state_struct(cfg, 4, 24, device="cuda")))
    eng = ServeEngine(params, cfg, max_len=24, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(4, 10))).cuda()
    cur = torch.tensor([3, 1, 4, 1], device="cuda")
    with torch.inference_mode():
        st0 = eng._ensure_states(tfm.forward(params, cfg, tokens=toks,
                                             mode="prefill")[1])
        ref_st, ref = clone_states(st0), []
        for t in range(4):
            lg, ref_st = tfm.decode_step(params, cfg, cur, 10 + t, ref_st)
            ref.append(lg.clone())
        st_c, st_e = clone_states(st0), clone_states(st0)
        for t in range(4):
            lc, st_c = cache.decode(params, cur, 10 + t, st_c)
            le, st_e = tfm.decode_step(params, cfg, cur, 10 + t, st_e)
            assert torch.equal(lc, ref[t]) and torch.equal(le, ref[t]), t
    assert cache.stats["hits"] == 4
    x, w = randn(gen, 4, 2816), randn(gen, 2816, 1024)
    x2, w2 = randn(gen, 4, 2816), randn(gen, 2816, 1024)
    want, want2 = mt.matmul_tiled(x, w), mt.matmul_tiled(x2, w2)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = mt.matmul_tiled(x, w)
    for _ in range(3):
        graph.replay()
        got2 = mt.matmul_tiled(x2, w2)
        assert torch.equal(out, want) and torch.equal(got2, want2)
        got2 = mt.matmul_tiled(x2, w2)
        graph.replay()
        assert torch.equal(out, want) and torch.equal(got2, want2)


def test_boundaries_on_the_card_replay_only_the_passed_tree(gen):
    """Full width, plan A sliced, plan B masked (replaying the full-width
    key's graphs), full width again, with the swapper at ``max_plans=1``
    so that A's and B's trees are rebuilt at serve time: every step
    replays, and the tokens equal a cold cache's (every step eager on the
    same realizations) at every boundary."""
    from repro_torch.core import H100_SXM
    from repro_torch.serving import (
        ServeEngine, ServingWidthPlanner, TrafficClass,
        WidthPlan, WidthSwapper, WidthVariantCompileCache,
        serving_templates)
    cfg, params = cached_family("qwen1.5-0.5b")
    _, modules = serving_templates(cfg, H100_SXM, tokens=96,
                                   sites=("mlp", "attn"))

    def plan(name, widths, tokens, latency, baseline):
        return WidthPlan(traffic=TrafficClass(name, tokens), widths=widths,
                         latency_s=latency, baseline_latency_s=baseline,
                         satisfied=True, modules=modules)
    plans = [plan("full", {}, 4, 1.0, 2.0),
             plan("A", {n: (cfg.d_ff // 2 if r.site == "mlp"
                            else 2 * cfg.head_dim)
                        for n, r in modules.items()}, 48, 1.0, 2.0),
             plan("B", {n: (cfg.d_ff // 4 if r.site == "mlp"
                            else cfg.head_dim)
                        for n, r in modules.items()}, 20, 0.999, 1.0)]

    def engine(warm):
        planner = ServingWidthPlanner(H100_SXM, [], modules=modules,
                                      device="cuda")
        planner.plans.update({p.traffic.name: p for p in plans})
        cache = WidthVariantCompileCache(cfg)
        eng = ServeEngine(params, cfg, max_len=24, device="cuda",
                          planner=planner,
                          swapper=WidthSwapper(params, cfg, max_plans=1),
                          compile_cache=cache)
        if warm:
            eng.warm_compile(plans, [(4, 1), (4, 12), (4, 5)])
        return eng, cache

    cold, _ = engine(False)
    warm, cache = engine(True)
    count = cache.tracer.count
    for lens, seed in (((1, 1, 1, 1), 3), ((12, 9, 4, 7), 4),
                       ((5, 5, 2, 3), 5), ((1, 1, 1, 1), 6)):
        reqs = serve_requests(cfg, lens, seed)
        for a, b in zip(cold.generate(reqs), warm.generate(reqs)):
            assert np.array_equal(a.tokens, b.tokens)
    assert [e.masked for e in warm.swap_log] == [False, False, True, False]
    assert cache.tracer.count == count
    assert cache.stats["misses"] == cache.stats["fallbacks"] == 0
    assert cache.stats["hits"] == 4 * 6


# ---------------------------------------------------------------------------
# the continuous engine's steps through the cache
# ---------------------------------------------------------------------------
def test_chunk_replay_equals_eager_chunk(gen):
    """The chunk kind's graph, captured at one position, replays at every
    other bit-equal to the eager chunk, into the caller's own states."""
    from repro_torch.serving import WidthVariantCompileCache
    cfg, params = cached_family("qwen1.5-0.5b")
    cache = WidthVariantCompileCache(cfg)
    zeros = torch.zeros((1, 8), dtype=torch.long, device="cuda")
    assert cache.precompile("chunk", cache.full_key, (1, 8),
                            (params, zeros, 0,
                             tfm.init_decode_state(cfg, 1, 32, "cuda")))
    mine = tfm.init_decode_state(cfg, 1, 32, "cuda")
    ref = tfm.init_decode_state(cfg, 1, 32, "cuda")
    rng = np.random.default_rng(2)
    for pos in (0, 8, 16, 24):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             size=(1, 8))).cuda()
        got, st = cache.chunk(params, toks, pos, mine)
        with torch.inference_mode():
            want, ref = tfm.prefill_chunk(params, cfg, toks, pos, ref)
        assert st is mine and states_equal(st, ref)
        assert torch.equal(got, want)
    assert cache.stats["hits"] == 4 and cache.stats["fallbacks"] == 0


def test_ragged_decode_replay_equals_eager(gen):
    """A ragged decode step (each row at its own position) through the
    graph, bit-equal to the eager step on the same inputs."""
    from repro_torch.serving import WidthVariantCompileCache
    cfg, params = cached_family("qwen1.5-0.5b")
    cache = WidthVariantCompileCache(cfg)
    cur = torch.zeros(4, dtype=torch.long, device="cuda")
    assert cache.precompile("decode", cache.full_key, (4,),
                            (params, cur, cur.clone(),
                             tfm.init_decode_state(cfg, 4, 32, "cuda")))
    with torch.inference_mode():
        _, st = tfm.forward(params, cfg, tokens=torch.from_numpy(
            np.random.default_rng(3).integers(0, cfg.vocab_size,
                                              size=(4, 20))).cuda(),
            mode="prefill")
        st = {g: {k: {n: torch.nn.functional.pad(
            x, (0, 0, 0, 0, 0, 12)) for n, x in d.items()}
            for k, d in sub.items()} for g, sub in st.items()}
    st_c = clone_states(st)
    pos = torch.tensor([20, 3, 11, 0], device="cuda")
    cur = torch.tensor([5, 9, 1, 7], device="cuda")
    for _ in range(3):
        with torch.inference_mode():
            want, st = tfm.decode_step(params, cfg, cur, pos, st)
        got, st_c = cache.decode(params, cur, pos, st_c)
        assert torch.equal(got, want) and states_equal(st_c, st)
        cur, pos = torch.argmax(want[:, :cfg.vocab_size], dim=-1), pos + 1


@pytest.mark.parametrize("chunk", [None, 8])
def test_small_continuous_run_replays_every_step(gen, chunk):
    """A reduced qwen through the continuous engine with a warm cache, in
    whole-prompt and chunked joins: zero fallbacks, misses and captures
    while serving, and the tokens of the same engine without a cache
    (bucketed alike, so that every step runs the same shapes)."""
    from repro_torch.serving import (
        ContinuousServeEngine, WidthVariantCompileCache)
    cfg, params = cached_family("qwen1.5-0.5b")
    lens = (12, 9, 30, 4, 17)
    cache = WidthVariantCompileCache(cfg)

    def engine(c):
        return ContinuousServeEngine(params, cfg, max_len=48, batch_slots=2,
                                     device="cuda", compile_cache=c,
                                     prefill_bucketing=True,
                                     prefill_chunk=chunk)

    warm = engine(cache)
    assert warm.warm_compile([], lens) >= 2
    count = cache.tracer.count
    got = warm.run(serve_requests(cfg, lens, new=7))
    want = engine(None).run(serve_requests(cfg, lens, new=7))
    for a, b in zip(want, got):
        assert np.array_equal(a.tokens, b.tokens)
    assert cache.stats["misses"] == cache.stats["fallbacks"] == 0
    assert cache.tracer.count == count and warm.ledger().complete


# ---------------------------------------------------------------------------
# the hedged fleet (serving/router.py) on the card
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hedge,crash_at", [(None, None), (0, 2), (1, 2)])
def test_small_fleet_equals_the_cpu_run(gen, hedge, crash_at):
    """Two replicas of a reduced qwen, each with a warm step cache of its
    own, replica 0 stalled 8x (and crashing): the router ledger, hedge and
    health logs, every engine's ledger and plan log and every result's
    latency equal the same fleet's on the CPU, and no capture happens
    while serving. At rung 1 both devices get one ladder object (built on
    the CPU, ``TPU_V5E``, at the fleet's class), so the backups' narrowed
    widths are equal by construction and the card's narrowed replays are
    held to the CPU's."""
    import dataclasses
    from repro_torch.launch import serve_resilient as sr
    from repro_torch.serving import WidthVariantCompileCache
    cfg, params = cached_family("qwen1.5-0.5b")
    arrs = sr.fleet_arrivals(cfg, n=16, prompt_lens=13, new_tokens=8,
                             gap_s=0.001, seed=7)
    ladder = None
    if hedge == 1:
        tokens = sr.fleet_tokens(arrs, slots=4, prefill_chunk=4)
        ladder = sr.ladder_for(cfg, torch.device("cpu"), tokens=tokens)[1]
    runs = {}
    for dev in ("cpu", "cuda"):
        caches = [WidthVariantCompileCache(cfg) for _ in range(2)]
        reps = sr.build_fleet(tfm.cast_params(params, dev), cfg, device=dev,
                              max_len=48, crash_at=crash_at, caches=caches,
                              ladder=ladder, warm_lengths=(13,))
        counts = [c.tracer.count for c in caches]
        out = sr.serve_fleet(reps, arrs, hedge=hedge)
        router = out["router"]
        assert [c.tracer.count for c in caches] == counts
        assert all(c.stats["misses"] == c.stats["fallbacks"] == 0
                   for c in caches)
        runs[dev] = (dataclasses.astuple(out["ledger"]),
                     [dataclasses.astuple(h) for h in router.hedge_log],
                     [dataclasses.astuple(h) for h in router.health_log],
                     [dataclasses.astuple(r.engine.ledger())
                      for r in router.replicas],
                     [(len(r.tokens), r.latency_s, r.shed, r.failed,
                       r.hedged, r.won_by, r.migrations)
                      for r in out["results"]],
                     [[sorted(p.widths.items()) for p in r.engine.plan_log]
                      for r in router.replicas])
    assert runs["cuda"] == runs["cpu"]
    led = runs["cuda"][0]
    assert led[1] == 16 and (led[4] > 0) == (hedge is not None)
    assert any(w < cfg.d_ff for plans in runs["cuda"][5] for p in plans
               for _, w in p) == (hedge == 1)
    assert bool(runs["cuda"][2]) == (crash_at is not None)


# ---------------------------------------------------------------------------
# the paper's Table 2 convnet: its conv products on matmul_tiled
# ---------------------------------------------------------------------------
TABLE2_NETS = [(128, 192, 320, 448), (84, 127, 211, 296),
               (64, 64, 211, 296), (64, 64, 192, 256)]


@pytest.mark.parametrize("batch,image", [(1, 16), (32, 16), (64, 32)])
@pytest.mark.parametrize("widths", TABLE2_NETS)
def test_convnet_forward_on_the_kernel(gen, batch, image, widths):
    """The bf16 forward with its conv products on ``matmul_tiled`` against
    the same forward on the plain versions (within 4e-2 of the largest
    logit); 4 launches a forward; every product, the baseline's unaligned
    widths included, on TMA loads with its grid the B that
    ``CtaWaveModel`` prices on the card's spec."""
    from repro_torch.core.gpu import GpuSpec
    from repro_torch.core.tail_model import CtaWaveModel
    from repro_torch.models import convnet as cn
    params = cn.init_convnet(gen, widths, image=image)
    x = torch.randn(batch, image, image, 3, generator=gen,
                    device="cuda").bfloat16()
    model = CtaWaveModel(GpuSpec.from_device("cuda"))
    with torch.no_grad():
        loads = []
        before = ops.LAUNCHES["matmul_tiled"]
        got, _ = cn.forward_convnet(params, x, loads=loads)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["matmul_tiled"] == before + len(widths)
        want, _ = cn.forward_convnet(params, x, force="plain")
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= 4e-2 * scale
    assert loads == ["tma"] * len(widths)
    shapes = cn.conv_layer_shapes(widths, batch=batch, image=image)
    for s, wm in zip(shapes, cn.conv_operands(params, torch.bfloat16)):
        k, n = wm.shape
        assert k % 8 == 0 and n % 8 == 0
        assert mt.grid_blocks(s.tokens, n, k) == model.blocks(s)


def test_convnet_kernel_route_refuses_grad(gen):
    from repro_torch.models import convnet as cn
    kern = torch.randn(3, 3, 3, 8, generator=gen, device="cuda",
                       requires_grad=True)
    x = torch.randn(1, 8, 8, 3, generator=gen, device="cuda").bfloat16()
    with pytest.raises(RuntimeError, match="no gradient"):
        cn.conv3x3(x, kern)


def test_hrank_scores_card_vs_cpu(gen):
    """HRank's ranks from cuSOLVER against the CPU's on one batch of ReLU
    maps: a map's count differs only where a singular value lies within a
    factor 2 of the threshold."""
    from repro_torch.core import pruning
    acts = torch.relu(torch.randn(8, 8, 8, 64, generator=gen,
                                  device="cuda"))
    acts[..., :4] = 1.0
    on_card = pruning.feature_map_rank_scores(acts)
    on_cpu = pruning.feature_map_rank_scores(acts.cpu())
    b, h, w, c = acts.shape
    sv = torch.linalg.svdvals(acts.cpu().permute(0, 3, 1, 2).reshape(
        b * c, h, w))
    th = sv[:, :1] * max(h, w) * torch.finfo(torch.float32).eps
    near = ((sv > th / 2) & (sv < th * 2)).any(-1).reshape(b, c).sum(0)
    assert (np.abs(on_card - on_cpu) <= near.numpy() / b).all()
    assert on_card[:4].max() < on_card[4:].min()


# ---------------------------------------------------------------------------
# training: the backward kernels and a train step on the card
# ---------------------------------------------------------------------------
# (B, Sq, Skv, H, KV, dh, mask): full-width qwen1.5-0.5b's training shape,
# granite-moe-1b-a400m's (GQA group 2), GQA groups 2 and 7, dh 128, ragged
# S, seamless-m4t-medium's unmasked encoder (150 frames) and
# cross-attention (32 queries on 150 keys), Sq != Skv unmasked, and the two
# long sequences of the forward's cases (many ring refills, both head dims)
BWD_CASES = [(8, 128, 128, 16, 16, 64, "causal"),
             (4, 128, 128, 16, 8, 64, "causal"),
             (1, 70, 70, 7, 1, 64, "causal"),
             (2, 100, 100, 14, 2, 128, "causal"),
             (1, 100, 100, 4, 4, 64, "causal"),
             (2, 150, 150, 16, 16, 64, "none"),
             (4, 32, 150, 16, 16, 64, "none"),
             (1, 40, 97, 7, 1, 128, "none"),
             (8, 128, 128, 16, 8, 64, "causal"),
             (4, 2048, 2048, 16, 16, 64, "causal"),
             (1, 4096, 4096, 8, 2, 128, "causal")]


def _bwd_inputs(gen, b, sq, skv, h, kv, dh, mask):
    q, k, v = randn(gen, b, sq, h, dh), randn(gen, b, skv, kv, dh), \
        randn(gen, b, skv, kv, dh)
    do = randn(gen, b, sq, h, dh)
    o, lse = fa.flash_attention(q, k, v, mask_kind=mask, lse=True)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_kernel_vs_plain(gen, case):
    """dq, dk, dv of the backward kernel against ``attention_bwd_ref`` on the
    same (q, k, v, O, lse, dO), within 4e-2 of each one's largest |value|
    (the bf16 bound of tests/test_kernels.py:23: the kernel rounds P and dS
    to bf16 as operands and each gradient to bf16, the plain version keeps
    fp32 until its cast); one launch counted."""
    mask = case[-1]
    q, k, v, o, lse, do = _bwd_inputs(gen, *case)
    before = ops.LAUNCHES["flash_attention_bwd"]
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, mask_kind=mask)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_bwd"] == before + 1
    want = fa.attention_bwd_ref(q, k, v, o, lse, do, mask_kind=mask)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        w = w.float()
        err = (g.float() - w).abs().max().item()
        assert bool(torch.isfinite(g.float()).all()) and \
            err <= 4e-2 * w.abs().max().item(), (name, err)


@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_kernel_repeats_bit_equal(gen, case):
    """No atomics: two backward calls on the same inputs are bit-equal."""
    q, k, v, o, lse, do = _bwd_inputs(gen, *case)
    a = fa.flash_attention_bwd(q, k, v, o, lse, do, mask_kind=case[-1])
    b = fa.flash_attention_bwd(q, k, v, o, lse, do, mask_kind=case[-1])
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_kernel_lse_is_the_plain_lse(gen, case):
    """The forward with its log-sum-exp writes the same output as without
    it, and an lse within 1e-3 of the plain version's fp32 logsumexp (both
    from the same bf16 scores, summed in other orders and exponentiated on
    the special-function unit: a few fp32 ulps of the row's largest score,
    far below 1e-3)."""
    b, sq, skv, h, kv, dh, mask = case
    q, k, v = randn(gen, b, sq, h, dh), randn(gen, b, skv, kv, dh), \
        randn(gen, b, skv, kv, dh)
    o, lse = fa.flash_attention(q, k, v, mask_kind=mask, lse=True)
    assert torch.equal(o, fa.flash_attention(q, k, v, mask_kind=mask))
    _, want = fa.attention_ref(q, k, v, mask_kind=mask, lse=True)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    assert (lse - want).abs().max().item() <= 1e-3


def test_flash_bwd_kernel_form_and_refusals(gen):
    """The backward's one kernel as built: the form ``BWD_FORMS`` states
    (threads, shared memory, CTAs an SM, stages), no spills; and what the
    wrapper refuses."""
    for dh in fa.HEAD_DIMS:
        f = fa.bwd_form(dh)
        assert {k: f[k] for k in fa.BWD_FORMS[dh]} == fa.BWD_FORMS[dh]
        assert f["registers"] <= 255 and f["spill_bytes"] == 0
    q, k, v, o, lse, do = _bwd_inputs(gen, 1, 64, 64, 4, 4, 64, "causal")
    with pytest.raises(ValueError, match="mask_kind"):
        fa.flash_attention_bwd(q, k, v, o, lse, do, mask_kind="local")
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, k, v, o, lse.double(), do)
    with pytest.raises(RuntimeError, match="masks"):
        ops.flash_attention(q.requires_grad_(True), k, v, mask_kind="local",
                            window=16)


@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_kernel_order_is_bwd_order(gen, case):
    """The kernel's grid order (its ``cta_of``, compiled for the host in the
    same library) is the module's ``bwd_order``, which the CPU tests hold
    to the gradient and to visiting every visible pair once a role."""
    b, sq, skv, h, kv, _, mask = case
    assert fa.bwd_order(b, sq, skv, h, kv, mask, device="cuda") == \
        fa.bwd_order(b, sq, skv, h, kv, mask)


# full-width qwen1.5-0.5b's backward shapes at 8 x 128 tokens (up/gate
# and down), a ragged one and one at the decode form's M
@pytest.mark.parametrize("m,k,n", [(1024, 1024, 2816), (1024, 2816, 1024),
                                   (300, 130, 72), (48, 256, 200)])
def test_matmul_bwd_kernel_vs_plain(gen, m, k, n):
    """``ops.matmul`` under autograd on the card: the output equals the
    forward alone; dX and dW (two launches counted as ``matmul_tiled_bwd``)
    within two bf16 steps of ``matmul_bwd_ref``'s largest |value| (each is
    one fp32 sum rounded to bf16 in both)."""
    x = randn(gen, m, k).requires_grad_(True)
    w = randn(gen, k, n).requires_grad_(True)
    dy = randn(gen, m, n)
    out = ops.matmul(x, w)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), mt.matmul_tiled(x.detach(),
                                                     w.detach()))
    before = ops.LAUNCHES["matmul_tiled_bwd"]
    out.backward(dy)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["matmul_tiled_bwd"] == before + 2
    for g, want in zip((x.grad, w.grad), mt.matmul_bwd_ref(
            x.detach(), w.detach(), dy)):
        want = want.float()
        err = (g.float() - want).abs().max().item()
        assert err <= 2.0 ** -7 * 2 * want.abs().max().item()


# the new backwards' cases: granite's training products (E 32, 1024 tokens:
# gate/up with x broadcast, down), a capacity buffer, ragged edges; the
# RG-LRU at recurrentgemma's training shape, ragged W and T, one step; RWKV6
# at rwkv6-1.6b's training shape, steep decays from a state with a state
# cotangent, ragged T, the padded head dims 16, 20, 96 and 128
MOE_BWD_CASES = [(32, 1024, 1024, 512, True), (32, 1024, 512, 1024, False),
                 (32, 161, 1024, 512, False), (2, 65, 64, 63, False),
                 (3, 33, 31, 40, True)]
RGLRU_BWD_CASES = [(8, 128, 2560), (8, 128, 2500), (2, 97, 2501),
                   (1, 1, 7), (3, 300, 33), (1, 2048, 2560), (2, 256, 512)]
RWKV_BWD_CASES = [
    (8, 128, 32, 64, None, False, torch.bfloat16),   # the training path
    (2, 97, 4, 64, None, True, torch.bfloat16),
    (2, 96, 4, 64, -54.6, True, torch.float32),
    (2, 96, 4, 64, -8.0, True, torch.float32),
    (2, 40, 2, 16, -3.4e-4, True, torch.float32),
    (1, 33, 2, 128, None, True, torch.float32),
    (2, 45, 2, 20, None, False, torch.bfloat16),
    (2, 50, 2, 96, None, True, torch.bfloat16),
    (1, 1, 2, 64, None, True, torch.float32),
    # many chunks (32 of 32 rows), and T below one chunk
    (1, 1024, 2, 64, None, True, torch.float32),
    (1, 1024, 4, 64, None, False, torch.bfloat16),
    (2, 17, 3, 64, -8.0, True, torch.float32),
    (2, 31, 2, 128, None, False, torch.bfloat16),
]


def bwd_close(got, want, what):
    """fp32 gradients within 2e-4 of the largest (the fp32 bound of
    tests/test_kernels.py:23: both sum in fp32, in other orders); bf16 ones
    within two bf16 steps of the largest (each an fp32 sum rounded once)."""
    tol = 2e-4 if want.dtype == torch.float32 else 2.0 ** -6
    want = want.float()
    err = (got.float() - want).abs().max().item()
    assert got.dtype == want.dtype or got.dtype != torch.float32, what
    assert bool(torch.isfinite(got.float()).all()), what
    assert err <= tol * max(want.abs().max().item(), 1e-30), (what, err)


@pytest.mark.parametrize("e,c,d,f,broadcast", MOE_BWD_CASES)
def test_moe_gmm_bwd_kernel_vs_plain(gen, e, c, d, f, broadcast):
    """dX = dY W^T and dW = X^T dY: two launches of the kernel, counted as
    ``moe_gmm_bwd``, against the plain version (two bf16 steps of the
    largest, as the matmul backward's), bit-equal on a repeat."""
    x = randn(gen, c, d).expand(e, c, d) if broadcast else randn(gen, e, c, d)
    w, dy = randn(gen, e, d, f), randn(gen, e, c, f)
    before = dict(ops.LAUNCHES)
    got = mg.moe_gmm_bwd(x, w, dy)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["moe_gmm_bwd"] == before["moe_gmm_bwd"] + 2
    assert ops.LAUNCHES["moe_gmm"] == before["moe_gmm"]
    for name, g, want in zip(("dx", "dw"), got, mg.moe_gmm_bwd_ref(x, w, dy)):
        assert g.shape == want.shape and g.dtype == torch.bfloat16
        bwd_close(g, want, name)
    again = mg.moe_gmm_bwd(x, w, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert mg.moe_gmm_bwd(x, w, dy, (False, True))[0] is None


# the backward's products, each (x, w) as the backward hands them: (name,
# x view, w view) of dX = dY W^T (w K-major) and dW = X^T dY (x MN-major)
def _bwd_products(gen, e, m, k, n, broadcast=False):
    if e == 0:
        x, w, dy = randn(gen, m, k), randn(gen, k, n), randn(gen, m, n)
        return [("dx", dy[None], w.t()[None]), ("dw", x.t()[None], dy[None])]
    x = randn(gen, m, k).expand(e, m, k) if broadcast else randn(gen, e, m, k)
    w, dy = randn(gen, e, k, n), randn(gen, e, m, n)
    return [("dx", dy, w.transpose(1, 2)), ("dw", x.transpose(1, 2), dy)]


def _bwd_tiles(m):
    return [mt.DECODE_TILE] if m <= mt.DECODE_BLOCK_M else list(mt.BWD_TILES)


# (E, M, K, N, x broadcast): E 0 is matmul_bwd's 2-D product; the
# matmul backward's sweep and MOE_BWD_CASES
GEMM_BWD_CASES = [(0, 1024, 1024, 2816, False), (0, 1024, 2816, 1024, False),
                  (0, 300, 130, 72, False), (0, 48, 256, 200, False)] + \
    [(e, c, d, f, b) for e, c, d, f, b in MOE_BWD_CASES]


@pytest.mark.parametrize("case", GEMM_BWD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_gemm_bwd_forms_vs_plain_and_copies(gen, case):
    """Each backward product on each of its tiles, read where it lies (w
    K-major for dX, x MN-major for dW): within two bf16 steps of the plain
    product, bit-equal on a repeat, and bit-equal to the same tile reading
    a contiguous copy of the same values (the layout moves no bit)."""
    e, m, k, n, broadcast = case
    name, bind = (mt.NAME, mt._bind) if e == 0 else (mg.NAME, mg._bind)
    for what, x, w in _bwd_products(gen, e, m, k, n, broadcast):
        want = mg.moe_gmm_ref(x, w).float()
        for tile in _bwd_tiles(x.shape[1]):
            got = mt.launch_bwd(name, bind, x, w, "moe_gmm_bwd", tile)
            torch.cuda.synchronize()
            assert mt.LAST_BWD["tile"] == tile
            strides = mt.operand_layout(x.shape, x.stride(), w.shape,
                                        w.stride())[2:]
            if x.shape[0] > 1:
                strides += (x.stride(0), w.stride(0))
            assert mt.LAST_BWD["loads"] == (
                "tma" if all(v % 8 == 0 for v in strides)
                else "elementwise"), (what, tile)
            assert (mt.LAST_BWD["x_mn"], mt.LAST_BWD["w_k"]) == \
                (what == "dw" and x.shape[2] > 1, what == "dx"
                 and w.shape[1] > 1 and w.shape[2] > 1), (what, tile)
            err = (got.float() - want).abs().max().item()
            assert err <= 2.0 ** -6 * max(want.abs().max().item(), 1e-30), \
                (what, tile, err)
            assert torch.equal(got, mt.launch_bwd(name, bind, x, w,
                                                  "moe_gmm_bwd", tile))
            copied = mt.launch_bwd(name, bind, x.contiguous(), w.contiguous(),
                                   "moe_gmm_bwd", tile)
            assert (mt.LAST_BWD["x_mn"], mt.LAST_BWD["w_k"]) == \
                (False, False)
            assert torch.equal(got, copied), (what, tile)


@pytest.mark.parametrize("m,k,n", [(512, 1024, 2816), (300, 130, 72),
                                   (48, 256, 200), (1024, 2816, 1024)])
def test_gemm_forward_equals_backward_form_on_its_tile(gen, m, k, n):
    """The forward's own forms are unchanged: on (128, 64) and the decode
    tile the forward's output equals the backward form's on the same
    contiguous operands bit for bit (the same products in the same
    order)."""
    x, w = randn(gen, m, k), randn(gen, k, n)
    tile = mt.DECODE_TILE if m <= mt.DECODE_BLOCK_M else (128, 64)
    fwd = mt.matmul_tiled(x, w, None if m <= mt.DECODE_BLOCK_M else tile)
    bwd = mt.launch_bwd(mt.NAME, mt._bind, x[None], w[None],
                        "matmul_tiled_bwd", tile)[0]
    assert torch.equal(fwd, bwd)


def test_gemm_bwd_forms_on_the_card(gen):
    """Every backward form builds, as ``BWD_FORMS`` has it, with no
    spilled registers, in each layout; the decode form refuses a prefill
    tile; the forward's forms keep ``FORMS``."""
    for tile, want in mt.BWD_FORMS.items():
        for x_mn, w_k in ((False, False), (True, False), (False, True)):
            for module in (mt, mg):
                f = module.bwd_form(tile, x_mn, w_k)
                assert {k: f[k] for k in want} == want, (tile, x_mn, w_k)
                assert f["spill_bytes"] == 0 and f["registers"] <= 255
    with pytest.raises(ValueError, match="decode form"):
        mt.launch_bwd(mt.NAME, mt._bind, randn(gen, 1, 48, 64),
                      randn(gen, 1, 64, 64), "matmul_tiled_bwd", (128, 64))
    for (kind, tile), want in mt.FORMS.items():
        f = mt.form(kind, tile=tile)
        assert {k: f[k] for k in want} == want


def test_gemm_bwd_refuses_what_it_cannot_read(gen):
    """A layout with no unit stride, or both operands transposed, raises:
    nothing is copied and no plain version runs."""
    x, w = randn(gen, 64, 256)[:, ::2], randn(gen, 128, 96)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="neither"):
        mt.launch_bwd(mt.NAME, mt._bind, x[None], w[None],
                      "matmul_tiled_bwd")
    xt, wt = randn(gen, 128, 96).t(), randn(gen, 64, 128).t()
    with pytest.raises(ValueError, match="not both"):
        mt.launch_bwd(mt.NAME, mt._bind, xt[None], wt[None],
                      "matmul_tiled_bwd")
    with pytest.raises(ValueError, match="no backward tile"):
        mt.launch_bwd(mt.NAME, mt._bind, randn(gen, 1, 128, 64),
                      randn(gen, 1, 64, 64), "matmul_tiled_bwd", (256, 64))
    assert dict(ops.LAUNCHES) == before


@pytest.mark.parametrize("b,t,w", RGLRU_BWD_CASES)
@pytest.mark.parametrize("dh_last", [False, True])
def test_rglru_bwd_kernel_vs_plain(gen, b, t, w, dh_last):
    """The reverse walk on the card equals the plain backward bit for bit:
    both round each product and sum in the same order (no FMA), and a
    repeat gives the same bits."""
    a, x, h0 = rglru_inputs(gen, b, t, w)
    y, _ = rg.rglru_scan(a, x, h0)
    dy = torch.randn(b, t, w, generator=gen, device="cuda")
    dh = torch.randn(b, w, generator=gen, device="cuda") if dh_last else None
    before = ops.LAUNCHES["rglru_scan_bwd"]
    got = rg.rglru_scan_bwd(a, y, h0, dy, dh)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rglru_scan_bwd"] == before + 1
    for g, want in zip(got, rg.rglru_bwd_ref(a, y, h0, dy, dh)):
        assert torch.equal(g, want)
    assert all(torch.equal(p, q) for p, q in
               zip(got, rg.rglru_scan_bwd(a, y, h0, dy, dh)))


def rglru_bwd_inputs(gen, b, t, w):
    a, x, h0 = rglru_inputs(gen, b, t, w)
    y, _ = rg.rglru_scan(a, x, h0)
    dy = torch.randn(b, t, w, generator=gen, device="cuda")
    dh = torch.randn(b, w, generator=gen, device="cuda")
    return a, y, h0, dy, dh


@pytest.mark.parametrize("form", rg.bwd_forms(),
                         ids=lambda f: "tw{}-s{}".format(*f))
@pytest.mark.parametrize("route", ["tma", "cp.async"])
def test_rglru_bwd_kernel_every_form(gen, form, route):
    """Each compiled form (window, ring slots) by each copy route, forced,
    at a ragged T (several windows, a ragged first one) and a ragged
    strip: bit-equal to the plain backward, and the compiled kernel's
    threads and shared memory are what the host counts, it holds at least
    the CTAs an SM the host counts, and it spills nothing."""
    window, stages = form
    args = rglru_bwd_inputs(gen, 2, 150, 260)
    f = {"window": window, "stages": stages, "route": route}
    got = rg.launch_bwd(*args, form=f)
    for g, want in zip(got, rg.rglru_bwd_ref(*args)):
        assert torch.equal(g, want)
    at = rg.bwd_attrs(window, stages, route)
    assert at["threads"] == rg.BWD_CHANNELS and at["spill_bytes"] == 0
    assert at["smem_bytes"] == rg.bwd_smem_bytes(window, stages)
    assert at["registers"] <= rg.BWD_MAX_REGISTERS
    assert at["ctas_per_sm"] >= rg.bwd_ctas_per_sm(
        at["smem_bytes"],
        torch.cuda.get_device_properties(0).shared_memory_per_multiprocessor)


def test_rglru_bwd_kernel_unaligned_base(gen):
    """Views 4 bytes past a 16-byte boundary take the cp.async route: bit
    equal to the plain backward and to the TMA route on aligned copies;
    a TMA form forced on them raises."""
    args = rglru_bwd_inputs(gen, 2, 150, 256)
    views = []
    for x in args[:4]:
        store = torch.empty(x.numel() + 1, device="cuda")
        v = store[1:].view_as(x)
        v.copy_(x)
        assert v.data_ptr() % 16 == 4 and v.is_contiguous()
        views.append(v)
    views.append(args[4])
    assert rg.bwd_form(2, 150, 256)["route"] == "tma"
    assert rg.bwd_form(2, 150, 256, aligned=False)["route"] == "cp.async"
    got = rg.rglru_scan_bwd(*views)
    for g, aligned, want in zip(got, rg.rglru_scan_bwd(*args),
                                rg.rglru_bwd_ref(*args)):
        assert torch.equal(g, aligned) and torch.equal(g, want)
    with pytest.raises(ValueError, match="TMA route"):
        rg.launch_bwd(*views, form=rg.bwd_form(2, 150, 256))


def test_rglru_bwd_kernel_form_and_graph(gen):
    """At recurrentgemma-2b's training shape the host's form fills one
    wave (640 one-warp CTAs, 6 an SM on the card, the busiest SM 5), the
    compiled kernel holds those CTAs an SM with no spills, and a call
    captured in a CUDA graph equals the eager call bit for bit."""
    f = rg.bwd_form(8, 128, 2560)
    assert (f["ctas"], f["channels"], f["waves"], f["busiest_ctas"]) == \
        (640, 32, 1, 5)
    at = rg.bwd_attrs(f["window"], f["stages"], f["route"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert at["spill_bytes"] == 0 and at["ctas_per_sm"] * sms >= f["ctas"]
    args = rglru_bwd_inputs(gen, 8, 128, 2560)
    eager = rg.rglru_scan_bwd(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rg.rglru_scan_bwd(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = rg.rglru_scan_bwd(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(captured, eager))


@pytest.mark.parametrize("case", RWKV_BWD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_rwkv6_bwd_kernel_vs_plain(gen, case):
    """The backward kernel against the plain backward's explicit formulas:
    finite at the decay extremes, within ``bwd_close`` of each gradient's
    largest; a repeat gives the same bits (du summed over the batch in a
    fixed order, no atomics)."""
    b, t, h, dh, lw, state, dtype = case
    r, k, v, log_w, u, s0 = rwkv_inputs(gen, b, t, h, dh, lw, state, dtype)
    do = torch.randn(b, t, h, dh, generator=gen, device="cuda")
    ds = torch.randn(b, h, dh, dh, generator=gen, device="cuda") \
        if state else None
    before = ops.LAUNCHES["rwkv6_bwd"]
    got = rw.rwkv6_bwd(r, k, v, log_w, u, s0, do, ds)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rwkv6_bwd"] == before + 1
    want = rw.rwkv6_bwd_ref(r, k, v, log_w, u, s0, do, ds)
    for name, g, w in zip(("dr", "dk", "dv", "dlog_w", "du", "ds0"), got,
                          want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        bwd_close(g, w, name)
    again = rw.rwkv6_bwd(r, k, v, log_w, u, s0, do, ds)
    assert all(torch.equal(p, q) for p, q in zip(got, again))


@pytest.mark.parametrize("case", [(2, 96, 2, 64, -8.0, True, torch.float32),
                                  (1, 97, 2, 16, None, True, torch.float32),
                                  (2, 70, 2, 64, None, False, torch.bfloat16),
                                  (1, 40, 2, 128, -54.6, True, torch.float32)],
                         ids=lambda c: "-".join(map(str, c)))
def test_rwkv6_bwd_kernel_vs_chunked_transcription(gen, case):
    """The kernel against its chunked algorithm transcribed into torch
    (tests/_rwkv6_bwd_chunks.py: the same passes, chunks, sub-chunk factors
    and dlog_w sums, in torch's order of each sum), within ``bwd_close``."""
    from _rwkv6_bwd_chunks import rwkv6_bwd_chunked
    b, t, h, dh, lw, state, dtype = case
    r, k, v, log_w, u, s0 = rwkv_inputs(gen, b, t, h, dh, lw, state, dtype)
    do = torch.randn(b, t, h, dh, generator=gen, device="cuda")
    ds = torch.randn(b, h, dh, dh, generator=gen, device="cuda") \
        if state else None
    got = rw.rwkv6_bwd(r, k, v, log_w, u, s0, do, ds)
    want = rwkv6_bwd_chunked(r, k, v, log_w, u, s0, do, ds,
                             chunk=rw.bwd_form(dh, dtype, state)["chunk"])
    for name, g, w in zip(("dr", "dk", "dv", "dlog_w", "du", "ds0"), got,
                          want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        bwd_close(g, w, name)


def one_call_kernels(fn, path):
    """The kernel nodes of one call of ``fn`` captured in a CUDA graph, as
    the text of each node of the graph's DOT dump (written to ``path``):
    what one replay runs."""
    import re
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                 # warm-up before the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(True)       # keep the graph to dump it
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        fn()
    graph.debug_dump(str(path))
    nodes = re.split(r'(?m)^\s*"?graph_\d+_node_\d+"?\s*\[',
                     path.read_text())[1:]
    return [n for n in nodes if 'label="{KERNEL' in n]


def traced_forms(fn, path):
    """{(name, CTAs, threads a CTA)} of the kernels that three calls of
    ``fn`` run on the device, read from a ``torch.profiler`` trace
    (exported as Chrome JSON to ``path``) of those calls after a warm-up
    call."""
    import json
    import math
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    return {(e["name"], math.prod(e["args"]["grid"]),
             math.prod(e["args"]["block"]))
            for e in json.loads(path.read_text())["traceEvents"]
            if str(e.get("cat", "")).lower() == "kernel"}


def test_rwkv6_bwd_kernel_form_and_refusals(gen, tmp_path):
    """The form at the training path's head dim, with a call at the
    training shape (B 8, T 128, H 32) captured in a CUDA graph and traced
    by the profiler: three kernels a call, launch 1 (``rwkv6_bwd_scan``)
    512 CTAs of 128 threads, a CTA per (pass, b, h) and all 64 value
    columns, launch 2 (``rwkv6_bwd_chunk``) 1024 CTAs of 256 threads, a
    CTA per (b, h, chunk of 32 rows), then du's sum; no spills in either;
    16 rows a chunk at head dim 128. And what the wrapper refuses: a head
    dim past 128, mixed dtypes, a do that is not fp32."""
    for dtype, state in ((torch.bfloat16, False), (torch.float32, True)):
        f = rw.bwd_form(64, dtype, state)
        assert f["chunk"] == 32, f
        assert f["threads"] == 256 and f["scan_threads"] == 128, f
        assert f["spill_bytes"] == 0 and f["scan_spill_bytes"] == 0, f
        assert f["ctas_per_sm"] >= 1 and f["scan_ctas_per_sm"] >= 1, f
        args = rwkv_inputs(gen, 8, 128, 32, 64, None, state, dtype)
        do = torch.randn(8, 128, 32, 64, generator=gen, device="cuda")
        ds = torch.randn(8, 32, 64, 64, generator=gen, device="cuda") \
            if state else None
        def call():
            return rw.rwkv6_bwd(*args, do, ds)
        nodes = one_call_kernels(call, tmp_path / f"{dtype}-{state}.dot")
        assert len(nodes) == 3, nodes
        assert [sum(f"rwkv6_bwd_{w}" in n for n in nodes)
                for w in ("scan", "chunk")] == [1, 1], nodes
        ran = traced_forms(call, tmp_path / f"{dtype}-{state}.json")
        assert {x[1:] for x in ran if "rwkv6_bwd_scan" in x[0]} == \
            {(512, 128)}, ran
        assert {x[1:] for x in ran if "rwkv6_bwd_chunk" in x[0]} == \
            {(1024, 256)}, ran
    assert rw.bwd_form(128)["chunk"] == 16
    r, k, v, log_w, u, _ = rwkv_inputs(gen, 1, 8, 2, 129)
    do = torch.randn(1, 8, 2, 129, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        rw.rwkv6_bwd(r, k, v, log_w, u, None, do)
    r, k, v, log_w, u, _ = rwkv_inputs(gen, 1, 8, 2, 64)
    with pytest.raises(TypeError):
        rw.rwkv6_bwd(r.bfloat16(), k, v, log_w, u, None, do[..., :64])
    with pytest.raises(TypeError):
        rw.rwkv6_bwd(r, k, v, log_w, u, None, do[..., :64].contiguous()
                     .bfloat16())


def test_scan_functions_train_on_the_kernels(gen):
    """``ops.moe_gmm``, ``ops.rglru_scan`` and ``ops.rwkv6`` on CUDA tensors
    that need grad: the forward and the backward launch the kernels, and
    the gradients match the same calls with ``force="plain"``."""
    x = randn(gen, 96, 64).requires_grad_(True)
    w = randn(gen, 4, 64, 48).requires_grad_(True)
    a = (torch.rand(2, 40, 64, generator=gen, device="cuda") * 0.7 + 0.3) \
        .requires_grad_(True)
    bb = torch.randn(2, 40, 64, generator=gen, device="cuda",
                     requires_grad=True)
    h0 = torch.zeros(2, 64, device="cuda")
    rwi = [t.requires_grad_(True) for t in
           rwkv_inputs(gen, 2, 40, 2, 64, dtype=torch.bfloat16)[:5]]

    def grads(force):
        y = ops.moe_gmm(x.expand(4, 96, 64), w, force=force)
        ys, _ = ops.rglru_scan(a, bb, h0, force=force)
        o, _ = ops.rwkv6(*rwi, force=force)
        loss = y.float().square().mean() + ys.square().mean() \
            + o.square().mean()
        return torch.autograd.grad(loss, [x, w, a, bb] + rwi)
    ops.reset_launches()
    got = grads(None)
    torch.cuda.synchronize()
    assert {k: n for k, n in ops.LAUNCHES.items() if n} == {
        "moe_gmm": 1, "moe_gmm_bwd": 2, "rglru_scan": 1,
        "rglru_scan_bwd": 1, "rwkv6": 1, "rwkv6_bwd": 1}
    for g, want in zip(got, grads("plain")):
        assert g.dtype == want.dtype
        err = (g.float() - want.float()).abs().max().item()
        assert err <= 4e-2 * want.float().abs().max().item()


def train_launches(cfg, steps: int = 1) -> dict:
    """The kernels' launches of ``steps`` train steps, remat none: per
    layer and step, a dense gated MLP's 3 products and 6 backward products
    (2 and 4 ungated), an MoE layer's 3 expert products and 6 backward
    products, and one forward and one backward of each global attention,
    RG-LRU scan and RWKV6 pass (local attention is plain torch)."""
    kinds = cfg.layer_kinds()
    mlps = [m for _, m in tfm.layer_plan(cfg)]
    per = (3 if cfg.mlp_gated else 2) * mlps.count("dense")
    out = {"matmul_tiled": per, "matmul_tiled_bwd": 2 * per,
           "moe_gmm": 3 * mlps.count("moe"),
           "moe_gmm_bwd": 6 * mlps.count("moe"),
           "flash_attention": kinds.count("attn"),
           "flash_attention_bwd": kinds.count("attn"),
           "rglru_scan": kinds.count("rglru"),
           "rglru_scan_bwd": kinds.count("rglru"),
           "rwkv6": kinds.count("rwkv"), "rwkv6_bwd": kinds.count("rwkv")}
    return {k: n * steps for k, n in out.items() if n}


@pytest.mark.parametrize("arch,kw", [
    ("granite-moe-1b-a400m", dict(n_layers=2, d_model=256, n_heads=4,
                                  d_ff=512, vocab=250, n_experts=8)),
    ("recurrentgemma-2b", dict(n_layers=3, d_model=256, vocab=250)),
    ("rwkv6-1.6b", dict(n_layers=2, d_model=256, vocab=250))])
def test_train_step_families_on_kernels_vs_plain(gen, arch, kw):
    """A reduced step of each family with a scan or expert kernel on the
    kernels against ``force="plain"``: launches exact per layer, the loss
    within 1e-3 relative and each leaf's gradient within 4e-2 of its
    largest (bf16 forwards rounding at other points)."""
    from repro_torch.train import step as tstep
    cfg = reduced_config(get_config(arch), **kw)
    params = tfm.init_params(cfg, gen)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 250, size=(4, 65))).cuda()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tc = tstep.TrainConfig(remat="none", moe_strategy="dense")
    ops.reset_launches()
    lk, _, gk = tstep.grads_fn(params, batch, cfg, tc)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == \
        train_launches(cfg)
    lp, _, gp = tstep.grads_fn(params, batch, cfg, tc, force="plain")
    assert abs(float(lk) - float(lp)) <= 1e-3 * abs(float(lp))
    scales = grad_scales(gp)
    for (path, a), (_, b) in zip(tstep.named_leaves(gk),
                                 tstep.named_leaves(gp)):
        assert bool(torch.isfinite(a).all()), path
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 4e-2 * max(scales[path], 1e-30), (path, err)


def test_train_step_on_kernels_vs_plain(gen):
    """A small qwen's gradients on the kernels against the same on
    ``force="plain"``, with the launches of one step exact: per layer 3
    forward products, 6 backward products, one attention and its
    backward. The loss within 4e-2 relative and each leaf's gradient
    within 4e-2 of its largest |value| (bf16 forwards that round at other
    points: the P of attention and each product's sum order); a key bias's
    gradient is 0 but for rounding (softmax ignores a bias on every key),
    so it is held relative to its layer's query-bias gradient
    (``grad_scales``)."""
    from repro_torch.train import step as tstep
    cfg = reduced_config(get_config("qwen1.5-0.5b"), n_layers=2,
                         d_model=256, n_heads=4, d_ff=512, vocab=250)
    params = tfm.init_params(cfg, gen)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 250, size=(4, 65))).cuda()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    tc = tstep.TrainConfig(remat="none")
    ops.reset_launches()
    lk, _, gk = tstep.grads_fn(params, batch, cfg, tc)
    torch.cuda.synchronize()
    n = cfg.n_layers
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        "matmul_tiled": 3 * n, "matmul_tiled_bwd": 6 * n,
        "flash_attention": n, "flash_attention_bwd": n}
    lp, _, gp = tstep.grads_fn(params, batch, cfg, tc, force="plain")
    assert abs(float(lk) - float(lp)) <= 4e-2 * abs(float(lp))
    scales = grad_scales(gp)
    for (path, a), (_, b) in zip(tstep.named_leaves(gk),
                                 tstep.named_leaves(gp)):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 4e-2 * scales[path], (path, err)


def grad_scales(grads) -> dict:
    """Each leaf's largest |grad|, the scale its error is held to; a key
    bias ``bk`` (whose gradient is 0 but for rounding: softmax is
    invariant to a bias added to every key) takes the larger of its own and
    its layer's query bias ``bq``'s."""
    from repro_torch.train import step as tstep
    flat = dict(tstep.named_leaves(grads))
    out = {p: g.float().abs().max().item() for p, g in flat.items()}
    for p in flat:
        if p[-1] == "bk" and p[:-1] + ("bq",) in flat:
            out[p] = max(out[p], out[p[:-1] + ("bq",)])
    return out


def test_train_remat_modes_on_kernels(gen):
    """The four remat modes on the card: each recomputes the kernels'
    forwards in the backward (their outputs are not dispatcher ops, so
    "dots" recomputes them too), and every kernel is deterministic, so the
    loss and every gradient are bit-equal to remat "none"; "full" launches
    each forward kernel twice."""
    from repro_torch.train import step as tstep
    cfg = reduced_config(get_config("qwen1.5-0.5b"), n_layers=4,
                         d_model=256, n_heads=4, d_ff=512, vocab=250)
    params = tfm.init_params(cfg, gen)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, 250, size=(2, 65))).cuda()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for remat in tfm.REMAT:
        ops.reset_launches()
        out[remat] = tstep.grads_fn(params, batch, cfg,
                                    tstep.TrainConfig(remat=remat))
        if remat == "full":
            assert ops.LAUNCHES["matmul_tiled"] == 2 * 3 * cfg.n_layers
            assert ops.LAUNCHES["flash_attention"] == 2 * cfg.n_layers
        assert ops.LAUNCHES["flash_attention_bwd"] == cfg.n_layers
    l0, _, g0 = out["none"]
    for remat, (l, _, g) in out.items():
        assert torch.equal(l, l0), remat
        for (path, a), (_, b) in zip(tstep.named_leaves(g0),
                                     tstep.named_leaves(g)):
            assert torch.equal(a, b), (remat, path)


def adamw_case(gen, sizes, clip: bool):
    """fp32 leaves of ``sizes`` elements from a non-zero state (count 4,
    moments of an earlier step) and gradients whose global norm is about
    40 (the clip at 1.0 is active) or 0.04 (it is not)."""
    p = [torch.randn(n, generator=gen, device="cuda") for n in sizes]
    m = [1e-2 * torch.randn(n, generator=gen, device="cuda") for n in sizes]
    v = [1e-4 * torch.randn(n, generator=gen, device="cuda").abs()
         for n in sizes]
    g = [torch.randn(n, generator=gen, device="cuda") for n in sizes]
    norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
    g = [x * ((40.0 if clip else 0.04) / norm) for x in g]
    return p, g, m, v


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("sizes", [(1,), (4095,), (4097,), (2 ** 20 + 3,),
                                   (1, 4095, 0, 4097, 2 ** 20 + 3)])
def test_adamw_kernel_vs_plain(gen, sizes, clip):
    """The fused AdamW pass against ``adamw_ref`` on ragged leaves over 3
    calls: params, moments and the norm within fp32's 2e-4 of each leaf's
    largest value (the kernel sums the norm in block order and rounds
    pow, sqrt and division at other last bits), the count equal, one
    launch a call; a second run from the same state bit-equal (no
    atomics)."""
    from repro_torch.kernels import adamw as ka
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0)
    p, g, m, v = adamw_case(gen, sizes, clip)
    runs = [[[t.clone() for t in ts] for ts in (p, m, v)]
            + [torch.full((), 4, dtype=torch.int32, device="cuda")]
            for _ in range(3)]
    for i in range(3):
        lr = torch.full((), 3e-3 * (i + 1), device="cuda")
        before = ops.LAUNCHES["adamw"]
        norms = [ka.adamw(r[0], g, r[1], r[2], r[3], lr, **kw)
                 for r in runs[:2]]
        assert ops.LAUNCHES["adamw"] == before + 2
        want = ka.adamw_ref(runs[2][0], g, runs[2][1], runs[2][2],
                            runs[2][3], lr, **kw)
        torch.cuda.synchronize()
        assert torch.equal(norms[0], norms[1])
        assert abs(norms[0].item() - want.item()) <= 2e-4 * want.item()
        assert (want.item() > 1.0) == clip
    assert all(int(r[3]) == 7 for r in runs)
    for k in range(3):
        for a, b, ref in zip(runs[0][k], runs[1][k], runs[2][k]):
            assert torch.equal(a, b)
            if ref.numel():
                err = (a - ref).abs().max().item()
                assert err <= 2e-4 * ref.abs().max().item(), (k, err)


def test_adamw_kernel_graph_nodes_and_replay(gen, tmp_path):
    """One call of the fused pass captured in a CUDA graph: each non-empty
    leaf's partials and update one kernel node each, the scalars one; two
    replays equal two eager calls from the same state bit for bit (the
    graph keeps each leaf's address and length)."""
    from repro_torch.kernels import adamw as ka
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0)
    sizes = (1, 4095, 0, 4097, 2 ** 20 + 3)
    p, g, m, v = adamw_case(gen, sizes, True)
    runs = [[[t.clone() for t in ts] for ts in (p, m, v)]
            + [torch.full((), 4, dtype=torch.int32, device="cuda")]
            for _ in range(2)]
    lr = torch.full((), 3e-3, device="cuda")
    out = {}

    def call():
        out["norm"] = ka.adamw(runs[0][0], g, runs[0][1], runs[0][2],
                               runs[0][3], lr, **kw)
    nodes = one_call_kernels(call, tmp_path / "adamw.dot")
    names = ("_adamw_partials", "_adamw_scalars", "_adamw_update")
    assert {k: sum(k in n for n in nodes) for k in names} == {
        "_adamw_partials": 4, "_adamw_scalars": 1, "_adamw_update": 4}
    assert len(nodes) == 9
    # one_call_kernels' warm-up ran one call; then two replays of a graph
    # of one call against three eager calls on the twin
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        call()
    for _ in range(2):
        graph.replay()
    for _ in range(3):
        want = ka.adamw(runs[1][0], g, runs[1][1], runs[1][2], runs[1][3],
                        lr, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out["norm"], want)
    assert int(runs[0][3]) == int(runs[1][3]) == 7
    for k in range(3):
        for a, b in zip(runs[0][k], runs[1][k]):
            assert torch.equal(a, b), k


def graph_case(gen, n_layers: int = 2):
    """A small qwen on the card (head dim 64) with two copies of its
    weights and optimizer state, and pinned batches of 4 x 64."""
    from repro_torch.train import optim as toptim
    from repro_torch.train import step as tstep
    cfg = reduced_config(get_config("qwen1.5-0.5b"), n_layers=n_layers,
                         d_model=256, n_heads=4, d_ff=512, vocab=250)
    params = tfm.init_params(cfg, gen)
    copies = []
    for _ in range(2):
        p = tstep.from_named_leaves([(k, t.detach().clone())
                                     for k, t in tstep.named_leaves(params)])
        copies.append((p, toptim.adamw_init(p)))
    rng = np.random.default_rng(0)

    def batch(step):
        toks = torch.from_numpy(rng.integers(0, 250, size=(4, 65)))
        return {"tokens": toks[:, :-1].contiguous().pin_memory(),
                "labels": toks[:, 1:].contiguous().pin_memory()}
    return cfg, copies, [batch(s) for s in range(6)]


def test_graphed_step_equals_eager_bit_for_bit(gen):
    """``GraphedTrainStep`` on the card (step 0 eager, step 1 captured and
    replayed, the rest replayed) against ``build_train_step`` on a copy of
    the same weights: every metric, param and moment bit-equal over 4
    steps, one capture, and the learning rate read from the step index on
    each replay (it differs between replays)."""
    from repro_torch.train import optim as toptim
    from repro_torch.train import step as tstep
    from repro_torch.train.graph import GraphedTrainStep
    cfg, ((pa, sa), (pb, sb)), batches = graph_case(gen)
    tc = tstep.TrainConfig(remat="none")
    lr = toptim.cosine_schedule(3e-3, 1, 10)
    eager = tstep.build_train_step(cfg, tc, lr)
    graphed = GraphedTrainStep(cfg, tc, lr)
    lrs = []
    for s in range(4):
        _, _, ma = eager(pa, sa, {k: v.cuda() for k, v in
                                  batches[s].items()}, s)
        _, _, mb = graphed(pb, sb, batches[s], s)
        for k in ma:
            assert torch.equal(ma[k], mb[k]), (s, k)
        lrs.append(mb["lr"].item())
    assert graphed.captures == 1 and len(graphed.graphs()) == 1
    assert lrs[1] != lrs[2] != lrs[3]
    for ta, tb in ((pa, pb), (sa.mu, sb.mu), (sa.nu, sb.nu)):
        for (path, a), (_, b) in zip(tstep.named_leaves(ta),
                                     tstep.named_leaves(tb)):
            assert torch.equal(a, b), path
    assert int(sa.count) == int(sb.count) == 4
    graphed.reset()


def test_graphed_step_launches_exact_per_replay(gen):
    """The capture's own wrapper calls are taken back out of the counts,
    the eager step counts its launches and each replay adds one step's:
    after N steps the counts are N eager steps' (the fused AdamW pass one
    a step)."""
    from repro_torch.train import optim as toptim
    from repro_torch.train import step as tstep
    from repro_torch.train.graph import GraphedTrainStep
    cfg, ((p, s), _), batches = graph_case(gen)
    graphed = GraphedTrainStep(cfg, tstep.TrainConfig(remat="none"),
                               toptim.cosine_schedule(3e-3, 1, 10))
    one = train_launches(cfg) | {"adamw": 1}
    ops.reset_launches()
    for n in range(1, 5):
        graphed(p, s, batches[n], n)
        torch.cuda.synchronize()
        assert {k: v for k, v in ops.LAUNCHES.items() if v} == \
            {k: v * n for k, v in one.items()}
    graphed.reset()


def test_capture_after_restore_sees_restored_weights(gen, tmp_path):
    """A checkpoint restored into new tensors gets a graph of its own (the
    old one updates the old tensors): its steps, eager then captured, equal
    the eager step's from the same restore bit for bit."""
    from repro_torch.train import checkpoint
    from repro_torch.train import optim as toptim
    from repro_torch.train import step as tstep
    from repro_torch.train.graph import GraphedTrainStep
    cfg, ((p, s), _), batches = graph_case(gen)
    tc = tstep.TrainConfig(remat="none")
    lr = toptim.cosine_schedule(3e-3, 1, 10)
    graphed = GraphedTrainStep(cfg, tc, lr)
    for n in range(3):
        graphed(p, s, batches[n], n)
    checkpoint.save(str(tmp_path), 3, (p, s))
    pr, sr = checkpoint.restore(str(tmp_path), 3, (p, s))
    pe, se = checkpoint.restore(str(tmp_path), 3, (p, s))
    eager = tstep.build_train_step(cfg, tc, lr)
    for n in range(3, 6):
        _, _, ma = eager(pe, se, {k: v.cuda() for k, v in
                                  batches[n].items()}, n)
        _, _, mb = graphed(pr, sr, batches[n], n)
        assert torch.equal(ma["loss"], mb["loss"]), n
        assert torch.equal(ma["grad_norm"], mb["grad_norm"]), n
    assert graphed.captures == 2
    for (path, a), (_, b) in zip(tstep.named_leaves(pe),
                                 tstep.named_leaves(pr)):
        assert torch.equal(a, b), path
    graphed.reset()


def test_launch_train_graphs_after_its_first_step(gen):
    """``launch.train`` on the card: step 0 eager, one capture at step 1,
    every later step a replay; the counts are the steps' launches with one
    fused AdamW pass each."""
    from repro_torch.launch.train import main
    stats = []
    losses = None
    ops.reset_launches()
    losses = main(["--arch", "qwen1.5-0.5b", "--reduced", "--d-model", "256",
                   "--steps", "5", "--seq", "64", "--batch", "4",
                   "--log-every", "100"], stats=stats)
    assert len(losses) == 5 and all(np.isfinite(losses))
    assert [st["replayed"] for st in stats] == [False] + [True] * 4
    assert [("capture_s" in st) for st in stats] == \
        [False, True, False, False, False]
    cfg = reduced_config(get_config("qwen1.5-0.5b"), n_layers=2,
                         d_model=256)
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        k: 5 * v for k, v in (train_launches(cfg) | {"adamw": 1}).items()}


def test_launch_train_raises_when_a_capture_fails(gen, monkeypatch):
    """A failed capture raises out of ``launch.train``: no step after the
    first runs eagerly in its place."""
    import contextlib
    from repro_torch.launch.train import main

    @contextlib.contextmanager
    def refused(*a, **kw):
        raise RuntimeError("capture refused")
        yield
    monkeypatch.setattr(torch.cuda, "graph", refused)
    stats = []
    with pytest.raises(RuntimeError, match="capture refused"):
        main(["--arch", "qwen1.5-0.5b", "--reduced", "--d-model", "256",
              "--steps", "3", "--seq", "64", "--batch", "4"], stats=stats)
    assert len(stats) == 1 and not stats[0]["replayed"]
