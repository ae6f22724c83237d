"""The port's tile autotuner (``repro_torch.kernels.autotune``) against
``repro``'s on TPU specs, its GPU form's invariants on ``H100_SXM``, the
tile entries of the table cache, ``kernel_tail_free`` and the kernel
context of ``ops``, on the CPU.

On a TPU spec every ``TileConfig`` field must equal ``repro``'s (exact:
the same integer and float arithmetic). The GPU form scores the port's
own CUDA tiles by paper Eq. 3 over the card's 132 SMs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import hardware as jhw
from repro.core.candidates import kernel_tail_free as j_kernel_tail_free
from repro.core.table_cache import ProfileTableCache as JCache
from repro.kernels import autotune as jat
from repro_torch.configs import get_config
from repro_torch.core import H100_SXM, TPU_LITE, TPU_V4, TPU_V5E, \
    ProfileTableCache
from repro_torch.core.candidates import kernel_tail_free
from repro_torch.core.tail_model import EFFECTIVE_CTAS_PER_SM, \
    CtaWaveModel, LayerShape
from repro_torch.kernels import autotune as at
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul_tiled as mt
from repro_torch.kernels import moe_gmm as mg
from repro_torch.kernels import ops
from test_torch_recurrent import one_torch_thread  # noqa: F401

# tests/test_autotune.py's shapes: matmul (M, N, K), flash (b, sq, skv, h,
# kv, dh), moe (e, c, d, f)
BENCH_MATMUL = [(1024, 1024, 1024), (8192, 4096, 4096),
                (256, 8192, 2048), (4096, 11008, 4096)]
BENCH_FLASH = [(2, 1024, 1024, 8, 2, 128), (1, 4096, 4096, 16, 16, 64),
               (4, 512, 512, 8, 8, 128)]
BENCH_MOE = [(8, 256, 512, 1024), (16, 512, 1024, 2048)]
# the port's copies and repro's specs, by name
TPU_SPECS = [(TPU_LITE, jhw.TPU_LITE), (TPU_V4, jhw.TPU_V4),
             (TPU_V5E, jhw.TPU_V5E)]
# the main paths' prefill and decode GEMMs (M, N, K) and granite's experts
GPU_MATMUL = [(512, 2816, 1024), (512, 1024, 2816), (512, 7680, 2560),
              (512, 2560, 7680), (512, 2112, 1024), (4, 2816, 1024),
              (100, 130, 70), (128, 2816, 1024)]
GPU_MOE = [(32, 512, 1024, 512), (32, 512, 512, 1024), (32, 4, 1024, 512),
           (32, 161, 1024, 512)]


@pytest.fixture(autouse=True)
def _fresh_memo():
    at.clear_memo()
    jat.clear_memo()
    yield
    at.clear_memo()
    jat.clear_memo()


def fields(cfg) -> tuple:
    return dataclasses.astuple(cfg)


# ---------------------------------------------------------------------------
# the TPU form equals repro's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", ["matmul", "flash_attention", "moe_gmm"])
@pytest.mark.parametrize("spec", TPU_SPECS, ids=lambda s: s[0].name)
def test_tpu_form_equals_repro(spec, kernel):
    """Every field of every pick, on the bench shapes and on the port's
    main-path shapes, equals ``repro``'s on the same spec."""
    hw, jhw_spec = spec
    shapes = {"matmul": BENCH_MATMUL + [(512, 2816, 1024), (100, 130, 70)],
              "flash_attention": BENCH_FLASH + [(4, 128, 128, 16, 16, 64)],
              "moe_gmm": BENCH_MOE + [(32, 512, 1024, 512)]}[kernel]
    port = {"matmul": at.autotune_matmul,
            "flash_attention": at.autotune_flash_attention,
            "moe_gmm": at.autotune_moe_gmm}[kernel]
    ref = {"matmul": jat.autotune_matmul,
           "flash_attention": jat.autotune_flash_attention,
           "moe_gmm": jat.autotune_moe_gmm}[kernel]
    for shape in shapes:
        assert fields(port(hw, *shape)) == fields(ref(jhw_spec, *shape)), \
            shape


def test_tpu_form_small_vmem_equals_repro():
    """A spec whose VMEM admits no candidate takes the forced defaults in
    both (``_force_config``)."""
    hw = dataclasses.replace(TPU_V5E, vmem_bytes=1 << 12)
    jh = dataclasses.replace(jhw.TPU_V5E, vmem_bytes=1 << 12)
    for shape in BENCH_MATMUL:
        assert fields(at.autotune_matmul(hw, *shape)) == fields(
            jat.autotune_matmul(jh, *shape))


@pytest.mark.parametrize("tokens,d_in", [(512, 1024), (4, 2816),
                                         (8192, 4096)])
def test_kernel_tail_free_equals_repro(tokens, d_in):
    """``kernel_tail_free`` on a sweep of widths (lane multiples and
    ragged ones) equals ``repro``'s on TPU_V5E."""
    widths = list(range(128, 4097, 128)) + [100, 2816, 2752, 4095]
    got = [kernel_tail_free(TPU_V5E, tokens, d_in, w) for w in widths]
    want = [j_kernel_tail_free(jhw.TPU_V5E, tokens, d_in, w)
            for w in widths]
    assert got == want
    assert any(got) or tokens == 4


# ---------------------------------------------------------------------------
# the table cache's tile entries
# ---------------------------------------------------------------------------
def test_tiles_key_equals_repro(tmp_path):
    """A TPU spec's tile key equals ``repro``'s, so one cache directory
    serves both; a GPU spec's differs from every TPU key."""
    port, ref = ProfileTableCache(tmp_path), JCache(tmp_path)
    for hw, jh in TPU_SPECS:
        for kernel, shape in (("matmul", (512, 2816, 1024, 16)),
                              ("moe_gmm", (8, 256, 512, 1024, 16))):
            assert port.tiles_key(hw, kernel, shape) == \
                ref.tiles_key(jh, kernel, shape)
    assert port.tiles_key(H100_SXM, "matmul", (512, 2816, 1024, 16)) not in {
        port.tiles_key(hw, "matmul", (512, 2816, 1024, 16))
        for hw, _ in TPU_SPECS}
    # an entry the port writes reads back in repro, and the other way
    port.put_tiles(TPU_V5E, "matmul", (1, 2, 3, 16), (8, 128, 128))
    assert ref.get_tiles(jhw.TPU_V5E, "matmul", (1, 2, 3, 16)) == \
        (8, 128, 128)
    ref.put_tiles(jhw.TPU_V4, "matmul", (1, 2, 3, 16), (16, 256, 128))
    assert port.get_tiles(TPU_V4, "matmul", (1, 2, 3, 16)) == \
        (16, 256, 128)


@pytest.mark.parametrize("hw", [TPU_V5E, H100_SXM], ids=lambda h: h.name)
def test_tiles_round_trip_through_the_cache(tmp_path, hw):
    """A pick is written once; a fresh memo reads it back (a hit, no
    rewrite) and re-scores it to the same config."""
    cache = ProfileTableCache(tmp_path)
    a = at.autotune_matmul(hw, 512, 2816, 1024, cache=cache)
    assert cache.stats.writes == 1
    at.clear_memo()
    b = at.autotune_matmul(hw, 512, 2816, 1024, cache=cache)
    assert b == a
    assert cache.stats.hits == 1 and cache.stats.writes == 1
    assert cache.get_tiles(hw, "matmul", (512, 2816, 1024, 16)) == a.blocks
    # a persisted tile the GPU form does not have is re-enumerated
    if hw is H100_SXM:
        cache.put_tiles(hw, "matmul", (512, 2112, 1024, 16), (32, 64))
        at.clear_memo()
        c = at.autotune_matmul(hw, 512, 2112, 1024, cache=cache)
        assert c.blocks in mt.PREFILL_TILES


def test_corrupt_tiles_entry_quarantined(tmp_path):
    """An unreadable tile entry is quarantined and the pick re-enumerated,
    as in ``repro``."""
    cache = ProfileTableCache(tmp_path)
    want = at.autotune_matmul(H100_SXM, 512, 2816, 1024, cache=cache)
    at.clear_memo()
    (entry,) = list(tmp_path.glob("??/*.npz"))
    entry.write_bytes(b"garbage")
    got = at.autotune_matmul(H100_SXM, 512, 2816, 1024, cache=cache)
    assert got == want
    assert cache.stats.corrupted == 1
    assert cache.quarantined()


# ---------------------------------------------------------------------------
# the GPU form on H100_SXM
# ---------------------------------------------------------------------------
def test_gpu_form_is_deterministic():
    picks = [at.autotune_matmul(H100_SXM, *s) for s in GPU_MATMUL] + \
        [at.autotune_moe_gmm(H100_SXM, *s) for s in GPU_MOE]
    at.clear_memo()
    again = [at.autotune_matmul(H100_SXM, *s) for s in GPU_MATMUL] + \
        [at.autotune_moe_gmm(H100_SXM, *s) for s in GPU_MOE]
    assert picks == again
    stats = at.memo_stats()
    assert stats["per_kernel"] == {"matmul": len(GPU_MATMUL),
                                   "moe_gmm": len(GPU_MOE)}


@pytest.mark.parametrize("m,n,k", GPU_MATMUL)
def test_gpu_candidates_fit_an_sm_and_own_it(m, n, k):
    """Every candidate is a tile the kernel has, its form's shared memory
    fits an SM, and a prefill candidate runs one CTA an SM; at M <= 64 the
    decode form's tile is the only one."""
    cands = at._gpu_matmul_candidates(H100_SXM, (m, n, k), 16)
    tiles = [c.blocks for c in cands]
    if m <= mt.DECODE_BLOCK_M:
        assert tiles == [mt.DECODE_TILE]
    else:
        assert tiles == list(mt.PREFILL_TILES)
        assert EFFECTIVE_CTAS_PER_SM["prefill"] == 1
        for t in tiles:
            assert mt.FORMS["prefill", t]["ctas_per_sm"] == 1
    for c in cands:
        assert c.vmem_bytes <= H100_SXM.smem_per_sm
        assert c.grid_blocks == mt.grid_blocks(m, n, k, c.blocks)
        assert c.grid_blocks == int(np.prod(c.grid))
    pick = at.autotune_matmul(H100_SXM, m, n, k)
    assert pick in cands
    assert pick == at._select(cands)


def test_gpu_form_admits_what_fits():
    """A card with less shared memory per SM than the 256-row tile asks
    for never picks it."""
    small = dataclasses.replace(H100_SXM, vmem_bytes=120 * 1024)
    cands = at._gpu_matmul_candidates(small, (512, 7680, 2560), 16)
    assert [c.blocks for c in cands] == [(64, 64), (128, 64)]


def test_gpu_eq3_accounting_by_hand():
    """(512, 2816, 1024) on each prefill tile, by hand: B = row tiles x
    column tiles, W = ceil(B / 132), dL = one CTA's FLOPs over one SM's
    share of the peak (over the tile's efficiency), bytes each padded
    operand once and the output once."""
    m, n, k = 512, 2816, 1024
    s, peak, bw = 132, 989e12, 3.35e12
    for (bm, bn), b in (((64, 64), 8 * 44), ((128, 64), 4 * 44),
                        ((256, 64), 2 * 44)):
        cfg = at._gpu_matmul_config(H100_SXM, m, n, k, bm, bn, 16)
        assert cfg.grid == (m // bm, n // bn, 1) and cfg.grid_blocks == b
        assert cfg.waves == -(-b // s)
        dl = 2.0 * bm * bn * k / (peak / s) \
            / at.TILE_EFFICIENCY["prefill", (bm, bn)]
        nbytes = 2 * (m * k + k * n + m * n)
        assert cfg.latency_s == pytest.approx(
            max(cfg.waves * dl, nbytes / bw), rel=1e-12)
        assert cfg.padded_flops == 2.0 * bm * bn * k * b
        assert not cfg.tail_free            # 2816 / 64 = 44 tiles
        assert cfg.vmem_bytes == mt.FORMS["prefill", (bm, bn)]["smem_bytes"]
    # the decode form: 44 column tiles x 4 K chunks, 3 CTAs an SM
    cfg = at.autotune_matmul(H100_SXM, 4, 2816, 1024)
    assert cfg.blocks == mt.DECODE_TILE and cfg.grid == (1, 44, 4)
    assert cfg.waves == -(-176 // (s * EFFECTIVE_CTAS_PER_SM["decode"]))


def test_gpu_picks_a_tail_free_tile_where_one_exists():
    """(512, 2112, 1024): the default tile's grid is 4 x 33 = 132 CTAs,
    one full wave, and nothing pads: tail-free, so picked."""
    cfg = at.autotune_matmul(H100_SXM, 512, 2112, 1024)
    assert cfg.blocks == (128, 64) and cfg.grid_blocks == 132
    assert cfg.waves == 1 and cfg.tail_free
    # (64, 64) is tail-free there too (264 CTAs, two full waves); the
    # default tile is as fast by Eq. 3 or faster, with fewer CTAs
    alt = at._gpu_matmul_config(H100_SXM, 512, 2112, 1024, 64, 64, 16)
    assert alt.tail_free and alt.grid_blocks == 264
    assert (cfg.latency_s, cfg.grid_blocks) < (alt.latency_s,
                                               alt.grid_blocks)


def test_gpu_flash_scores_its_one_tile():
    b, sq, skv, h, kv, dh = 4, 128, 128, 16, 16, 64
    cfg = at.autotune_flash_attention(H100_SXM, b, sq, skv, h, kv, dh)
    assert cfg.blocks == (fa.BLOCK_Q, fa.BLOCK_KV)
    assert cfg.grid_blocks == fa.grid_blocks(b, sq, h) == 4 * 16 * 2
    slots = H100_SXM.cores_per_chip * fa.FORMS[dh]["ctas_per_sm"]
    assert cfg.waves == -(-cfg.grid_blocks // slots)
    assert cfg.tail_free == (cfg.grid_blocks % slots == 0)
    assert cfg.vmem_bytes == fa.FORMS[dh]["smem_bytes"]
    # 132 x 3 CTAs exactly: tail-free
    full = at.autotune_flash_attention(H100_SXM, 1, 64 * 33, 64 * 33, 12,
                                       12, 64)
    assert full.grid_blocks == 396 and full.tail_free and full.waves == 1


def test_gpu_moe_grid_is_the_kernels():
    for e, c, d, f in GPU_MOE:
        cfg = at.autotune_moe_gmm(H100_SXM, e, c, d, f)
        assert cfg.grid_blocks == mg.grid_blocks(e, c, f, d, cfg.blocks)
        assert cfg.grid[0] == e
        assert (c <= mt.DECODE_BLOCK_M) == (cfg.blocks == mt.DECODE_TILE)


# ---------------------------------------------------------------------------
# the kernel context
# ---------------------------------------------------------------------------
def test_kernel_context_on_the_cpu_is_bit_equal_and_records_tiles():
    """On the CPU the plain versions ignore the tile: every output under
    ``kernel_context(hw=H100_SXM)`` equals the one outside it, and
    ``ops.TILES`` records the tile a launch would take."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(512, 1024, generator=g).bfloat16()
    w = torch.randn(1024, 2816, generator=g).bfloat16()
    xe = torch.randn(512, 1024, generator=g).bfloat16().expand(4, 512, 1024)
    we = torch.randn(4, 1024, 512, generator=g).bfloat16()
    q = torch.randn(2, 128, 4, 64, generator=g).bfloat16()
    base = (ops.matmul(x, w), ops.moe_gmm(xe, we),
            ops.flash_attention(q, q, q))
    assert ops.TILES["matmul"] == mt.DEFAULT_TILE
    with ops.kernel_context(hw=H100_SXM) as ctx:
        assert ops.get_kernel_context() is ctx
        got = (ops.matmul(x, w), ops.moe_gmm(xe, we),
               ops.flash_attention(q, q, q))
        assert ops.TILES["matmul"] == \
            at.autotune_matmul(H100_SXM, 512, 2816, 1024).blocks
        assert ops.TILES["moe_gmm"] == \
            at.autotune_moe_gmm(H100_SXM, 4, 512, 1024, 512).blocks
        assert ops.TILES["flash_attention"] == (64, 64)
        # an explicit tile wins over the context
        ops.matmul(x, w, tile=(256, 64))
        assert ops.TILES["matmul"] == (256, 64)
        # the decode form has its one tile whatever the context
        ops.matmul(x[:4], w)
        assert ops.TILES["matmul"] == mt.DECODE_TILE
    assert ops.get_kernel_context() is None
    for a, b in zip(base, got):
        assert torch.equal(a, b)
    # a TPU spec's tiles are Pallas blocks: the CUDA kernels keep theirs
    with ops.kernel_context(hw=TPU_V5E):
        ops.matmul(x, w)
    assert ops.TILES["matmul"] == mt.DEFAULT_TILE
    # hw= on the call, without a context
    ops.matmul(x, w, hw=H100_SXM)
    assert ops.TILES["matmul"] == \
        at.autotune_matmul(H100_SXM, 512, 2816, 1024).blocks


def test_kernel_context_nests_and_persists_through_its_cache(tmp_path):
    cache = ProfileTableCache(tmp_path)
    x, w = torch.zeros(512, 1024).bfloat16(), torch.zeros(1024, 2112) \
        .bfloat16()
    with ops.kernel_context(hw=H100_SXM, cache=cache):
        with ops.kernel_context():
            ops.matmul(x, w)
            assert ops.TILES["matmul"] == mt.DEFAULT_TILE
            assert cache.stats.writes == 0
        ops.matmul(x, w)
    assert cache.stats.writes == 1
    assert cache.get_tiles(H100_SXM, "matmul", (512, 2112, 1024, 16)) == \
        (128, 64)


def test_tiles_the_kernels_lack_raise():
    x, w = torch.zeros(512, 64).bfloat16(), torch.zeros(64, 64).bfloat16()
    with pytest.raises(ValueError, match="no prefill tile"):
        ops.matmul(x, w, tile=(32, 64))
    with pytest.raises(ValueError, match="decode form"):
        ops.matmul(x[:4], w, tile=(128, 64))
    with pytest.raises(ValueError, match="one tile"):
        q = torch.zeros(1, 8, 2, 64).bfloat16()
        ops.flash_attention(q, q, q, tile=(128, 64))
    with pytest.raises(ValueError, match="no prefill tile"):
        mt.grid_blocks(512, 64, 64, (512, 64))


# ---------------------------------------------------------------------------
# the planner's widths are served on the grid it modeled
# ---------------------------------------------------------------------------
def qwen_plans(classes):
    from repro_torch.serving import ServingWidthPlanner, TrafficClass, \
        serving_templates
    cfg = get_config("qwen1.5-0.5b")
    tpl, mods = serving_templates(cfg, H100_SXM, tokens=512)
    planner = ServingWidthPlanner(H100_SXM, tpl, modules=mods, device="cpu",
                                  tile_hw=H100_SXM)
    plans = planner.plan([TrafficClass(n, t) for n, t in classes])
    return planner, plans


def test_planned_widths_are_served_on_the_modeled_grid():
    """For every width of both of qwen's planned classes (128 and 512
    tokens), cut or not, the tile the autotuner serves is the tile the
    planner's model priced, so the grid it launches is the grid
    ``CtaWaveModel`` counted: the same CTAs, waves and latency. Where the
    plan cut a layer it put it on a wave edge of that grid."""
    planner, plans = qwen_plans([("short", 128), ("long", 512)])
    model = planner.model
    assert isinstance(model, CtaWaveModel) and model.tile_hw is H100_SXM
    seen = set()
    for name, plan in plans.items():
        tokens = plan.traffic.tokens
        for lname, w in plan.widths.items():
            layer = dataclasses.replace(planner._layer_by_name[lname],
                                        tokens=tokens, width=w)
            cfg = at.autotune_matmul(H100_SXM, tokens, w, layer.d_in)
            assert cfg.blocks == model.tile(layer), (name, lname, w)
            assert cfg.grid_blocks == model.blocks(layer), (name, w, cfg)
            assert cfg.waves == model.waves(layer)
            assert model.evaluate(layer).latency_s == \
                pytest.approx(cfg.latency_s, rel=1e-12)
            if w < planner._layer_by_name[lname].width:
                assert cfg.tail_free and kernel_tail_free(
                    H100_SXM, tokens, layer.d_in, w)
            seen.add((tokens, w, cfg.blocks))
    # both classes planned, the long one cut layers, and its full-width
    # layers run another tile than its cut ones
    assert {t for t, _, _ in seen} == {128, 512}
    assert any(w < 2816 for t, w, _ in seen if t == 512)
    assert len({b for t, _, b in seen if t == 512}) > 1


@pytest.mark.parametrize("kernel,e,m,k", [
    ("matmul", 1, 512, 1024), ("matmul", 1, 512, 2816),
    ("matmul", 1, 128, 1024), ("matmul", 1, 256, 2560),
    ("matmul", 1, 4, 1024), ("matmul", 1, 100, 70),
    ("moe_gmm", 32, 512, 1024), ("moe_gmm", 32, 161, 1024),
    ("moe_gmm", 32, 4, 512)])
def test_sweep_picks_equal_the_autotuner(kernel, e, m, k):
    """``gemm_tile_picks`` over a sweep of widths picks, at each width,
    the tile ``autotune_matmul`` / ``autotune_moe_gmm`` picks alone (the
    same scorer, ``_select``'s rule vectorized)."""
    n = np.unique(np.concatenate([np.arange(1, 600, 7),
                                  np.arange(2048, 9000, 61), [2112, 2816]]))
    tiles, pick = at.gemm_tile_picks(kernel, H100_SXM, e, m, k, n)
    for i, ni in enumerate(n):
        cfg = at.autotune_matmul(H100_SXM, m, int(ni), k) \
            if kernel == "matmul" else \
            at.autotune_moe_gmm(H100_SXM, e, m, k, int(ni))
        assert tiles[pick[i]] == cfg.blocks, (int(ni), cfg)


def test_model_without_tile_hw_keeps_the_default_tile():
    """Without ``tile_hw`` the model prices the default tile at the peak,
    as before the autotuner; with it, it prices the pick at the pick's
    measured rate, equal to the autotuner's latency, and its tables are
    cached under another name. Where the pick is the default tile, the
    two differ only by that tile's rate."""
    plain = CtaWaveModel(H100_SXM)
    tiled = CtaWaveModel(H100_SXM, tile_hw=H100_SXM)
    assert plain.table_variant != tiled.table_variant
    layer = LayerShape("up", tokens=512, d_in=1024, width=2816)
    widths = np.arange(64, 9000, 64)
    a, b = plain.evaluate_batch(layer, widths), \
        tiled.evaluate_batch(layer, widths)
    for i, w in enumerate(widths):
        cfg = at.autotune_matmul(H100_SXM, 512, int(w), 1024)
        assert b.waves[i] == cfg.waves
        assert b.latency_s[i] == pytest.approx(cfg.latency_s, rel=1e-12)
        assert a.waves[i] == -(-mt.grid_blocks(512, int(w), 1024)
                               // H100_SXM.cores_per_chip)
        if cfg.blocks == mt.DEFAULT_TILE:
            # the same grid; compute at the tile's share of the peak
            assert b.waves[i] == a.waves[i]
            compute = a.waves[i] * plain._stack_columns([layer]).dl[0, 0]
            rate = at.TILE_EFFICIENCY["prefill", mt.DEFAULT_TILE]
            assert b.latency_s[i] == pytest.approx(
                max(compute / rate, a.latency_s[i]), rel=1e-12)
    assert {at.autotune_matmul(H100_SXM, 512, int(w), 1024).blocks
            for w in widths} == set(mt.PREFILL_TILES)


def test_tiled_model_on_the_kernel_backend_equals_numpy():
    """With ``tile_hw``, the kernel backend (its plain version on the CPU)
    sweeps every tile slot in one stacked pass and keeps the same picks
    as the numpy engine."""
    layers = [LayerShape("up", tokens=512, d_in=1024, width=2816),
              LayerShape("down", tokens=512, d_in=2816, width=1024),
              LayerShape("dec", tokens=4, d_in=1024, width=2816),
              LayerShape("moe", tokens=512, d_in=1024, width=512,
                         experts=4)]
    widths = [np.arange(1, 3000, 13)] * len(layers)
    ref = CtaWaveModel(H100_SXM, tile_hw=H100_SXM)
    ker = CtaWaveModel(H100_SXM, backend="kernel", device="cpu",
                       tile_hw=H100_SXM)
    a = ref.evaluate_model_batch(layers, widths)
    b = ker.evaluate_model_batch(layers, widths)
    np.testing.assert_array_equal(a.waves, b.waves)
    np.testing.assert_allclose(b.latency_s, a.latency_s, rtol=1e-12)
    np.testing.assert_allclose(b.utilization, a.utilization, rtol=1e-12)


def test_step_cache_persists_and_rereads_its_tiles(tmp_path):
    """A step cache built with ``hw=H100_SXM`` and a ``tile_cache`` runs
    its steps inside the kernel context: the first step's GEMMs and
    attention are tuned and their tiles written to the cache; a second
    process (a fresh memo, a new cache object on the same directory) reads
    them back instead of tuning again. The logits equal the eager
    forward's, since on the CPU every kernel is its plain version."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import WidthVariantCompileCache
    # head dim 64: the flash kernel's tiles (``flash_attention.FORMS``)
    cfg = reduced_config(get_config("qwen1.5-0.5b"), d_model=128,
                         n_heads=2, n_layers=2, d_ff=576)
    params = tfm.cast_params(
        tfm.init_params(cfg, torch.Generator().manual_seed(0)), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(4, 32)))
    with torch.inference_mode():
        want, _ = tfm.forward(params, cfg, tokens=toks, mode="prefill")
    first = ProfileTableCache(tmp_path)
    cache = WidthVariantCompileCache(cfg, hw=H100_SXM, tile_cache=first)
    got, _ = cache.prefill(params, toks)
    assert torch.equal(got, want)
    assert first.stats.writes > 0 and first.stats.hits == 0
    # the FFN up projection's (M, N, K) at 4 x 32 tokens
    up = at.autotune_matmul(H100_SXM, 128, cfg.d_ff, cfg.d_model)
    assert first.get_tiles(H100_SXM, "matmul",
                           (128, cfg.d_ff, cfg.d_model, 16)) == up.blocks
    at.clear_memo()
    again = ProfileTableCache(tmp_path)
    cache = WidthVariantCompileCache(cfg, hw=H100_SXM, tile_cache=again)
    got, _ = cache.prefill(params, toks)
    assert torch.equal(got, want)
    assert again.stats.hits == first.stats.writes
    assert again.stats.writes == 0 and again.stats.misses == 0
    assert at.memo_stats()["entries"] == first.stats.writes
