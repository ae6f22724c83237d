"""The tail model's GPU form (``core/gpu.py``, ``tail_model.CtaWaveModel``,
the CTA-wave sweep's plain version), the frozen scalar path, the profiler,
Fig. 5's model side, the planner and quickstart on ``H100_SXM``, and the
step cache's in-place fault, on the CPU.

Tolerances: the parity anchor holds ``CtaWaveModel`` to
``WaveQuantizationModel`` within 1e-12 relative (the two order one
product's float factors differently) with exact waves; the stacked and
per-layer sweeps, the scalar path and ``repro``'s copies are held bit for
bit; the CTA-wave plain version equals its NumPy oracle exactly in waves
and tiles and within 1e-15 relative in latency.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import LayerShape as JLayerShape
from repro.core import TPU_V5E as J_TPU_V5E
from repro.core import TailEffectOptimizer as JOpt
from repro.core import TunableLayer as JTunable
from repro.core import WaveQuantizationModel as JWQM
from repro.core import profiler as jprofiler
from repro.core import scalar_ref as jscalar
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import (
    H100_SXM, LayerShape, ProfileTableCache, TPU_LITE, TPU_V5E,
    TailEffectOptimizer, TunableLayer, WaveQuantizationModel,
    analytic_candidates, get_hardware, hardware_fingerprint, staircase_edges,
)
from repro_torch.core import profiler, scalar_ref
from repro_torch.core import tail_model as tm
from repro_torch.core.gpu import GpuSpec, is_gpu
from repro_torch.core.tail_model import CtaWaveModel, GridWaveModel
from repro_torch.kernels import matmul_tiled as mt
from repro_torch.kernels import moe_gmm as mg
from repro_torch.kernels import ops
from repro_torch.kernels import staircase_fused as sf
from repro_torch.launch import quickstart, wave_verification as wv
from repro_torch.models import transformer as tfm
from repro_torch.serving import (
    ServingWidthPlanner, TrafficClass, WidthVariantCompileCache,
    serving_templates,
)
from repro_torch.serving.compile_cache import leaves
from test_torch_recurrent import one_torch_thread  # noqa: F401


def random_layers(rng, n, experts=False):
    """n random layer shapes over the ranges of repro's staircase suites
    (tokens, d_in, shards, dtypes, flop multipliers)."""
    return [LayerShape(
        f"l{i}", tokens=int(rng.integers(1, 10000)),
        d_in=int(rng.integers(1, 10000)), width=int(rng.integers(1, 50000)),
        shard_in=int(rng.choice([1, 2, 4, 8, 16])),
        shard_out=int(rng.choice([1, 2, 3, 4, 8, 16])),
        dtype_bits=int(rng.choice([16, 32])),
        flop_multiplier=float(rng.choice([1.0, 0.5, 3.0])),
        experts=int(rng.choice([1, 4])) if experts else 1)
        for i in range(n)]


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------
def test_gpu_spec_is_the_sxm5_data_sheet():
    hw = get_hardware("h100_sxm")
    assert hw is H100_SXM and is_gpu(hw) and not is_gpu(TPU_V5E)
    assert (hw.sm_count, hw.smem_per_sm, hw.l2_bytes, hw.hbm_bytes,
            hw.hbm_bandwidth, hw.peak_flops_bf16) == (
        132, 228 * 1024, 50 * 10**6, 80 * 10**9, 3.35e12, 989e12)
    assert hw == GpuSpec() and hash(hw) == hash(GpuSpec())
    pcie = dataclasses.replace(hw, name="h100_pcie", cores_per_chip=114)
    assert hardware_fingerprint(pcie) != hardware_fingerprint(hw)
    # a GPU spec's key differs from a TPU spec with the same fields
    assert hardware_fingerprint(hw) != hardware_fingerprint(
        tm.HardwareSpec(**{f.name: getattr(hw, f.name) for f in
                           dataclasses.fields(tm.HardwareSpec)}))


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("module", [mt, mg])
def test_gemm_forms_on_the_cpu_are_the_constant(module, kind):
    assert module.form(kind, "cpu") == mt.FORMS[mt.form_key(kind)]
    tiles = [t for k, t in mt.FORMS if k == kind]
    assert tiles == (list(mt.PREFILL_TILES) if kind == "prefill"
                     else [mt.DECODE_TILE])
    for tile in tiles:
        assert module.form(kind, "cpu", tile) == mt.FORMS[kind, tile]
    with pytest.raises(ValueError, match="form kind"):
        module.form("both", "cpu")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
class TileGridModel(CtaWaveModel):
    """The parity anchor's grid: one CTA per (sublane, lane) output tile,
    K padded to lane, one CTA a core."""

    def form(self, layer):
        hw = self.hw
        bm, lane = hw.sublane(layer.dtype_bits), hw.lane
        k_cta = -(-(-(-layer.d_in // layer.shard_in)) // lane) * lane
        rows = -(-layer.tokens // bm)
        return tm.CtaForm(g=rows * layer.experts, slots=hw.cores_per_chip,
                          block_n=lane, m_pad=rows * bm, k_pad=k_cta,
                          tile_flops=(2.0 * bm) * lane * k_cta)


@pytest.mark.parametrize("spec", ["tpu_v5e", "tpu_lite"])
@pytest.mark.parametrize("seed", range(4))
def test_parity_anchor_equals_the_tpu_form(spec, seed):
    """With one core, one CTA a core, a (sublane, lane) tile and K padded
    to lane, the GPU form is the TPU form: latency within 1e-12 relative,
    waves = the TPU form's x ceil(m_pad / sublane)."""
    hw = get_hardware(spec)
    assert hw.cores_per_chip == 1
    rng = np.random.default_rng(seed)
    layers = random_layers(rng, 10)
    widths = [rng.integers(1, 50000, size=int(rng.integers(1, 200)))
              for _ in layers]
    tpu, cta = WaveQuantizationModel(hw), TileGridModel(hw)
    for layer, w in zip(layers, widths):
        a, b = tpu.evaluate_batch(layer, w), cta.evaluate_batch(layer, w)
        rows = -(-layer.tokens // hw.sublane(layer.dtype_bits))
        assert np.array_equal(b.waves, a.waves * rows)
        np.testing.assert_allclose(b.latency_s, a.latency_s, rtol=1e-12)
        np.testing.assert_allclose(b.padded_flops, a.padded_flops,
                                   rtol=1e-12)
        np.testing.assert_allclose(b.utilization, a.utilization, rtol=1e-12)


@pytest.mark.parametrize("experts", [1, 4])
def test_cta_waves_follow_the_gemm_grid(experts):
    """B equals the GEMM wrappers' ``grid_blocks`` for every form (decode
    K chunks, ragged M, N and K, shards), and waves = ceil(B / (S * c))
    with c the form's effective CTAs an SM."""
    model = CtaWaveModel(H100_SXM)
    for tokens in (1, 4, 63, 64, 65, 128, 129, 512, 1408, 4096):
        for d_in, shard_in in ((1, 1), (255, 1), (256, 1), (257, 1),
                               (1024, 1), (2816, 2), (4096, 1), (7680, 3)):
            layer = LayerShape("l", tokens, d_in, 1, shard_in=shard_in,
                               experts=experts)
            k = -(-d_in // shard_in)
            form = "decode" if mt.kernel_form(tokens, k)[0] else "prefill"
            slots = 132 * tm.EFFECTIVE_CTAS_PER_SM[form]
            for width, shard_out in ((1, 1), (63, 1), (64, 1), (65, 1),
                                     (2112, 1), (2816, 3), (8448, 2)):
                at = dataclasses.replace(layer, width=width,
                                         shard_out=shard_out)
                n = -(-width // shard_out)
                want = mt.grid_blocks(tokens, n, k) if experts == 1 \
                    else mg.grid_blocks(experts, tokens, n, k)
                assert model.blocks(at) == want
                assert model.waves(at) == -(-want // slots)
                assert model.evaluate(at).waves == -(-want // slots)


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
@pytest.mark.parametrize("seed", range(3))
def test_stacked_sweep_equals_per_layer(backend, seed):
    """Every row of ``evaluate_model_batch`` / ``latency_model_batch`` is
    bit for bit the per-layer sweep, on both engines (the kernel engine on
    the CPU is the CTA-wave kernel's fp64 plain version)."""
    rng = np.random.default_rng(10 + seed)
    layers = random_layers(rng, 12, experts=True)
    widths = [rng.integers(1, 50000, size=int(rng.integers(1, 150)))
              for _ in layers]
    model = CtaWaveModel(H100_SXM, backend=backend, device="cpu")
    stacked = model.evaluate_model_batch(layers, widths)
    lats = model.latency_model_batch(layers, widths)
    for i, (layer, w) in enumerate(zip(layers, widths)):
        one = model.evaluate_batch(layer, w)
        row = stacked.layer_table(i)
        for f in ("widths", "latency_s", "utilization", "throughput",
                  "waves", "flops", "padded_flops"):
            assert np.array_equal(getattr(one, f), getattr(row, f)), f
        assert np.array_equal(lats[i], one.latency_s)
        assert np.array_equal(model.latency_batch(layer, w), one.latency_s)
    if backend == "kernel":
        ref = CtaWaveModel(H100_SXM).evaluate_model_batch(layers, widths)
        assert np.array_equal(stacked.waves, ref.waves)
        np.testing.assert_allclose(stacked.latency_s, ref.latency_s,
                                   rtol=1e-12)


def staircase_cta_oracle(w, so, g, sl, dl, mk, kpm, bpe, bw, block_n):
    """The CTA-wave sweep in plain Python, cell by cell, in
    ``CtaWaveModel``'s float64 operand order."""
    lat = np.empty(w.shape)
    waves = np.empty(w.shape, np.int64)
    tiles = np.empty(w.shape, np.int64)
    for r in range(w.shape[0]):
        for c in range(w.shape[1]):
            t = -(-(-(-int(w[r, c]) // int(so[r, 0]))) // block_n)
            n = -(-(int(g[r, 0]) * t) // int(sl[r, 0]))
            tiles[r, c], waves[r, c] = t, n
            nbytes = (int(mk[r, 0]) + int(kpm[r, 0]) * (t * block_n)) \
                * int(bpe[r, 0])
            lat[r, c] = max(float(n) * float(dl[r, 0]), nbytes / bw)
    return lat, waves, tiles


@pytest.mark.parametrize("rows,cols,shards,block_n", [
    (1, 1, (1,), 64), (24, 3, (1,), 64), (37, 100, (3,), 64),
    (13, 57, (1, 2, 3, 8), 96), (5, 0, (1,), 64)])
def test_staircase_cta_ref_equals_the_oracle(rows, cols, shards, block_n):
    """Ragged rows, shards > 1, widths 1 and exact multiples of
    shard x block_n, g over the GEMM's range, one to three CTAs an SM:
    bit for bit the oracle."""
    rng = np.random.default_rng(rows * 7 + cols)
    so = rng.choice(shards, size=(rows, 1))
    w = rng.integers(1, 50000, size=(rows, cols))
    if cols > 1:
        w[:, 0] = 1
        w[:, 1] = so[:, 0] * block_n * rng.integers(1, 40, size=rows)
    g = rng.integers(1, 65, size=(rows, 1)) * rng.integers(1, 17, (rows, 1))
    sl = 132 * rng.integers(1, 4, size=(rows, 1))
    dl = rng.random((rows, 1)) * 1e-5
    mk = rng.integers(1, 2 ** 26, size=(rows, 1))
    kpm = rng.integers(1, 2 ** 15, size=(rows, 1))
    bpe = rng.choice([2, 4, 8], size=(rows, 1))
    bandwidth = np.array([3.35e12])
    want = staircase_cta_oracle(w, so, g, sl, dl, mk, kpm, bpe,
                                bandwidth[0], block_n)
    t = [torch.from_numpy(a) for a in (w, so, g, sl, dl, mk, kpm, bpe,
                                       bandwidth)]
    got = ops.staircase_cta_latency(*t, block_n=block_n)
    assert got[0].dtype == torch.float64 and got[1].dtype == torch.int64
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])
    assert np.array_equal(got[2].numpy(), want[2])
    assert all(torch.equal(a, b) for a, b in zip(
        got, sf.staircase_cta_ref(*t, block_n=block_n)))


@pytest.mark.parametrize("cores", [None, 2])
def test_grid_wave_model_c_one_is_the_reference(cores):
    """``GridWaveModel`` with its new CTAs an SM left at 1 is ``repro``'s
    on every TPU spec, one core or two; on a GPU spec its wave is S x c
    blocks and dL their FLOPs at the peak."""
    from repro.core import GridWaveModel as JGrid
    from repro.core import get_hardware as j_get_hardware
    for spec in ("tpu_v5e", "tpu_v4"):
        hw, jhw = get_hardware(spec), j_get_hardware(spec)
        if cores is not None:
            hw = dataclasses.replace(hw, cores_per_chip=cores)
            jhw = dataclasses.replace(jhw, cores_per_chip=cores)
        a = GridWaveModel(hw, 2.0 * 256 * 256 * 512)
        b = JGrid(jhw, 2.0 * 256 * 256 * 512)
        assert a.delta_l == b.delta_l
        for blocks in (1, 7, 128, 129, 1000):
            assert dataclasses.astuple(a.evaluate(blocks)) == \
                dataclasses.astuple(b.evaluate(blocks))
    g = GridWaveModel(H100_SXM, 1e6, ctas_per_sm=2)
    assert [g.evaluate(b).waves for b in (1, 264, 265)] == [1, 1, 2]
    assert g.evaluate(265).latency_s == 2 * (264 * 1e6) / 989e12


def test_table_variant_names_the_form():
    """A GPU-form table never answers a TPU-form query, nor the other
    way: the variant names the form, its c and its engine."""
    c = tm.EFFECTIVE_CTAS_PER_SM
    base = f"cta-gemm-c{c['prefill']}.{c['decode']}"
    assert CtaWaveModel(H100_SXM).table_variant == base
    assert CtaWaveModel(H100_SXM, backend="kernel", device="cpu") \
        .table_variant == base + "-kernel-cpu"
    assert WaveQuantizationModel(H100_SXM).table_variant == ""


def test_table_cache_keeps_the_forms_apart(tmp_path):
    """The TPU form's tables of H100_SXM and the GPU form's share a cache
    directory and never answer each other; a warm GPU-form optimizer
    sweeps nothing."""
    layers = [TunableLayer(layer=LayerShape(f"L{i}", tokens=512, d_in=1024,
                                            width=2816),
                           candidates=np.arange(64, 2817, 64),
                           params_per_unit=3072) for i in range(4)]
    tpu = TailEffectOptimizer(WaveQuantizationModel(H100_SXM),
                              cache=ProfileTableCache(tmp_path))
    tpu.optimize_accuracy(layers, latency_slack=0.1)
    gpu = TailEffectOptimizer(CtaWaveModel(H100_SXM),
                              cache=ProfileTableCache(tmp_path))
    a = gpu.optimize_accuracy(layers, latency_slack=0.1)
    assert gpu.cache.stats.hits == 0 and gpu.model.eval_calls == 1
    warm = TailEffectOptimizer(CtaWaveModel(H100_SXM),
                               cache=ProfileTableCache(tmp_path))
    assert warm.optimize_accuracy(layers, 0.1).new_widths == a.new_widths
    assert warm.model.eval_calls == 0 and warm.cache.stats.hits > 0


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tokens,shard", [(4, 1), (128, 1), (512, 1),
                                          (4096, 1), (4096, 3)])
def test_gpu_candidates_are_the_cta_stair_edges(tokens, shard):
    """On a GPU spec ``analytic_candidates`` are ``staircase_edges`` of
    the CTA-wave model over a sweep at steps of shard x 64, each the
    widest width of its wave count; a TPU spec keeps the quantum's
    multiples."""
    layer = LayerShape("ffn", tokens=tokens, d_in=1024, width=2816,
                       shard_out=shard)
    q = 64 * shard
    sweep = np.arange(q, 4225, q)
    model = CtaWaveModel(H100_SXM)
    cands = analytic_candidates(H100_SXM, layer, max_width=4224)
    assert np.array_equal(cands, staircase_edges(
        sweep, model.latency_batch(layer, sweep)))
    assert cands[-1] == sweep[-1] and (cands % q == 0).all()
    lat = dict(zip(sweep.tolist(), model.latency_batch(layer, sweep)))
    for c in cands[:-1]:
        assert lat[int(c) + q] > lat[int(c)]
    lo = analytic_candidates(H100_SXM, layer, max_width=4224,
                             min_width=1000)
    assert np.array_equal(lo, cands[cands >= 1024])
    assert np.array_equal(analytic_candidates(TPU_V5E, layer),
                          np.arange(128 * shard, 2817, 128 * shard))


# ---------------------------------------------------------------------------
# the frozen scalar path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(3))
def test_scalar_ref_equals_the_reference_and_the_engine(seed):
    """The port's frozen scalar path equals ``repro``'s, and the port's
    table-driven engine equals it, bit for bit, per width."""
    rng = np.random.default_rng(20 + seed)
    model = WaveQuantizationModel(TPU_V5E)
    for layer in random_layers(rng, 8):
        widths = rng.integers(1, 50000, size=20)
        table = model.evaluate_batch(layer, widths)
        for i, w in enumerate(widths):
            at = layer.with_width(int(w))
            fields = dataclasses.asdict(at)
            del fields["experts"]          # the port's field, GPU form only
            got = scalar_ref.scalar_evaluate(TPU_V5E, at)
            want = jscalar.scalar_evaluate(J_TPU_V5E, JLayerShape(**fields))
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert table.point(i) == got


def _tunables(cls, shape_cls, rng, n):
    out = []
    for i in range(n):
        width = int(rng.integers(1024, 12000))
        layer = shape_cls(f"l{i}", tokens=4096, d_in=4096, width=width,
                          shard_out=16)
        cands = np.arange(2048, int(width * 1.6) + 1, 2048, dtype=np.int64)
        out.append(cls(layer=layer, candidates=cands, params_per_unit=4096,
                       max_width=int(width * 1.6)))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_engine_and_reference_optimizers_equal_the_scalar_path(seed):
    """Algorithm 2 both ways: the port's table-driven optimizer, the
    port's frozen scalar one and ``repro``'s scalar one return the same
    widths and moves."""
    layers = _tunables(TunableLayer, LayerShape,
                       np.random.default_rng(seed), 12)
    jlayers = _tunables(JTunable, JLayerShape,
                        np.random.default_rng(seed), 12)
    engine = TailEffectOptimizer(WaveQuantizationModel(TPU_V5E))
    scalar = scalar_ref.ScalarTailEffectOptimizer(
        scalar_ref.ScalarWaveModel(TPU_V5E))
    jsc = jscalar.ScalarTailEffectOptimizer(
        jscalar.ScalarWaveModel(J_TPU_V5E))
    tau = 0.05 * sum(tl.params(tl.layer.width) for tl in layers)
    for run in (lambda o, ls: o.optimize_latency(ls, tau, 0.9),
                lambda o, ls: o.optimize_accuracy(ls, 0.05)):
        a, b, c = run(engine, layers), run(scalar, layers), \
            run(jsc, jlayers)
        assert a.new_widths == b.new_widths == c.new_widths
        assert [dataclasses.astuple(m) for m in a.moves] == \
            [dataclasses.astuple(m) for m in b.moves] == \
            [dataclasses.astuple(m) for m in c.moves]
        assert a.latency_new_s == b.latency_new_s == c.latency_new_s


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["tpu_v5e", "h100_sxm"])
def test_profile_stack_equals_per_layer(spec):
    """``analytic_profile_stack`` rows are bit for bit the per-layer
    profiles; on a TPU spec they are ``repro``'s too."""
    hw = get_hardware(spec)
    layers = [LayerShape(f"l{i}", tokens=2048, d_in=1024 + 128 * i,
                         width=4096, shard_out=16) for i in range(4)]
    widths = [np.arange(512, 8193, 512), np.array([4096]),
              np.arange(256, 4097, 256), np.arange(64, 2049, 64)]
    stacked = profiler.analytic_profile_stack(hw, layers, widths)
    for layer, w, prof in zip(layers, widths, stacked):
        one = profiler.analytic_profile(hw, layer, w)
        assert prof.source == "analytic" and prof.name == layer.name
        for f in ("widths", "latency_s", "utilization", "throughput",
                  "waves"):
            assert np.array_equal(getattr(one, f), getattr(prof, f)), f
        if spec == "tpu_v5e":
            ref = jprofiler.analytic_profile(
                J_TPU_V5E, JLayerShape(layer.name, 2048, layer.d_in, 4096,
                                       shard_out=16), w)
            for f in ("latency_s", "utilization", "throughput", "waves"):
                assert np.array_equal(getattr(ref, f), getattr(prof, f)), f
    assert "width,latency_us" in stacked[0].as_table()


def test_flop_profile_counts_what_hlo_profile_counts():
    """``FlopCounterMode``'s FLOPs against XLA's ``cost_analysis`` FLOPs in
    ``repro``'s ``hlo_profile``, on a TPU spec (the same analytic overlay,
    so latency and waves are equal): XLA's CPU backend computes the bf16
    dot in fp32 and also counts its three converts, one FLOP an element of
    x, w and the output, which the torch counter, counting the product
    alone, does not."""
    m, k = 64, 96
    layer = LayerShape("l", tokens=m, d_in=k, width=256)
    widths = np.array([64, 100, 256])
    got = profiler.flop_profile(TPU_V5E, layer, widths)
    want = jprofiler.hlo_profile(J_TPU_V5E, JLayerShape("l", m, k, 256),
                                 widths.tolist())
    assert got.source == "flop"
    for f in ("widths", "latency_s", "waves"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    product = 2.0 * m * k * widths
    converts = m * k + k * widths + m * widths
    np.testing.assert_allclose(got.throughput * got.latency_s, product,
                               rtol=1e-12)
    np.testing.assert_allclose(want.throughput * want.latency_s,
                               product + converts, rtol=1e-12)
    gpu = profiler.flop_profile(H100_SXM, layer, widths)
    np.testing.assert_allclose(gpu.throughput * gpu.latency_s, product,
                               rtol=1e-12)


def test_grid_profile_waves_equal_the_model():
    """``grid_profile`` (``GridWaveModel`` over ``grid_blocks``) gives the
    model's waves at every width, prefill and decode."""
    for tokens in (4, 512, 1408):
        layer = LayerShape("l", tokens=tokens, d_in=4096, width=1)
        widths = np.arange(64, 12289, 320)
        prof = profiler.grid_profile(H100_SXM, layer, widths)
        assert prof.source == "grid"
        assert np.array_equal(
            prof.waves, CtaWaveModel(H100_SXM).evaluate_batch(
                layer, widths).waves)
        assert (prof.utilization <= 1.0).all()


def test_measured_profile_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        profiler.measured_profile(LayerShape("l", 4, 4, 4), [4],
                                  device="cpu")


# ---------------------------------------------------------------------------
# Fig. 5 on the model, and its card-side check on made-up sweeps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("c", [1, 2])
def test_wave_verification_model_checks(monkeypatch, c):
    monkeypatch.setitem(tm.EFFECTIVE_CTAS_PER_SM, "prefill", c)
    out = wv.model_checks(H100_SXM)
    assert out["v1"] and out["v2"] and out["v3"]
    assert out["slots"] == 132 * c and out["g"] == 11
    assert wv.edges_of({"widths": out["widths"], "w": out["waves"]},
                       "w")[:3] == [768 * c, 1536 * c, 2304 * c]


def test_card_checks_tell_the_slot_counts_apart():
    """A made-up card with flat stairs every 24 column tiles passes at 264
    slots, flat stairs included, and fails at 132 (an edge with no jump);
    one that steps every 12 passes at 132 and fails at 264 (a rise inside
    a stair)."""
    widths = np.arange(64, 12289, 64)
    tiles = widths // 64
    noise = 0.2 * (np.arange(widths.size) % 2)
    for period, good, bad in ((24, 264, 132), (12, 132, 264)):
        us = 40.0 * -(-tiles // period) + noise
        sweep = {"us": us.tolist(), "ctas_per_sm_occupancy": 2,
                 "waves_S": wv.slot_waves(1408, 4096, widths, 132),
                 "waves_Sc": wv.slot_waves(1408, 4096, widths, 264)}
        f = wv.fit(sweep, 132)
        assert f["follows"] == ("Sc" if good == 264 else "S")
        assert f["c"] == (2 if good == 264 else 1)
        assert f["S" if good == 132 else "Sc"]["flat_ok"]
        assert not f["S" if bad == 132 else "Sc"]["ok"]
    flat = wv.card_checks([10.0] * widths.size,
                          wv.slot_waves(1408, 4096, widths, 264))
    assert not flat["ok"]


def test_card_checks_fail_stairs_that_ramp():
    """A made-up card like the H100's sweep (PERF.md §6): a flat first
    stair, then stairs of 132 CTAs that rise 1 us per column of tiles
    inside. It steps with 132 slots, so c is chosen, but its stairs are
    not flat: each rise inside the second and third stairs exceeds the
    first stair's spread."""
    widths = np.arange(64, 12289, 64)
    waves = wv.slot_waves(1408, 4096, widths, 132)
    noise = 0.2 * (np.arange(widths.size) % 2)
    inside = np.concatenate([np.arange(b - a) * (i > 0) for i, (a, b)
                             in enumerate(wv.stairs(waves))])
    us = 18.8 * waves + 1.0 * inside + noise
    f = wv.fit({"us": us.tolist(), "ctas_per_sm_occupancy": 2,
                "waves_S": waves,
                "waves_Sc": wv.slot_waves(1408, 4096, widths, 264)}, 132)
    r = f["S"]
    assert f["follows"] == "S" and r["ok"] and not r["flat_ok"]
    assert r["noise_us"] == pytest.approx(0.2)
    assert r["max_inner_rise_us"] == pytest.approx(1.2)
    assert sum("inside a stair" in m for m in r["flat_fails"]) == 2 * 11
    assert r["stair_spreads_us"][1] == pytest.approx(11.2)


def test_card_checks_at_one_cta_an_sm():
    """At an occupancy of one, S and S x c are one slot count: ``fit``
    holds the sweep against it once and names it S."""
    widths = np.arange(64, 12289, 64)
    waves = wv.slot_waves(1408, 4096, widths, 132)
    us = 18.8 * waves + 0.2 * (np.arange(widths.size) % 2)
    f = wv.fit({"us": us.tolist(), "ctas_per_sm_occupancy": 1,
                "waves_S": waves, "waves_Sc": waves}, 132)
    assert f["follows"] == "S" and f["c"] == 1 and f["Sc"] is f["S"]
    assert f["S"]["ok"] and f["S"]["flat_ok"]


def test_card_checks_scale_the_noise_to_each_stair():
    """Jitter that grows with the time (2 % of each stair's level between
    neighbours, and a first stair that spans 3 %) stays inside every
    stair's tolerance, the first stair's spread scaled to that stair's
    median, though in the third stair it exceeds the first stair's
    spread in us."""
    widths = np.arange(64, 12289, 64)
    waves = wv.slot_waves(1408, 4096, widths, 132)
    level = 18.8 * waves
    us = level * (1.0 + 0.02 * (np.arange(widths.size) % 2))
    us[3] = level[3] * 0.99
    r = wv.card_checks(us, waves)
    assert r["ok"] and r["flat_ok"]
    assert r["noise_us"] == pytest.approx(0.03 * 18.8)
    assert r["stair_noise_us"][2] == pytest.approx(
        r["noise_us"] * np.median(us[24:36]) / r["dl_us"])
    assert r["max_inner_rise_us"] > r["noise_us"]


def test_wave_verification_runs_on_the_cpu():
    out = wv.main(["--device", "cpu"])
    assert "fit" not in out and out["model"]["v3"]


# ---------------------------------------------------------------------------
# the planner and quickstart on H100_SXM, on the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("c,long_plan", [
    (1, {2112: 3, 2816: 21}), (2, {2816: 24})])
def test_planner_plans_qwen_as_the_arithmetic_says(monkeypatch, c,
                                                   long_plan):
    """qwen1.5-0.5b's 24 FFNs planned for 512 tokens (176 CTAs) and 128
    (44): at c = 1 the 512-token class has two waves and the latency mode
    cuts as many FFNs to 2112 columns (one wave) as tau allows until it
    meets its 5 %; at c = 2 both classes lie in one wave of 264 up to
    4224 columns, so nothing is cut. The CPU plans on the numpy engine."""
    monkeypatch.setitem(tm.EFFECTIVE_CTAS_PER_SM, "prefill", c)
    cfg = get_config("qwen1.5-0.5b")
    tpl, mods = serving_templates(cfg, H100_SXM, tokens=512)
    model = CtaWaveModel(H100_SXM)
    assert model.blocks(tpl[0].layer) == 176
    assert model.blocks(dataclasses.replace(tpl[0].layer, tokens=128)) == 44
    planner = ServingWidthPlanner(H100_SXM, tpl, modules=mods, device="cpu")
    assert isinstance(planner.model, CtaWaveModel)
    assert planner.model.backend == "numpy"
    plans = planner.plan([TrafficClass("short", 128),
                          TrafficClass("long", 512)])
    counts = {}
    for w in plans["long"].widths.values():
        counts[w] = counts.get(w, 0) + 1
    assert counts == long_plan
    assert set(plans["short"].widths.values()) == {cfg.d_ff}
    assert plans["long"].satisfied == (c == 1)


def test_tpu_spec_planner_keeps_the_tpu_form():
    cfg = reduced_config(get_config("qwen1.5-0.5b"), d_model=128,
                         n_layers=2, d_ff=576)
    tpl, mods = serving_templates(cfg, TPU_V5E, tokens=96)
    planner = ServingWidthPlanner(TPU_V5E, tpl, modules=mods, device="cpu")
    assert type(planner.model) is WaveQuantizationModel
    assert planner.model.table_variant == "kernel-cpu"


def test_quickstart_runs_on_the_cpu(capsys):
    out = quickstart.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "Eq. 4 candidates" in text and "accuracy-oriented" in text
    lat = out["latency"]
    assert all(int(c) % 64 == 0 for c in out["candidates"])
    assert set(lat.new_widths.values()) < set(
        int(c) for c in out["candidates"])
    # one wave fewer in each FFN: 1408 CTAs at 2816 columns, 1312 at the
    # edge below (2624)
    assert lat.latency_new_s < lat.latency_old_s
    assert set(lat.new_widths.values()) == {2624}


def test_quickstart_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        quickstart.main([])


# ---------------------------------------------------------------------------
# the step cache after an in-place update
# ---------------------------------------------------------------------------
def test_step_cache_sees_an_in_place_update():
    """A leaf changed in place after a capture is copied in again: the
    cached prefill equals the eager forward on the changed tree (it used
    to keep the old weights, 1.04 away)."""
    cfg = reduced_config(get_config("qwen1.5-0.5b"), d_model=128,
                         n_layers=2, d_ff=576)
    params = tfm.cast_params(
        tfm.init_params(cfg, torch.Generator().manual_seed(0)), "cpu")
    cache = WidthVariantCompileCache(cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(1, 8)))
    assert cache.precompile("prefill", cache.full_key, (1, 8),
                            (params, toks))
    before, _ = cache.prefill(params, toks)
    before = before.clone()
    with torch.no_grad():
        for leaf in leaves(params):
            if leaf.dim() == 2 and leaf.is_floating_point():
                leaf.mul_(2)
    got, _ = cache.prefill(params, toks)
    with torch.inference_mode():
        want, _ = tfm.forward(params, cfg, tokens=toks, mode="prefill")
    assert cache.stats["hits"] == 2 and cache.stats["misses"] == 0
    assert not torch.equal(got, before)
    assert torch.equal(got, want)
