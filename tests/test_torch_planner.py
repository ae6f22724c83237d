"""The port's planner path (hardware, tail model, staircase kernel's plain
version, Algorithm 2, table cache, ServingWidthPlanner) against ``repro``'s
on the same inputs, on the CPU.

Tolerances: the numpy backend is bit-identical to ``repro``'s; the kernel
backend (on the CPU, the kernel's fp64 plain version) keeps wave counts
exact and latencies within 1e-12 relative of the numpy backend and of
``repro``'s fused backend, since they factor the float math differently;
against the Pallas kernel in interpret mode, which computes in fp32,
latencies and occupancies agree within rtol 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced
from repro.core import hardware as jhw
from repro.core import tail_model as jtm
from repro.core import LayerShape as JLayerShape
from repro.core import ProfileTableCache as JCache
from repro.core import TailEffectOptimizer as JOpt
from repro.core import TunableLayer as JTunable
from repro.core import analytic_candidates as j_analytic
from repro.kernels import ops as jops
from repro.kernels.staircase_fused import (
    fused_columns as j_fused_columns,
    fused_staircase_reference as j_fused_ref,
)
from repro.serving import ServingWidthPlanner as JPlanner
from repro.serving import TrafficClass as JTraffic
from repro.serving import serving_templates as j_templates
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import (
    H100_SXM, LayerShape, ProfileTableCache, TPU_V5E, TailEffectOptimizer,
    TunableLayer, WaveQuantizationModel, analytic_candidates, get_hardware,
    hardware_fingerprint, staircase_edges,
)
from repro_torch.core import hardware as thw
from repro_torch.kernels import matmul_tiled, ops
from repro_torch.kernels.staircase_fused import (
    staircase_ref, sweep_columns, sweep_rates,
)
from repro_torch.serving import ServingWidthPlanner, TrafficClass, \
    serving_templates
from test_torch_recurrent import one_torch_thread  # noqa: F401

HW = TPU_V5E


def both_layers(rng, n):
    """n random layer shapes (the ranges of repro's staircase suites), as
    (repro LayerShape, port LayerShape) lists."""
    out_j, out_t = [], []
    for i in range(n):
        kw = dict(tokens=int(rng.integers(1, 10000)),
                  d_in=int(rng.integers(1, 10000)),
                  width=int(rng.integers(1, 50000)),
                  shard_in=int(rng.choice([1, 2, 4, 8, 16])),
                  shard_out=int(rng.choice([1, 2, 3, 4, 8, 16])),
                  dtype_bits=int(rng.choice([16, 32])),
                  flop_multiplier=float(rng.choice([1.0, 0.5, 3.0])))
        out_j.append(JLayerShape(f"l{i}", **kw))
        out_t.append(LayerShape(f"l{i}", **kw))
    return out_j, out_t


# ---------------------------------------------------------------------------
# hardware
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["tpu_v5e", "tpu_v4", "tpu_v5p",
                                  "tpu_lite"])
def test_tpu_entries_equal_the_reference(name):
    assert dataclasses.asdict(get_hardware(name)) == \
        dataclasses.asdict(jhw.get_hardware(name))


def test_h100_entry_follows_the_matmul_tile():
    hw = get_hardware("h100_sxm")
    assert hw is H100_SXM and hw.cores_per_chip == 132
    assert (hw.lane, hw.sublane(16), hw.sublane(32)) == (
        matmul_tiled.BLOCK_N, matmul_tiled.BLOCK_M, matmul_tiled.BLOCK_M)
    assert hw.ici_bandwidth == 0.0
    assert hardware_fingerprint(hw) != hardware_fingerprint(TPU_V5E)
    assert set(thw.REGISTRY) == set(jhw.REGISTRY) | {
        "h100_sxm", "h100_pcie", "a100_sxm4_80gb", "titan_v",
        "quadro_p6000", "jetson_nano"}


# ---------------------------------------------------------------------------
# tail model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(6))
def test_numpy_backend_bit_identical_to_reference(seed):
    rng = np.random.default_rng(seed)
    jl, tl = both_layers(rng, 8)
    widths = [rng.integers(1, 50000, size=int(rng.integers(1, 300)))
              for _ in jl]
    jm, tm = jtm.WaveQuantizationModel(HW), WaveQuantizationModel(HW)
    for a, b, w in zip(jl, tl, widths):
        ja, ta = jm.evaluate_batch(a, w), tm.evaluate_batch(b, w)
        for f in ("latency_s", "utilization", "throughput", "waves",
                  "flops", "padded_flops"):
            assert np.array_equal(getattr(ja, f), getattr(ta, f)), f
    ja = jm.evaluate_model_batch(jl, widths)
    ta = tm.evaluate_model_batch(tl, widths)
    for f in ("latency_s", "utilization", "throughput", "waves"):
        assert np.array_equal(getattr(ja, f), getattr(ta, f)), f
    for x, y in zip(jm.latency_model_batch(jl, widths),
                    tm.latency_model_batch(tl, widths)):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("against", ["numpy", "repro_fused"])
@pytest.mark.parametrize("seed", range(4))
def test_kernel_backend_matches(against, seed):
    """The kernel backend on the CPU (the kernel's fp64 plain version)
    against the port's numpy backend and against ``repro``'s fused NumPy
    backend: equal waves, latency within 1e-12 relative, equal stair
    edges, per layer and stacked."""
    rng = np.random.default_rng(100 + seed)
    jlayers, layers = both_layers(rng, 12)
    widths = [rng.integers(1, 50000, size=int(rng.integers(1, 120)))
              for _ in layers]
    if against == "numpy":
        ref, ref_layers = WaveQuantizationModel(HW), layers
    else:
        ref = jtm.WaveQuantizationModel(HW, backend="fused")
        ref_layers = jlayers
    ker = WaveQuantizationModel(HW, backend="kernel", device="cpu")
    a = ref.evaluate_model_batch(ref_layers, widths)
    b = ker.evaluate_model_batch(layers, widths)
    assert np.array_equal(a.waves, b.waves)
    np.testing.assert_allclose(b.latency_s, a.latency_s, rtol=1e-12, atol=0)
    for ra, layer, w in zip(ref_layers, layers, widths):
        w = np.sort(w)
        ta, tb = ref.evaluate_batch(ra, w), ker.evaluate_batch(layer, w)
        assert np.array_equal(ta.waves, tb.waves)
        np.testing.assert_allclose(tb.latency_s, ta.latency_s, rtol=1e-12)
        assert np.array_equal(staircase_edges(w, ta.latency_s),
                              staircase_edges(w, tb.latency_s))
    lat = ker.latency_model_batch(layers, widths)
    for i, row in enumerate(lat):
        np.testing.assert_allclose(row, a.layer_table(i).latency_s,
                                   rtol=1e-12)


def test_kernel_backend_falls_back_outside_its_domain():
    layers = [LayerShape(f"l{i}", tokens=128, d_in=512, width=1)
              for i in range(3)]
    widths = [[1, 128, 129], [0, 5, 7], [256, 257, 300]]
    ref = WaveQuantizationModel(HW).latency_model_batch(layers, widths)
    ker = WaveQuantizationModel(HW, backend="kernel", device="cpu") \
        .latency_model_batch(layers, widths)
    for a, b in zip(ref, ker):
        assert np.array_equal(a, b)     # exact: the numpy core ran
    for backend in ("pallas", "fused"):
        with pytest.raises(ValueError, match="backend"):
            WaveQuantizationModel(HW, backend=backend)


# ---------------------------------------------------------------------------
# the kernel's plain version
# ---------------------------------------------------------------------------
def _sweep_inputs(rng, rows, cols, hw=HW):
    """Random widths and ``rows`` layers (shards 1-8, both dtypes, FLOP
    multipliers), as repro's layer shapes and the port's sweep inputs."""
    jl, tl = both_layers(rng, rows)
    w = rng.integers(1, 50000, size=(rows, cols))
    ins = [torch.from_numpy(np.ascontiguousarray(w))] + [
        torch.from_numpy(np.asarray(a)) for a in sweep_columns(hw, tl)] + [
        torch.from_numpy(sweep_rates(hw))]
    return jl, w, ins


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (8, 128), (13, 200),
                                   (40, 257), (24, 3)])
def test_staircase_ref_matches_the_reference(shape):
    """Bit for bit against repro's numpy engine (latency and waves) and
    repro's fp64 fused reference (waves and occupancy); against the Pallas
    kernel in interpret mode (fp32, on repro's affine columns): waves
    exact, latency and occupancy within rtol 1e-6."""
    rng = np.random.default_rng(42)
    rows, cols = shape
    jl, w, ins = _sweep_inputs(rng, rows, cols)
    got = staircase_ref(*ins, lane=HW.lane)
    want = jtm.WaveQuantizationModel(HW).evaluate_model_batch(jl, list(w))
    for i in range(rows):
        row = want.layer_table(i)
        assert np.array_equal(row.latency_s, got[0][i].numpy())
        assert np.array_equal(row.waves, got[1][i].numpy())
    so, ca, mb, mc = j_fused_columns(HW, jl)
    fused = j_fused_ref(w, so, ca, mb, mc, lane=HW.lane)
    assert np.array_equal(fused[1], got[1].numpy())
    assert np.array_equal(fused[2], got[2].numpy())
    lat32, wv32, occ32 = jops.staircase_latency(
        w, so, ca, mb, mc, lane=HW.lane, force="pallas_interpret")
    assert np.array_equal(wv32, got[1].numpy())
    np.testing.assert_allclose(lat32, got[0].numpy(), rtol=1e-6)
    np.testing.assert_allclose(occ32, got[2].numpy(), rtol=1e-6)


def test_staircase_ref_ragged_lane_and_exact_multiples():
    """A lane that is not a power of two, shards 1-3, and widths 1 and
    exact multiples of shard * lane (the stair edges): bit for bit
    repro's numpy engine on the same spec."""
    rng = np.random.default_rng(7)
    lane = 96
    hw, jhw96 = dataclasses.replace(HW, lane=lane), \
        dataclasses.replace(jhw.TPU_V5E, lane=lane)
    jl, tl = [], []
    for i in range(37):
        kw = dict(tokens=int(rng.integers(1, 9000)),
                  d_in=int(rng.integers(1, 9000)), width=1,
                  shard_out=int(rng.choice([1, 2, 3])))
        jl.append(JLayerShape(f"l{i}", **kw))
        tl.append(LayerShape(f"l{i}", **kw))
    so = np.array([[t.shard_out] for t in tl])
    w = rng.integers(1, 20000, size=(37, 1000))
    w[:, 0] = 1
    w[:, 1] = so[:, 0] * lane * rng.integers(1, 50, size=37)
    got = ops.staircase_latency(
        torch.from_numpy(w), *(torch.from_numpy(np.asarray(a)) for a in
                               sweep_columns(hw, tl)),
        torch.from_numpy(sweep_rates(hw)), lane=lane)
    want = jtm.WaveQuantizationModel(jhw96).evaluate_model_batch(jl, list(w))
    for i in range(37):
        assert np.array_equal(want.layer_table(i).latency_s,
                              got[0][i].numpy())
        assert np.array_equal(want.layer_table(i).waves, got[1][i].numpy())
    assert (got[2][:, 1] == 1.0).all()          # a full last wave
    assert (got[1][:, 0] == 1).all()


def test_staircase_dispatch_on_the_cpu():
    w = torch.ones(2, 3, dtype=torch.int64)
    one = torch.ones(2, 1, dtype=torch.int64)
    col = torch.ones(2, 1, dtype=torch.float64)
    rates = torch.ones(2, dtype=torch.float64)
    lat, wv, occ = ops.staircase_latency(w, one, col, col, one, one, one,
                                         rates, lane=4)
    assert lat.dtype == torch.float64 and wv.dtype == torch.int64
    assert lat.device.type == "cpu"
    with pytest.raises(ValueError, match="force"):
        ops.staircase_latency(w, one, col, col, one, one, one, rates,
                              lane=4, force="kernel")


def test_sweep_columns_are_the_model_s():
    """The sweep's columns are the tail model's stacked columns, and on
    repro's layers they give repro's affine coefficients back."""
    rng = np.random.default_rng(3)
    jl, tl = both_layers(rng, 9)
    so, two_mk, fm, mk, kpm, bpe = sweep_columns(HW, tl)
    cols = WaveQuantizationModel(HW)._stack_columns(tl)
    for a, b in ((so, cols.shard_out), (two_mk, cols.two_mk),
                 (fm, cols.fm), (mk, cols.mk), (kpm, cols.k_plus_m),
                 (bpe, cols.bits // 8)):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    jso, ca, mb, mc = j_fused_columns(HW, jl)
    assert np.array_equal(jso, so)
    np.testing.assert_allclose(ca, two_mk * fm / HW.peak_flops_bf16
                               * HW.lane, rtol=1e-15)
    np.testing.assert_allclose(mc, mk * bpe / HW.hbm_bandwidth, rtol=1e-15)
    np.testing.assert_allclose(mb, kpm * bpe / HW.hbm_bandwidth * HW.lane,
                               rtol=1e-15)
    assert np.array_equal(sweep_rates(HW), [HW.peak_flops_bf16,
                                            HW.hbm_bandwidth])


@pytest.mark.parametrize("spec", ["tpu_v4", "tpu_v5p"])
def test_kernel_backend_breaks_ties_as_numpy(spec):
    """Paper Tables 4/5's layers on two TPU specs, where the four layers'
    latency gains are equal in exact arithmetic and the numpy engine's
    last bits order them: the kernel backend's plan is numpy's (and
    repro's). The affine fp32 sweep picked another plan on tpu_v5p on the
    card, and its fp64 form another on both."""
    hw, jhw_ = get_hardware(spec), jhw.get_hardware(spec)

    def tunables(mod, hw_):
        LS, TL, cands_fn = mod
        out = []
        for i, w in enumerate((11008, 13824, 9000, 5500)):
            layer = LS(f"L{i}", tokens=4096, d_in=4096, width=w,
                       shard_out=16)
            out.append(TL(layer=layer, params_per_unit=4096,
                          candidates=cands_fn(hw_, layer,
                                              max_width=int(w * 1.5))))
        return out
    jls, tls = tunables(JMOD, jhw_), tunables(TMOD, hw)
    tau = 0.1 * sum(tl.params(tl.layer.width) for tl in tls)
    want = JOpt(jtm.WaveQuantizationModel(jhw_)).optimize_latency(
        jls, tau=tau, delta=0.95)
    for backend in ("numpy", "kernel"):
        got = TailEffectOptimizer(WaveQuantizationModel(
            hw, backend=backend, device="cpu")).optimize_latency(
            tls, tau=tau, delta=0.95)
        assert got.new_widths == want.new_widths, backend
        assert [m.layer for m in got.moves] == [m.layer for m in want.moves]
        assert got.latency_new_s == want.latency_new_s


# ---------------------------------------------------------------------------
# Algorithm 2
# ---------------------------------------------------------------------------
def _tunables(mod, seed, n=6, shards=(1, 8, 16)):
    """repro's ``TestFusedOptimizerParity._tunables``, for either package."""
    LS, TL, cands_fn = mod
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        w = int(rng.integers(1024, 16384))
        layer = LS(f"L{i}", tokens=4096, d_in=4096, width=w,
                   shard_out=int(rng.choice(shards)))
        cands = cands_fn(HW, layer, max_width=int(w * 1.6))
        out.append(TL(layer=layer, candidates=cands, params_per_unit=4096))
    return out


JMOD = (JLayerShape, JTunable, j_analytic)
TMOD = (LayerShape, TunableLayer, analytic_candidates)


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
@pytest.mark.parametrize("seed", [0, 7, 123, 5])
def test_optimizer_matches_reference(backend, seed):
    """Same widths and moves as repro's numpy optimizer; latencies exact
    on the numpy backend, within 1e-12 relative on the kernel backend."""
    jopt = JOpt(jtm.WaveQuantizationModel(HW))
    topt = TailEffectOptimizer(
        WaveQuantizationModel(HW, backend=backend, device="cpu"))
    rtol = 0 if backend == "numpy" else 1e-12
    jls = _tunables(JMOD, seed, n=6 + seed % 5)
    tau = 0.02 * sum(tl.params(tl.layer.width) for tl in jls)
    for delta in (0.95, 0.9):
        a = jopt.optimize_latency(_tunables(JMOD, seed, n=6 + seed % 5),
                                  tau, delta=delta)
        b = topt.optimize_latency(_tunables(TMOD, seed, n=6 + seed % 5),
                                  tau, delta=delta)
        assert a.new_widths == b.new_widths
        assert [(m.layer, m.kind, m.old_width, m.new_width)
                for m in a.moves] == [(m.layer, m.kind, m.old_width,
                                       m.new_width) for m in b.moves]
        np.testing.assert_allclose(b.latency_new_s, a.latency_new_s,
                                   rtol=rtol, atol=0)
        assert (a.satisfied, a.tau_final) == (b.satisfied, b.tau_final)
    for slack in (0.0, 0.05):
        c = jopt.optimize_accuracy(_tunables(JMOD, seed), slack)
        d = topt.optimize_accuracy(_tunables(TMOD, seed), slack)
        assert c.new_widths == d.new_widths
        np.testing.assert_allclose(d.latency_new_s, c.latency_new_s,
                                   rtol=rtol, atol=0)
        assert c.params_new == d.params_new


def test_optimizer_on_misaligned_layers():
    """tests/test_tail_optimizer.py's shape family (shard 16, 1.6x
    candidates), more layers than one vectorized grid group."""
    def make(mod, i, w):
        LS, TL, cands_fn = mod
        layer = LS(f"L{i}", tokens=4096, d_in=4096, width=w, shard_out=16)
        return TL(layer=layer, params_per_unit=4096,
                  candidates=cands_fn(HW, layer, max_width=int(w * 1.6)))
    ws = [5000, 9000, 2100, 16000, 3333, 12345, 7777, 1500, 4097]
    jls = [make(JMOD, i, w) for i, w in enumerate(ws)]
    tls = [make(TMOD, i, w) for i, w in enumerate(ws)]
    tau = 0.05 * sum(tl.params(tl.layer.width) for tl in jls)
    a = JOpt(jtm.WaveQuantizationModel(HW)).optimize_latency(jls, tau, 0.9)
    b = TailEffectOptimizer(WaveQuantizationModel(HW)).optimize_latency(
        tls, tau, 0.9)
    assert a.new_widths == b.new_widths
    assert a.latency_new_s == b.latency_new_s


# ---------------------------------------------------------------------------
# table cache and the serving planner
# ---------------------------------------------------------------------------
TRAFFIC = [("decode", 96), ("mixed", 512), ("prefill", 4096)]


def _cfgs():
    kw = dict(d_model=128, n_layers=4, d_ff=576)
    return (jax_reduced(jax_get_config("qwen1.5-0.5b"), **kw),
            reduced_config(get_config("qwen1.5-0.5b"), **kw))


@pytest.mark.parametrize("sites", [("mlp",), ("mlp", "attn")])
def test_planner_matches_reference(sites):
    jc, tc = _cfgs()
    jt, jmods = j_templates(jc, HW, tokens=96, sites=sites)
    tt, tmods = serving_templates(tc, HW, tokens=96, sites=sites)
    assert [t.layer for t in tt] == [LayerShape(**dataclasses.asdict(
        t.layer)) for t in jt]
    assert {k: (r.layer, r.site) for k, r in tmods.items()} == \
        {k: (r.layer, r.site) for k, r in jmods.items()}
    jp = JPlanner(HW, jt, modules=jmods)
    tp = ServingWidthPlanner(HW, tt, modules=tmods, device="cpu")
    jplans = jp.plan([JTraffic(n, t) for n, t in TRAFFIC])
    tplans = tp.plan([TrafficClass(n, t) for n, t in TRAFFIC])
    assert list(jplans) == list(tplans)
    for name in jplans:
        a, b = jplans[name], tplans[name]
        assert a.widths == b.widths and a.satisfied == b.satisfied
        np.testing.assert_allclose(b.latency_s, a.latency_s, rtol=1e-12)
        np.testing.assert_allclose(b.baseline_latency_s,
                                   a.baseline_latency_s, rtol=1e-12)
    # select: empty batch, one token, exact log ties, between classes
    for tokens in (0, 1, 96, 200, 223, 224, 512, 1449, 1448, 4096, 10**7,
                   int(np.sqrt(96 * 512)), int(np.sqrt(512 * 4096)) + 1):
        assert jp.select(tokens).traffic.name == \
            tp.select(tokens).traffic.name, tokens


def test_select_tie_goes_to_the_class_planned_first():
    _, tc = _cfgs()
    tt, tmods = serving_templates(tc, HW, tokens=96)
    tp = ServingWidthPlanner(HW, tt, modules=tmods, device="cpu")
    tp.plan([TrafficClass("b", 200, delta=0.9), TrafficClass("a", 200)])
    assert tp.select(150).traffic.name == "b"      # equal distances
    assert tp.select(300).traffic.name == "b"
    with pytest.raises(ValueError, match="no plans"):
        ServingWidthPlanner(HW, tt, device="cpu").select(5)


def test_planner_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, tc = _cfgs()
    tt, tmods = serving_templates(tc, HW, tokens=96)
    with pytest.raises(RuntimeError, match="cuda"):
        ServingWidthPlanner(HW, tt, modules=tmods)


def test_warm_planner_restart_skips_sweeps(tmp_path):
    """As tests/test_width_planner.py: a restarted planner on the same
    cache performs zero model sweeps and returns the same plans; a
    numpy-backend build never reads the kernel's entries."""
    _, tc = _cfgs()
    tt, tmods = serving_templates(tc, HW, tokens=96, sites=("mlp", "attn"))
    traffic = [TrafficClass(n, t) for n, t in TRAFFIC]
    cold = ServingWidthPlanner(HW, tt, modules=tmods, device="cpu",
                               cache=ProfileTableCache(tmp_path))
    cold_plans = {k: p.widths for k, p in cold.plan(traffic).items()}
    assert cold.model.eval_calls > 0
    warm = ServingWidthPlanner(HW, tt, modules=tmods, device="cpu",
                               cache=ProfileTableCache(tmp_path))
    assert {k: p.widths for k, p in warm.plan(traffic).items()} == \
        cold_plans
    assert warm.model.eval_calls == 0 and warm.opt.cache.stats.hits > 0

    numpy_opt = TailEffectOptimizer(WaveQuantizationModel(HW),
                                    cache=ProfileTableCache(tmp_path))
    numpy_opt.optimize_latency(warm._retokened(96), tau=1e9, delta=0.95)
    assert numpy_opt.cache.stats.hits == 0
    assert numpy_opt.model.eval_calls == 1


def test_bundle_cache_keys_the_kernel_variant(tmp_path):
    """Deep stacks cache one whole-stack bundle; its key carries the
    sweep engine, so the reference's numpy bundles and the kernel's never
    answer each other."""
    layers = [TunableLayer(layer=LayerShape(f"L{i}", tokens=512, d_in=1024,
                                            width=2816),
                           candidates=np.arange(128, 2817, 128),
                           params_per_unit=3072) for i in range(64)]
    jlayers = [JTunable(layer=JLayerShape(f"L{i}", tokens=512, d_in=1024,
                                          width=2816),
                        candidates=np.arange(128, 2817, 128),
                        params_per_unit=3072) for i in range(64)]
    ker = TailEffectOptimizer(
        WaveQuantizationModel(HW, backend="kernel", device="cpu"),
        cache=ProfileTableCache(tmp_path))
    a = ker.optimize_accuracy(layers, latency_slack=0.1)
    ref = JOpt(jtm.WaveQuantizationModel(HW), cache=JCache(tmp_path))
    b = ref.optimize_accuracy(jlayers, latency_slack=0.1)
    assert ref.cache.stats.hits == 0 and ref.model.eval_calls == 1
    assert a.new_widths == b.new_widths
    again = TailEffectOptimizer(
        WaveQuantizationModel(HW, backend="kernel", device="cpu"),
        cache=ProfileTableCache(tmp_path))
    assert again.optimize_accuracy(layers, 0.1).new_widths == a.new_widths
    assert again.model.eval_calls == 0

    # The card's fp32 sweep and the CPU's fp64 one share no entries: the
    # CPU-written bundle does not answer a cuda-device model, which sweeps
    # (here through a stand-in for the card) and writes its own.
    card = WaveQuantizationModel(HW, backend="kernel", device="cuda")
    assert (card.table_variant, again.model.table_variant) == \
        ("kernel-cuda", "kernel-cpu")
    sweeps = []

    def card_sweep(shapes, w2d, counts):
        sweeps.append(w2d.shape)
        return again.model.latency_model_packed(shapes, w2d, counts)

    card.latency_model_packed = card_sweep
    on_card = TailEffectOptimizer(card, cache=ProfileTableCache(tmp_path))
    assert on_card.optimize_accuracy(layers, 0.1).new_widths == a.new_widths
    assert len(sweeps) == 1 and on_card.cache.stats.hits == 0
    on_card.optimize_accuracy(layers, 0.1)
    assert len(sweeps) == 1 and on_card.cache.stats.hits == 1
