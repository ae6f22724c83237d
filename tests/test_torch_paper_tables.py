"""The paper's Fig. 1/3, Table 3 and Tables 4/5 in the port
(``repro_torch.launch.staircase``, ``nas_scaleup``,
``platform_generality``) and the GPU platforms of ``core.gpu``, on the
CPU.

In the TPU form each is held against the reference script it ports
(``benchmarks/staircase.py``, ``nas_scaleup.py``,
``platform_generality.py``): widths, waves, quanta and stair counts
exactly; latencies, fills and gains within 1e-12 relative (both run the
same float expressions; the port's copy of the engine is held bit for bit
in ``tests/test_torch_planner.py``); the CSV rows' detail strings equal.
The GPU form is held to its own invariants on ``H100_SXM``, and the kernel
backend's fp64 plain version (the CPU's route of ``staircase_cta`` and
``staircase_fused``) to the numpy engine's plans exactly.
"""

import dataclasses
import re

import numpy as np
import pytest

from benchmarks import nas_scaleup as jnas
from benchmarks import platform_generality as jplat
from benchmarks import staircase as jstair
from repro_torch.configs import get_config, list_archs
from repro_torch.core import (
    H100_SXM, LayerShape, TailEffectOptimizer, get_hardware,
)
from repro_torch.core.gpu import GPU_PLATFORMS, GpuSpec, is_gpu
from repro_torch.core.tail_model import CtaWaveModel, cta_form, model_for
from repro_torch.kernels import matmul_tiled as mt
from repro_torch.launch import nas_scaleup, paper_card, platform_generality
from repro_torch.launch import staircase
from test_torch_recurrent import one_torch_thread  # noqa: F401

REL = 1e-12


def close(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b))


def detail(csv_row) -> str:
    return csv_row[2]


@pytest.fixture(scope="module")
def ref_stair():
    """The reference's Fig. 1/3 lines, CSV rows and printed stair counts."""
    import contextlib
    import io
    rows, buf = [], io.StringIO()
    with contextlib.redirect_stdout(buf):
        lines = jstair.run(rows, verbose=True)
    stairs = [int(s) for s in re.findall(r"stairs=(\d+)", buf.getvalue())]
    return lines, rows, stairs


# ---------------------------------------------------------------------------
# the TPU form against the reference scripts
# ---------------------------------------------------------------------------
def test_staircase_tpu_form_is_the_reference(ref_stair):
    lines, rows, stairs = ref_stair
    got = staircase.run(verbose=False, hw="tpu_v5e", device="cpu")
    assert len(got["lines"]) == len(lines) == len(stairs)
    for g, (arch, d_ff, q, waves, frac, util), n in zip(got["lines"], lines,
                                                        stairs):
        assert (g["arch"], g["d_ff"], g["q"], g["waves"], g["stairs"]) == \
            (arch, d_ff, q, waves, n)
        assert close(g["fill"], frac) and close(g["util"], util)
    assert detail(got["csv"]) == detail(rows[0])


def test_nas_scaleup_tpu_form_is_the_reference():
    rows = []
    want = jnas.run(rows, verbose=False)
    got = nas_scaleup.run(verbose=False, hw="tpu_v5e", device="cpu")
    assert len(got["rows"]) == len(want)
    for g, (arch, old, new, gain, iso) in zip(got["rows"], want):
        assert (g["arch"], g["old_widths"], g["new_widths"],
                g["iso_latency"]) == (arch, old, new, iso)
        assert close(g["gain"], gain)
    # the model's evaluation counts and the best gain
    assert detail(got["csv"]) == detail(rows[0])


def test_platform_generality_tpu_form_is_the_reference():
    rows = []
    want = jplat.run(rows, verbose=False)
    got = platform_generality.run_tpu(verbose=False, device="cpu")
    assert list(got["results"]) == list(want) == list(jplat.PLATFORMS)
    for name, res in got["results"].items():
        ref = want[name]
        assert res.new_widths == ref.new_widths
        assert res.old_widths == ref.old_widths
        assert close(res.latency_old_s, ref.latency_old_s)
        assert close(res.latency_new_s, ref.latency_new_s)
        assert res.params_new == ref.params_new
    assert detail(got["csv"]) == detail(rows[0])
    assert got["distinct"] == 3


def test_tunables_are_the_reference_s():
    """``nas_scaleup.arch_tunables`` at the reference's defaults."""
    for arch in list_archs():
        got = nas_scaleup.arch_tunables(get_config(arch))
        from repro.configs import get_config as jget_config
        want = jnas.arch_tunables(jget_config(arch))
        for g, w in zip(got, want, strict=True):
            assert dataclasses.asdict(g.layer) == {
                **dataclasses.asdict(w.layer), "experts": 1}
            np.testing.assert_array_equal(g.candidates, w.candidates)
            assert g.params_per_unit == w.params_per_unit


# ---------------------------------------------------------------------------
# the GPU form on H100_SXM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tokens", [8192, 512])
def test_staircase_gpu_waves_are_the_grid_over_the_sms(tokens):
    got = staircase.run(verbose=False, device="cpu", tokens=tokens)
    assert got["hw"] == "h100_sxm"
    for line in got["lines"]:
        cfg = get_config(line["arch"])
        b = mt.grid_blocks(tokens, line["d_ff"], cfg.d_model)
        assert line["waves"] == -(-b // 132), line
        assert line["q"] == 64
        assert close(line["fill"], b / (line["waves"] * 132))


def test_staircase_gpu_window_brackets_the_stair():
    """qwen's FFN at the planner's 512 tokens: 4 row tiles, so a stair is
    33 tiles (2112 columns); d_ff 2816 is 176 CTAs, two waves, and the
    card times 2112 .. 4288."""
    model = CtaWaveModel(H100_SXM)
    cfg = get_config("qwen1.5-0.5b")
    layer = staircase.ffn_layer("qwen1.5-0.5b", cfg, H100_SXM, 512)
    win = staircase.stair_window(model, layer)
    assert (win["lo"], win["hi"], win["past"]) == (2112, 4224, 4288)
    assert win["widths"][0] == 2112 and win["widths"][-1] == 4288
    waves = [model.waves(layer.with_width(int(n))) for n in win["widths"]]
    assert waves[0] == 1 and set(waves[1:-1]) == {2} and waves[-1] == 3
    # at 8192 tokens a stair is about two tiles; the window holds 8 each
    # side of d_ff
    layer = staircase.ffn_layer("qwen1.5-0.5b", cfg, H100_SXM, 8192)
    win = staircase.stair_window(model, layer)
    assert win["widths"][0] <= 2816 - 8 * 64
    assert win["widths"][-1] >= 2816 + 8 * 64
    assert win["lo"] < 2816 <= win["hi"] < win["past"]


@pytest.mark.parametrize("tokens", [8192, 512])
def test_table3_gpu_keeps_the_modeled_latency(tokens):
    got = nas_scaleup.run(verbose=False, device="cpu", tokens=tokens)
    model = CtaWaveModel(H100_SXM)
    for row in got["rows"]:
        assert row["iso_latency"]
        assert row["latency_new_us"] == row["latency_old_us"]
        cfg = get_config(row["arch"])
        for name, d_in in (("d_ff", cfg.d_model), ("attn_width",
                                                    cfg.d_model)):
            lat = [model.latency_batch(LayerShape(name, tokens=tokens,
                                                  d_in=d_in, width=w),
                                       [w])[0]
                   for w in (row["old_widths"][name],
                             row["new_widths"][name])]
            assert lat[0] == lat[1], (row["arch"], name)
            assert row["new_widths"][name] >= row["old_widths"][name]


def test_table3_gpu_grows_qwen_at_512_tokens():
    got = nas_scaleup.run(verbose=False, device="cpu", tokens=512,
                          archs=["qwen1.5-0.5b"])
    row = got["rows"][0]
    assert row["new_widths"] == {"d_ff": 4224, "attn_width": 1536}
    assert close(row["gain"], 0.5)


@pytest.mark.parametrize("tokens", [4096, 512])
def test_tables45_gpu_platforms_disagree(tokens):
    got = platform_generality.run(verbose=False, device="cpu",
                                  tokens=tokens)
    assert list(got["rows"]) == [h.name for h in GPU_PLATFORMS]
    assert got["distinct"] >= 2
    own = got["rows"]["h100_sxm"]
    # each plan is modeled on its own spec; the H100's own on the H100
    assert close(own["h100_us"], own["latency_new_us"])
    assert got["h100_rank"]["rank"] == 1
    for r in got["rows"].values():
        assert r["satisfied"] or r["reduction"] < 1 - platform_generality.DELTA
        assert all(w % 64 == 0 for w in r["widths"])


def test_tables45_gpu_at_512_tokens_cuts_more_with_more_sms():
    got = platform_generality.run(verbose=False, device="cpu", tokens=512)
    reds = [got["rows"][h.name]["reduction"] for h in GPU_PLATFORMS]
    assert reds == sorted(reds, reverse=True)
    assert close(got["rows"]["h100_sxm"]["reduction"],
                 1 - got["rows"]["h100_sxm"]["latency_new_us"]
                 / got["rows"]["h100_sxm"]["latency_old_us"])
    assert got["rows"]["h100_sxm"]["reduction"] > 0.15


# ---------------------------------------------------------------------------
# the kernel backend's plain version against the numpy engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec,tokens", [("h100_sxm", 8192),
                                         ("h100_sxm", 512),
                                         ("tpu_v5e", 8192)])
def test_kernel_backend_plans_equal_numpy(spec, tokens):
    """The fp64 plain version of each form's sweep kernel, the CPU's route
    of the kernel backend, gives the numpy engine's Table 3 plans and
    Fig. 1/3 waves and stairs."""
    hw = get_hardware(spec)
    exact = model_for(hw)
    kernel = model_for(hw, backend="kernel", device="cpu")
    tp = 1 if is_gpu(hw) else nas_scaleup.TP
    for arch in list_archs():
        cfg = get_config(arch)
        tls = nas_scaleup.arch_tunables(cfg, tokens=tokens, tp=tp, hw=hw)
        a = TailEffectOptimizer(exact).optimize_accuracy(tls)
        b = TailEffectOptimizer(kernel).optimize_accuracy(tls)
        assert a.new_widths == b.new_widths, arch
        layer = staircase.ffn_layer(arch, cfg, hw, tokens)
        widths = staircase.sweep_widths(layer, exact.width_quantum(
            layer.shard_out))
        ta = exact.evaluate_batch(layer, widths)
        tb = kernel.evaluate_batch(layer, widths)
        agree = staircase.tables_agree(tb, ta)
        assert agree["waves_equal"] and agree["max_rel_err"] == 0.0
        assert staircase.stair_line(arch, layer, exact, tb)["stairs"] == \
            staircase.stair_line(arch, layer, exact, ta)["stairs"]


@pytest.mark.parametrize("tokens", [4096, 512])
def test_kernel_backend_platform_plans_equal_numpy(tokens):
    for hw in GPU_PLATFORMS:
        tls = platform_generality.tunables(hw, tokens, 1)
        total = sum(tl.params(tl.layer.width) for tl in tls)
        plans = [platform_generality.plan_widths(
            TailEffectOptimizer(m).optimize_latency(
                tls, tau=0.1 * total, delta=0.95))
            for m in (model_for(hw),
                      model_for(hw, backend="kernel", device="cpu"))]
        assert plans[0] == plans[1], hw.name


# ---------------------------------------------------------------------------
# the GPU platforms
# ---------------------------------------------------------------------------
DATA_SHEET = {   # name: (SMs, peak FLOP/s, bytes/s, memory bytes)
    "h100_sxm": (132, 989e12, 3.35e12, 80 * 10**9),
    "h100_pcie": (114, 756e12, 2.0e12, 80 * 10**9),
    "a100_sxm4_80gb": (108, 312e12, 2.039e12, 80 * 10**9),
    "titan_v": (80, 14.9e12, 652.8e9, 12 * 10**9),
    "quadro_p6000": (30, 12.0e12, 432e9, 24 * 10**9),
    "jetson_nano": (1, 236e9, 25.6e9, 4 * 10**9),
}


@pytest.mark.parametrize("name", list(DATA_SHEET))
def test_gpu_spec_reaches_the_model_with_its_own_sms_and_peak(name):
    hw = get_hardware(name)
    assert hw in GPU_PLATFORMS and is_gpu(hw)
    assert (hw.cores_per_chip, hw.peak_flops_bf16, hw.hbm_bandwidth,
            hw.hbm_bytes) == DATA_SHEET[name]
    # the port's GEMM tile on every part
    assert (hw.lane, hw.sublane(16)) == (mt.BLOCK_N, mt.BLOCK_M)
    if name != "h100_sxm":
        base = GpuSpec()
        assert hw.vmem_bytes != base.vmem_bytes or name == "h100_pcie"
        assert hw.l2_bytes != base.l2_bytes or name == "h100_pcie"
    layer = LayerShape("l", tokens=4096, d_in=4096, width=11008)
    form = cta_form(hw, layer)
    assert form.slots == hw.cores_per_chip
    model = model_for(hw)
    assert isinstance(model, CtaWaveModel)
    waves = model.waves(layer)
    assert waves == -(-mt.grid_blocks(4096, 11008, 4096)
                      // hw.cores_per_chip)
    # compute-bound here on every part: waves x S x a tile's FLOPs / peak
    lat = model.latency_batch(layer, [11008])[0]
    assert close(lat, waves * (form.slots * form.tile_flops)
                 / hw.peak_flops_bf16)


def test_gpu_specs_are_distinct():
    names = [h.name for h in GPU_PLATFORMS]
    assert len(set(names)) == len(names) == 6
    assert len({h.cores_per_chip for h in GPU_PLATFORMS}) == 6
    assert GPU_PLATFORMS[0] is H100_SXM


# ---------------------------------------------------------------------------
# the CLIs' model side, and the card's helpers
# ---------------------------------------------------------------------------
def test_clis_on_the_cpu(capsys):
    out = staircase.main(["--device", "cpu", "--tokens", "512"])
    assert out["hw"] == "h100_sxm" and len(out["lines"]) == 10
    out = nas_scaleup.main(["--device", "cpu", "--hw", "tpu_v5e"])
    assert out["hw"] == "tpu_v5e"
    out = platform_generality.main(["--device", "cpu", "--form", "tpu"])
    assert out["distinct"] == 3
    printed = capsys.readouterr().out
    assert "not measured (device cpu)" in printed
    assert "staircase_fig1_3" in printed and "nas_scaleup_table3" in printed


def test_reps_scale_with_the_work():
    assert paper_card.reps_for(512, 1024, 2816) == paper_card.MAX_REPS
    assert paper_card.reps_for(8192, 12288, 33792) == 1
    assert 1 < paper_card.reps_for(4096, 4096, 1024) < paper_card.MAX_REPS


def test_held_product_on_the_cpu():
    """The card's operands are seeded, and ``held`` takes the plain version
    on the CPU: the same product twice, no difference."""
    import torch
    from repro_torch.core.profiler import bf16_operands
    x, w = bf16_operands(16, 32, 24, "cpu", seed=3)
    assert x.dtype == w.dtype == torch.bfloat16
    assert tuple(x.shape) == (16, 32) and tuple(w.shape) == (32, 24)
    assert torch.equal(bf16_operands(16, 32, 24, "cpu", seed=3)[1], w)
    h = paper_card.held(x, w)
    assert h["case"] == "M=16 K=32 N=24" and h["ok"]
    assert h["max_abs_err"] == 0.0 and h["tol"] > 0
