"""The resilient serving CLI (``repro_torch.launch.serve_resilient``) on the
CPU: ``--scenario burst`` against examples/serve_resilient.py run through
``repro``'s own engine, and the fleet scenario unhedged, hedged, cached and
with a crash. Kept apart from ``test_torch_chaos.py`` so that pytest-xdist's
``--dist loadfile`` can put these slow cases on a worker of their own."""

import dataclasses

import pytest

from repro import serving as jserving
from repro.serving import chaos as jchaos
from test_torch_recurrent import one_torch_thread  # noqa: F401


def repro_example_burst():
    """examples/serve_resilient.py's three LoadReports, its shift log and
    its level after the lull, run through the example's own engine."""
    import importlib.util
    from pathlib import Path

    import jax
    from repro.configs import get_config as jget, reduced_config as jred
    from repro.core import TPU_V5E as J_HW
    from repro.models import init_params as jinit

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "serve_resilient.py"
    spec = importlib.util.spec_from_file_location("_serve_resilient", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    cfg = jred(jget("qwen1.5-0.5b"), d_model=128, n_layers=2, d_ff=576)
    params = jinit(jax.random.PRNGKey(0), cfg)
    templates, modules = jserving.serving_templates(cfg, J_HW, tokens=96,
                                                    sites=("mlp",))
    planner = jserving.ServingWidthPlanner(J_HW, templates, modules=modules)
    traffic = [jserving.TrafficClass("burst", 96)]
    planner.plan(traffic)
    ladder = jserving.DegradationLadder.build(planner, traffic,
                                              deltas=(0.8, 0.6))
    eng, inj = ex.build_engine(cfg, params, planner, ladder, degrade=True)
    tight = jchaos.LoadReport.from_results(eng.generate(jchaos.burst_requests(
        cfg.vocab_size, n=ex.BURST_N, prompt_len=16, max_new_tokens=8,
        deadline_s=0.6, seed=3)))
    light = jchaos.burst_requests(cfg.vocab_size, n=2, prompt_len=16,
                                  max_new_tokens=8, seed=4)
    for _ in range(6):
        eng.generate(light)
    shifts = [(s.direction, s.level, s.batch_index)
              for s in eng.degrader.shift_log]
    relaxed = jchaos.burst_requests(cfg.vocab_size, n=ex.BURST_N,
                                    prompt_len=16, max_new_tokens=8,
                                    deadline_s=100.0, seed=3)
    full, deg = (jchaos.LoadReport.from_results(ex.build_engine(
        cfg, params, planner, ladder, degrade=d)[0].generate(relaxed))
        for d in (False, True))
    return {"tight": tight, "full": full, "degraded": deg, "shifts": shifts,
            "level_after": eng.degrader.level, "injected": inj.injected,
            "ladder": ladder}


def test_cli_burst_matches_the_example(capsys):
    """``--scenario burst`` on the CPU: the ladder, every LoadReport, the
    shifts and the injected rollbacks of examples/serve_resilient.py (the
    virtual clock sets them; the weights differ)."""
    from repro_torch.launch.serve_resilient import main as cli_main
    out = cli_main(["--device", "cpu", "--reduced", "--scenario", "burst"])
    want = repro_example_burst()
    for k in ("tight", "full", "degraded"):
        assert dataclasses.astuple(out[k]) == dataclasses.astuple(want[k]), k
    assert out["shifts"] == want["shifts"]
    assert out["level_after"] == want["level_after"] == 0
    assert out["injected"] == want["injected"] >= 1
    assert [(r.level, sorted({w for p in r.plans.values()
                              for w in p.widths.values()}))
            for r in out["ladder"].rungs] == \
        [(r.level, sorted({w for p in r.plans.values()
                           for w in p.widths.values()}))
         for r in want["ladder"].rungs]
    assert out["tight"].deadline_missed == 0
    assert out["degraded"].p99_s < out["full"].p99_s
    text = capsys.readouterr().out
    assert "4x burst, 0.6s deadlines" in text and "no shedding" in text


@pytest.mark.parametrize("args", [
    ["--hedge", "none"], ["--hedge", "0", "--cached"],
    ["--hedge", "1", "--cached", "--crash-at", "2"]])
def test_cli_fleet_runs_on_cpu(capsys, args):
    from repro_torch.launch.serve_resilient import main as cli_main
    out = cli_main(["--device", "cpu", "--reduced", "--requests", "16",
                    *args])
    led = out["ledger"]
    assert led.complete and led.finished == 16 and led.failed == 0
    assert (led.hedged > 0) == (args[1] != "none")
    text = capsys.readouterr().out
    assert "router ledger 16 submitted = 16 finished" in text
    assert "p99.9" in text and "health log" in text
    if "--cached" in args:
        assert "'misses': 0" in text
    if args[1] == "1":
        assert "ladder at 4 tokens: rung 1 modeled -" in text
    if "--crash-at" in args:
        [ev] = out["router"].health_log
        assert ev.replica == "r0" and "InjectedFault" in ev.reason
        assert led.migrated >= 1
