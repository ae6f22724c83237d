"""The port's degradation ladder and controller
(``repro_torch.serving.degradation``), the planner's ``tile_hw``
tie-break, and both engines' degrader hooks, against ``repro``'s on a TPU
spec (CPU).

The ladder's widths and the controller's shifts must equal ``repro``'s
exactly; predicted reductions within 1e-9 relative (the port plans on the
staircase kernel's fp64 plain version, ``tests/test_torch_planner.py``).
Engine runs go on virtual clocks with modeled batch costs, so shed sets,
levels, shift logs, ledgers and latencies must be equal exactly; greedy
tokens follow the margin rule of ``tests/test_torch_serve.py``.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import LayerShape as JLayerShape
from repro.core import TPU_V5E as J_HW
from repro.core import TunableLayer as JTunable
from repro.core import analytic_candidates as j_analytic
from repro.core.plan_address import plan_key as j_plan_key
from repro import serving as jserving
from repro_torch import serving as tserving
from repro_torch.core import (H100_SXM, TPU_V5E, LayerShape, TunableLayer,
                              analytic_candidates)
from repro_torch.core.plan_address import plan_key
from repro_torch.models import transformer as tfm
from test_torch_continuous import (  # noqa: F401 — the model fixture
    TOL, model, outcome, run_both, sides, virtual)
from test_torch_recurrent import one_torch_thread  # noqa: F401

REL = 1e-9


def side_pkg(jax_side: bool):
    """(serving package, hardware, LayerShape, TunableLayer, candidates,
    planner keyword arguments) of one side."""
    if jax_side:
        return (jserving, J_HW, JLayerShape, JTunable, j_analytic, {})
    return (tserving, TPU_V5E, LayerShape, TunableLayer, analytic_candidates,
            {"device": "cpu"})


def make_templates(jax_side: bool, n: int):
    """tests/test_width_planner.py's and tests/test_chaos.py's FFN stack
    templates, on one side."""
    _, hw, LS, TL, cands_fn, _ = side_pkg(jax_side)
    ref = LS("ref", tokens=4096, d_in=4096, width=26000, shard_out=16)
    cands = cands_fn(hw, ref, max_width=26000)
    return [TL(layer=LS(f"ffn{i}", tokens=4096, d_in=4096,
                        width=2048 * (i % 3 + 2) + 256, shard_out=16),
               candidates=cands, params_per_unit=4096) for i in range(n)]


def make_planner(jax_side: bool, n: int = 4, **kw):
    sv, hw, *_, pkw = side_pkg(jax_side)
    return sv.ServingWidthPlanner(hw, make_templates(jax_side, n), **pkw,
                                  **kw)


def both(fn):
    """fn(jax_side) on repro's side, then the port's."""
    return fn(True), fn(False)


def rung_rows(ladder):
    return [(r.level, {n: dict(p.widths) for n, p in r.plans.items()})
            for r in ladder.rungs]


def assert_same_ladders(jl, tl):
    assert rung_rows(tl) == rung_rows(jl)
    for jr, tr in zip(jl.rungs, tl.rungs):
        assert tr.reduction == pytest.approx(jr.reduction, rel=REL, abs=0)
        for name in jr.plans:
            assert tr.plans[name].latency_reduction == pytest.approx(
                jr.plans[name].latency_reduction, rel=REL, abs=1e-15)


def shifts(ctl):
    return [dataclasses.astuple(s) for s in ctl.shift_log]


# ---------------------------------------------------------------------------
# the planner's tile_hw tie-break (tests/test_width_planner.py:225-295)
# ---------------------------------------------------------------------------
TAIL_FREE_W, TAIL_HEAVY_W = 4096, 4104


def hand_plan(sv, name, width):
    return sv.WidthPlan(traffic=sv.TrafficClass(name, 4096),
                        widths={"ffn0": width}, latency_s=1.0,
                        baseline_latency_s=2.0, satisfied=True, modules={})


def hand_planner(jax_side, names_widths, **kw):
    sv = side_pkg(jax_side)[0]
    planner = make_planner(jax_side, n=1, **kw)
    for name, w in names_widths:
        planner.plans[name] = hand_plan(sv, name, w)
    return planner


class WarmStub:
    """A compile-cache stand-in: the warm-plan registry alone."""

    def __init__(self, key):
        self.key, self.warm = key, set()

    def mark(self, plan):
        self.warm.add(self.key(plan.widths))

    def plan_is_warm(self, plan):
        return self.key(plan.widths) in self.warm


@pytest.mark.parametrize("order", [("heavy", "free"), ("free", "heavy")])
def test_tile_hw_tie_goes_to_the_tail_free_plan(order):
    widths = {"free": TAIL_FREE_W, "heavy": TAIL_HEAVY_W}

    def run(js):
        hw = side_pkg(js)[1]
        p = hand_planner(js, [(n, widths[n]) for n in order], tile_hw=hw)
        return (p.plan_tail_free(p.plans["free"]),
                p.plan_tail_free(p.plans["heavy"]),
                p.select(4096).traffic.name)

    j, t = both(run)
    assert t == j == (True, False, "free")


def test_without_tile_hw_the_first_planned_class_wins():
    def run(js):
        p = hand_planner(js, [("heavy", TAIL_HEAVY_W),
                              ("free", TAIL_FREE_W)])
        return p.select(4096).traffic.name, \
            p.plan_tail_free(p.plans["heavy"]), p.tile_hw

    j, t = both(run)
    assert t == j == ("heavy", True, None)


def test_tile_hw_warm_plan_breaks_the_remaining_tie():
    def run(js):
        stub = WarmStub(j_plan_key if js else plan_key)
        p = hand_planner(js, [("cold", TAIL_FREE_W), ("warm", 5120)],
                         tile_hw=side_pkg(js)[1], compile_cache=stub)
        stub.mark(p.plans["warm"])
        return (p.plan_tail_free(p.plans["cold"]),
                p.plan_tail_free(p.plans["warm"]),
                p.select(4096).traffic.name)

    j, t = both(run)
    assert t == j == (True, True, "warm")


def test_tile_hw_skips_unknown_layers():
    def run(js):
        sv = side_pkg(js)[0]
        p = hand_planner(js, [], tile_hw=side_pkg(js)[1])
        ghost = sv.WidthPlan(traffic=sv.TrafficClass("g", 4096),
                             widths={"nope": 123}, latency_s=1.0,
                             baseline_latency_s=2.0, satisfied=True,
                             modules={})
        return p.plan_tail_free(ghost)

    assert both(run) == (True, True)


def test_ladder_build_with_tile_hw_restores_the_planners():
    """``build(tile_hw=)`` ranks equal-reduction rungs tail-free first and
    leaves the planner's own ``tile_hw`` as it was (None, or a spec)."""
    def run(js):
        sv, hw = side_pkg(js)[:2]
        out = []
        for own in (None, hw):
            planner = make_planner(js, n=6, tile_hw=own)
            traffic = [sv.TrafficClass("burst", 4096)]
            planner.plan(traffic)
            ladder = sv.DegradationLadder.build(planner, traffic,
                                                deltas=(0.85, 0.7),
                                                tile_hw=hw)
            assert planner.tile_hw is own
            out.append(ladder)
        return out

    (j0, j1), (t0, t1) = both(run)
    for jl, tl in ((j0, t0), (j1, t1)):
        assert len(tl) == 3
        assert_same_ladders(jl, tl)
        reds = [r.reduction for r in tl.rungs]
        assert reds == sorted(reds)


def test_gpu_tile_hw_on_the_planners_plans():
    """On ``H100_SXM`` the tie-break scores the port's CUDA tiles: the
    long class's plan (three FFNs at 2112, the rest at 2816) is not
    tail-free (2816 leaves a partial wave on every tile), a plan of only
    its cut widths is, and ``select`` keeps the nearest class."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen1.5-0.5b")
    tpl, mods = tserving.serving_templates(cfg, H100_SXM, tokens=512)
    planner = tserving.ServingWidthPlanner(H100_SXM, tpl, modules=mods,
                                           device="cpu", tile_hw=H100_SXM)
    plans = planner.plan([tserving.TrafficClass("short", 128),
                          tserving.TrafficClass("long", 512)])
    long = plans["long"]
    cut = {n: w for n, w in long.widths.items() if w < cfg.d_ff}
    assert cut and set(cut.values()) == {2112}
    assert not planner.plan_tail_free(long)
    assert planner.plan_tail_free(dataclasses.replace(long, widths=cut))
    assert planner.select(512) is long and planner.select(100) is \
        plans["short"]


# ---------------------------------------------------------------------------
# the ladder and the controller (tests/test_chaos.py:218-300)
# ---------------------------------------------------------------------------
TRAFFIC = (("decode", 256), ("prefill", 65536))


def ladder(js, deltas, **kw):
    sv = side_pkg(js)[0]
    traffic = [sv.TrafficClass(n, t) for n, t in TRAFFIC]
    return sv.DegradationLadder.build(make_planner(js), traffic,
                                      deltas=deltas, **kw)


@pytest.mark.parametrize("deltas", [(0.6, 0.9), (0.8, 0.6), (0.8,)])
def test_ladder_rungs_equal_repro(deltas):
    jl, tl = both(lambda js: ladder(js, deltas))
    assert_same_ladders(jl, tl)
    assert len(tl) == len(deltas) + 1
    assert all(p.widths == {} for p in tl.rung(0).plans.values())
    assert [r.reduction for r in tl.rungs] == sorted(
        r.reduction for r in tl.rungs)
    assert tl.rung(99) is tl.rungs[-1] and tl.rung(-1) is tl.rungs[0]
    assert tl.rung(0).plan_for(100).traffic.name == "decode"
    assert tl.rung(0).plan_for(10 ** 6).traffic.name == "prefill"


SIGNALS = [1.5, 1.5, 0.7, 1.5, 2.0, 2.0, 0.1, 0.1, 0.1, 0.1, 0.8, 0.1, 0.1,
           0.1, 0.1, 0.1, 0.1, 1.2, 1.2, 0.2]


@pytest.mark.parametrize("kw", [
    dict(down_patience=2, up_patience=3),
    dict(down_patience=1, up_patience=2, observe_every=2),
    dict(down_threshold=1.4, up_threshold=0.15, down_patience=1,
         up_patience=1)])
def test_controller_shifts_equal_repro(kw):
    """The same signal sequence gives the same levels, shift log, pins and
    selected plans in both."""
    def run(js):
        sv = side_pkg(js)[0]
        ctl = sv.DegradationController(ladder(js, (0.8, 0.6)), **kw)
        levels, picks = [], []
        for i, s in enumerate(SIGNALS):
            levels.append(ctl.observe(s))
            if i == 8:
                ctl.pin_floor(2)
            if i == 12:
                ctl.release_floor()
            levels.append(ctl.effective_level)
            picks.append(dict(ctl.select(256).widths))
        ctl.release_floor()            # none left: a no-op
        return levels, shifts(ctl), picks

    j, t = both(run)
    assert t[0] == j[0] and t[2] == j[2]
    assert t[1] == j[1] and any(s[0] == "down" for s in t[1])


def test_controller_refuses_what_repro_refuses():
    for js in (True, False):
        sv = side_pkg(js)[0]
        with pytest.raises(ValueError, match="hysteresis"):
            sv.DegradationController(ladder(js, (0.8,)), down_threshold=0.5,
                                     up_threshold=0.5)
        with pytest.raises(ValueError, match="traffic"):
            sv.DegradationLadder.build(make_planner(js), [])
        with pytest.raises(ValueError, match="empty"):
            sv.DegradationLadder([])


# ---------------------------------------------------------------------------
# the engines' degrader hooks on virtual clocks
# ---------------------------------------------------------------------------
def serving_ladder(S, deltas=(0.8, 0.6)):
    """tests/test_chaos.py's stack: the MLP templates of the reduced qwen
    at 96 tokens, one traffic class, a ladder of len(deltas) + 1 rungs."""
    hw, pkw = side_pkg(S.jax)[1], side_pkg(S.jax)[5]
    templates, modules = S.sv.serving_templates(S.cfg, hw, tokens=96,
                                                sites=("mlp",))
    planner = S.sv.ServingWidthPlanner(hw, templates, modules=modules, **pkw)
    traffic = [S.sv.TrafficClass("burst", 96)]
    planner.plan(traffic)
    return planner, S.sv.DegradationLadder.build(planner, traffic,
                                                 deltas=deltas)


class StaticMargins:
    """Records, as ``repro``'s static engine runs, the top-2 margin of the
    logits each greedy token was taken from, keyed by (request, token
    index), and the largest |logit|."""

    def __init__(self, eng, vocab):
        self.v, self.margin, self.scale = vocab, {}, 0.0
        gen, prefill, decode = eng._generate_batch, eng._prefill, \
            eng._decode
        state = {"reqs": [], "k": 0}

        def note(rows):
            rows = np.asarray(rows, np.float32)[:, :self.v]
            top2 = np.sort(rows, axis=-1)[:, -2:]
            for r, m in zip(state["reqs"], top2[:, 1] - top2[:, 0]):
                self.margin[(id(r), state["k"])] = float(m)
            self.scale = max(self.scale, float(np.abs(rows).max()))
            state["k"] += 1

        def rec_gen(reqs):
            state["reqs"], state["k"] = list(reqs), 0
            return gen(reqs)

        def rec_prefill(p, toks):
            out = prefill(p, toks)
            note(out[0][:, -1])
            return out

        def rec_decode(p, t, pos, st):
            out = decode(p, t, pos, st)
            note(out[0])
            return out

        eng._generate_batch, eng._prefill, eng._decode = (
            rec_gen, rec_prefill, rec_decode)

    def check(self, reqs, jres, tres, min_frac=0.5) -> None:
        tol = TOL * self.scale
        compared = total = 0
        for req, j, t in zip(reqs, jres, tres):
            assert len(t.tokens) == len(j.tokens)
            total += len(j.tokens)
            for k in range(len(j.tokens)):
                if not np.array_equal(t.tokens[:k], j.tokens[:k]):
                    break
                if self.margin[(id(req), k)] > 2 * tol:
                    assert t.tokens[k] == j.tokens[k], (k, j.tokens,
                                                        t.tokens)
                    compared += 1
        assert compared >= min_frac * total, (compared, total)


def static_burst(S, *, degrade=True, fail_rate=0.2):
    """tests/test_chaos.py's burst scenario at half its size: 24 requests
    of 16 tokens (6 batches against a 3-batch queue cap, deadlines of 0.6
    s, seeded stragglers and swap faults), then light traffic. The
    stragglers are drawn here, the same on both sides (the port's chaos
    module has no ``SlowBatchInjector`` yet)."""
    planner, lad = serving_ladder(S)
    clock = S.ch.VirtualClock()
    rng = np.random.default_rng(11)

    def slow(base_s):
        """Seeded stragglers: a quarter of the batches 0.05 s slower."""
        return base_s + 0.05 if rng.random() < 0.25 else base_s

    injector = S.ch.SwapFailureInjector(fail_rate, seed=1, steps=("begin",))
    admission = S.sv.AdmissionControl(max_queue_batches=3,
                                      target_batch_s=0.25, ewma_alpha=0.5,
                                      headroom=2.0)
    params = S.params if S.jax else tfm.cast_params(S.params, "cpu")
    kw = {}
    if degrade:
        kw = dict(planner=planner,
                  swapper=S.sv.WidthSwapper(params, S.cfg,
                                            fault_hook=injector),
                  degrader=S.sv.DegradationController(
                      lad, down_threshold=1.0, up_threshold=0.5,
                      down_patience=1, up_patience=2))
    eng = S.sv.ServeEngine(
        params, S.cfg, **S.kw, max_len=48, batch_slots=4,
        admission=admission, clock=clock,
        batch_cost_fn=S.ch.modeled_batch_cost(1e-3, overhead_s=0.01,
                                              slow=slow), **kw)
    margins = StaticMargins(eng, S.cfg.vocab_size) if S.jax else None
    burst = S.ch.burst_requests(S.cfg.vocab_size, n=24, prompt_len=16,
                                max_new_tokens=8, deadline_s=0.6, seed=3)
    light = S.ch.burst_requests(S.cfg.vocab_size, n=2, prompt_len=16,
                                max_new_tokens=8, seed=4)
    reqs, res = list(burst), list(eng.generate(burst))
    for _ in range(4):
        reqs += light
        res += eng.generate(light)
    return eng, injector, reqs, res, margins


def static_rows(eng, res):
    return ([outcome(r) for r in res],
            [(b.tokens, b.latency_s, b.plan_name, b.level, b.signal)
             for b in eng.batch_log],
            [p.traffic.name for p in eng.plan_log],
            [(e.outcome, e.realized, e.masked) for e in eng.swap_log])


def test_static_engine_degrades_as_repro_does(model):
    """``ServeEngine`` with ``AdmissionControl`` and a real
    ``DegradationController`` under a burst with swap faults: the same
    shed set, levels per batch, shift log, swaps and latencies as
    ``repro``'s engine, tokens under the margin rule; it downshifts, serves
    narrowed widths, and is back at full width once the burst passed."""
    jc, tc, host = model
    j, t = sides(jc, tc, host)
    jeng, jinj, jreqs, jres, margins = static_burst(j)
    teng, tinj, _, tres, _ = static_burst(t)
    assert static_rows(teng, tres) == static_rows(jeng, jres)
    assert shifts(teng.degrader) == shifts(jeng.degrader)
    assert tinj.injected == jinj.injected >= 1
    assert any(r.shed for r in tres) and not all(r.shed for r in tres)
    downs = [s for s in teng.degrader.shift_log if s.direction == "down"]
    ups = [s for s in teng.degrader.shift_log if s.direction == "up"]
    assert downs and len(ups) == len(downs)
    assert max(b.level for b in teng.batch_log) >= 1
    assert teng.batch_log[-1].level == 0 and teng.degrader.level == 0
    assert any(e.outcome == "ok" and e.realized and
               min(w for _, w in e.realized) < tc.d_ff
               for e in teng.swap_log)
    margins.check([r for r, x in zip(jreqs, jres) if not x.shed],
                  [x for x in jres if not x.shed],
                  [x for x in tres if not x.shed])


def test_static_engine_without_a_degrader_logs_level_minus_one(model):
    jc, tc, host = model
    _, t = sides(jc, tc, host)
    eng, *_ = static_burst(t, degrade=False)
    assert {b.level for b in eng.batch_log} == {-1}
    assert eng.degrader is None


def test_static_degrader_needs_admission(model):
    jc, tc, host = model
    for S in sides(jc, tc, host):
        _, lad = serving_ladder(S)
        with pytest.raises(ValueError, match="AdmissionControl"):
            S.sv.ServeEngine(S.params, S.cfg, **S.kw,
                             degrader=S.sv.DegradationController(lad))


def test_continuous_engine_degrades_as_repro_does(model):
    """The continuous engine with a real ``DegradationController``
    (tests/test_continuous.py:484's open loop, smaller): a Poisson stream
    and a spike, swap and reshape faults, the controller observing every
    4th step. Ledgers, boundary logs, outcomes and shift logs equal
    ``repro``'s; it downshifts under the spike."""
    def sc(S, m):
        planner, lad = serving_ladder(S)
        params = S.params if S.jax else tfm.cast_params(S.params, "cpu")
        swap = S.ch.SwapFailureInjector(0.3, seed=1, steps=("begin",))
        resh = S.ch.ReshapeFailureInjector(0.3, seed=2)
        swapper = S.sv.WidthSwapper(params, S.cfg, fault_hook=swap,
                                    reshape_fault_hook=resh)
        eng = S.sv.ContinuousServeEngine(
            params, S.cfg, **S.kw, max_len=48, batch_slots=4,
            planner=planner,
            swapper=swapper,
            admission=S.sv.AdmissionControl(max_queue_batches=3,
                                            target_batch_s=0.25,
                                            ewma_alpha=0.5, headroom=2.0),
            degrader=S.sv.DegradationController(
                lad, down_threshold=1.0, up_threshold=0.5,
                down_patience=4, up_patience=8, observe_every=4),
            max_retries=3, boundary_every=4, boundary_cooldown=8,
            **virtual(S, cost=1e-3))
        if m is not None:
            m.attach(eng)
        loads = [S.ch.TrafficLoad("steady", rate_rps=40.0, duration_s=0.5,
                                  prompt_len=8, max_new_tokens=6,
                                  deadline_s=2.0),
                 S.ch.TrafficLoad("spike", rate_rps=0.0, duration_s=0.5,
                                  prompt_len=8, max_new_tokens=6,
                                  deadline_s=2.0, burst_at=0.1,
                                  burst_n=24)]
        arrivals = S.ch.open_loop_arrivals(loads, S.cfg.vocab_size, seed=5)
        res = eng.run(arrivals)
        led = eng.drain()
        assert led.complete and led.submitted == len(arrivals)
        return [eng], [a.request for a in arrivals], res

    (jengs, _), (tengs, tres) = run_both(model, sc, min_frac=0.3)
    assert shifts(tengs[0].degrader) == shifts(jengs[0].degrader)
    assert any(s.direction == "down" for s in tengs[0].degrader.shift_log)
    assert tengs[0].ledger().failed == 0
