"""The port's chaos harness (``repro_torch.serving.chaos``) against
``repro``'s: schedules, reports and every injector's decisions bit-equal
for the same seeds; then the continuous engine's boundary transactions
(shrink, grow, swap rollback, reshape fault, retry exhaustion, seeded
faults under open-loop load) against ``repro``'s engine (CPU).
"""

import dataclasses

import numpy as np
import pytest

from repro.serving import Result as JResult
from repro.serving import chaos as jchaos
from repro_torch.models import transformer as tfm
from repro_torch.serving import Result
from repro_torch.serving import chaos as tchaos
from test_torch_continuous import (  # noqa: F401 — the model fixture
    Scripted, _hw, model, reqs_for, run_both, virtual)

LOADS = [dict(name="steady", rate_rps=50.0, duration_s=2.0, prompt_len=5,
              max_new_tokens=3, deadline_s=1.5),
         dict(name="spike", rate_rps=0.0, duration_s=2.0, burst_at=0.5,
              burst_n=16)]


# ---------------------------------------------------------------------------
# the harness, bit-equal to repro's
# ---------------------------------------------------------------------------
def arrival_rows(arrivals):
    return [(a.t, a.klass, a.request.prompt.tolist(),
             a.request.max_new_tokens, a.request.deadline_s)
            for a in arrivals]


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_open_loop_arrivals_bit_equal(seed):
    got = tchaos.open_loop_arrivals(
        [tchaos.TrafficLoad(**kw) for kw in LOADS], 256, seed=seed)
    want = jchaos.open_loop_arrivals(
        [jchaos.TrafficLoad(**kw) for kw in LOADS], 256, seed=seed)
    assert arrival_rows(got) == arrival_rows(want)
    assert sum(a.klass == "spike" for a in got) == 16


def test_schedule_errors_as_repro():
    late = dict(name="late", rate_rps=1.0, duration_s=1.0, burst_at=1.5,
                burst_n=4)
    same = [dict(name=n, rate_rps=0.0, duration_s=2.0, burst_at=0.5,
                 burst_n=8) for n in ("a", "b")]
    for loads, match in (([late], "outside its"), (same, "overlapping")):
        for ch in (tchaos, jchaos):
            with pytest.raises(ValueError, match=match):
                ch.open_loop_arrivals([ch.TrafficLoad(**kw) for kw in loads],
                                      256, seed=0)


def test_burst_requests_and_virtual_clock_as_repro():
    got = tchaos.burst_requests(256, n=5, prompt_len=7, max_new_tokens=3,
                                deadline_s=0.5, seed=4)
    want = jchaos.burst_requests(256, n=5, prompt_len=7, max_new_tokens=3,
                                 deadline_s=0.5, seed=4)
    assert [(r.prompt.tolist(), r.max_new_tokens, r.deadline_s)
            for r in got] == [(r.prompt.tolist(), r.max_new_tokens,
                               r.deadline_s) for r in want]
    clock = tchaos.VirtualClock(1.0)
    assert clock.advance(0.25) == 1.25 and clock() == 1.25
    with pytest.raises(ValueError, match="backwards"):
        clock.advance(-1e-9)


def _results(pkg_result):
    rng = np.random.default_rng(2)
    out = [pkg_result(tokens=np.zeros(2, np.int32), steps=2,
                      latency_s=float(x), retries=int(x * 10) % 2,
                      recovered=bool(int(x * 10) % 2))
           for x in rng.exponential(0.3, size=300)]
    out += [pkg_result(tokens=np.zeros(0, np.int32), steps=0, shed=True),
            pkg_result(tokens=np.zeros(0, np.int32), steps=0, failed=True)]
    return out


def test_tail_reports_bit_equal():
    got, want = _results(Result), _results(JResult)
    assert dataclasses.astuple(tchaos.TailReport.build("t", got)) == \
        dataclasses.astuple(jchaos.TailReport.build("t", want))
    empty = tchaos.TailReport.build("e", [])
    assert empty.completed == 0 and np.isnan(empty.p50_s)
    arr_t = tchaos.open_loop_arrivals(
        [tchaos.TrafficLoad(**kw) for kw in LOADS], 256, seed=1)
    arr_j = jchaos.open_loop_arrivals(
        [jchaos.TrafficLoad(**kw) for kw in LOADS], 256, seed=1)
    rep_t = tchaos.class_tail_reports(arr_t, got[:len(arr_t)])
    rep_j = jchaos.class_tail_reports(arr_j, want[:len(arr_j)])
    assert {k: dataclasses.astuple(v) for k, v in rep_t.items()} == \
        {k: dataclasses.astuple(v) for k, v in rep_j.items()}


def decisions(inj, calls, exc) -> list:
    out = []
    for args in calls:
        try:
            inj(*args)
            out.append(False)
        except exc as e:
            out.append(str(e))
    return out + [inj.calls, inj.injected]


@pytest.mark.parametrize("seed,rate", [(0, 0.3), (2, 0.5), (7, 1.0),
                                       (1, 0.0)])
def test_injector_decisions_bit_equal(seed, rate):
    swap_steps = [(s,) for s in ("begin", "materialize", "commit") * 20]
    compile_steps = [(s,) for s in ("lower", "compile", "lookup") * 20]
    for name, calls, kw in (
            ("SwapFailureInjector", swap_steps,
             {"steps": ("begin", "materialize")}),
            ("CompileFailureInjector", compile_steps,
             {"steps": ("lookup", "compile")}),
            ("ReshapeFailureInjector", [()] * 48, {}),
            ("ChunkFaultInjector", [()] * 48, {})):
        got = decisions(getattr(tchaos, name)(rate, seed=seed, **kw), calls,
                        tchaos.InjectedFault)
        want = decisions(getattr(jchaos, name)(rate, seed=seed, **kw),
                         calls, jchaos.InjectedFault)
        assert got == want, name
    for ch in (tchaos, jchaos):
        with pytest.raises(ValueError, match="unknown swap step"):
            ch.SwapFailureInjector(0.5, steps=("nope",))
        with pytest.raises(ValueError, match="unknown compile step"):
            ch.CompileFailureInjector(0.5, steps=("nope",))


def test_modeled_batch_cost_as_repro():
    plan = type("P", (), {"latency_s": 0.6, "baseline_latency_s": 1.5})()
    for overhead, slow in ((0.0, None), (0.002, lambda s: s * 3.0)):
        t = tchaos.modeled_batch_cost(1e-3, overhead_s=overhead, slow=slow)
        j = jchaos.modeled_batch_cost(1e-3, overhead_s=overhead, slow=slow)
        for p in (None, plan):
            for n in (1, 7, 640):
                assert t(p, n) == j(p, n)


# ---------------------------------------------------------------------------
# boundary transactions against repro's engine
# ---------------------------------------------------------------------------
def plans(S, sites):
    """A plan narrowing ``sites`` (half the FFN, or half the heads, as
    tests/test_continuous.py's ``_narrow_attn`` does) and the full one."""
    _, modules = S.sv.serving_templates(S.cfg, _hw(S), sites=sites)
    g = S.cfg.n_heads // max(S.cfg.n_kv_heads, 1)
    width = (S.cfg.d_ff // 2 if sites == ("mlp",)
             else max(S.cfg.n_heads // 2, g) * S.cfg.head_dim)
    narrow = S.sv.WidthPlan(
        traffic=S.sv.TrafficClass("burst", 96),
        widths={n: width for n in modules}, latency_s=0.6,
        baseline_latency_s=1.0, satisfied=True, modules=modules)
    return narrow, dataclasses.replace(narrow, widths={})


def boundary_engine(S, m, script, *, swapper_kw=None, **kw):
    params = S.params if S.jax else tfm.cast_params(S.params, "cpu")
    swapper = S.sv.WidthSwapper(params, S.cfg, **(swapper_kw or {}))
    args = dict(max_len=64, batch_slots=2, max_retries=3,
                boundary_every=2, boundary_cooldown=1000)
    args.update(kw)
    eng = S.sv.ContinuousServeEngine(
        params, S.cfg, **S.kw, swapper=swapper,
        admission=S.sv.AdmissionControl(max_queue_batches=100),
        degrader=Scripted(script), **virtual(S), **args)
    if m is not None:
        m.attach(eng)
    return eng


def test_reshape_fault_requeues_without_loss(model):
    def sc(S, m):
        narrow, _ = plans(S, ("mlp",))
        inj = S.ch.ReshapeFailureInjector(1.0, seed=0)
        eng = boundary_engine(S, m, [narrow],
                              swapper_kw={"reshape_fault_hook": inj})
        reqs = reqs_for(S, (6, 6), max_new=8)
        res = eng.run(reqs)
        assert inj.injected == 1
        assert eng.params_active is eng.swapper.full_params
        return [eng], reqs, res

    _, (tengs, tres) = run_both(model, sc)
    [ev] = [b for b in tengs[0].boundary_log if b.outcome == "reshape_failed"]
    assert ev.requeued == 2 and "InjectedFault" in ev.error
    assert all(r.recovered and r.retries == 1 and len(r.tokens) == 8
               for r in tres)


def test_swap_rollback_requeues_without_loss(model):
    def sc(S, m):
        narrow, _ = plans(S, ("mlp",))
        inj = S.ch.SwapFailureInjector(1.0, seed=0, steps=("materialize",))
        eng = boundary_engine(S, m, [narrow],
                              swapper_kw={"fault_hook": inj})
        reqs = reqs_for(S, (6, 6), max_new=8)
        return [eng], reqs, eng.run(reqs)

    _, (tengs, tres) = run_both(model, sc)
    assert tengs[0].swap_log[0].outcome == "rolled_back"
    assert [b.outcome for b in tengs[0].boundary_log] == ["swap_rolled_back"]
    assert all(r.recovered and len(r.tokens) == 8 for r in tres)


def test_retry_budget_exhaustion_fails_loudly(model):
    def sc(S, m):
        narrow, _ = plans(S, ("mlp",))
        inj = S.ch.ReshapeFailureInjector(1.0, seed=0)
        eng = boundary_engine(S, m, [narrow], max_retries=1,
                              boundary_cooldown=0,
                              swapper_kw={"reshape_fault_hook": inj})
        reqs = reqs_for(S, (6, 6), max_new=8)
        return [eng], reqs, eng.run(reqs)

    _, (tengs, tres) = run_both(model, sc, min_frac=0.0)
    led = tengs[0].ledger()
    assert led.complete and led.failed == 2 and led.finished == 0
    assert all(r.failed and r.retries == 2 for r in tres)


def test_shrink_boundary_carries_live_kv(model):
    """Half the heads while two requests decode and a third prefills in
    chunks: the live cache and the chunk checkpoint are reshaped, nothing
    requeues, tokens keep flowing."""
    def sc(S, m):
        narrow, _ = plans(S, ("attn",))
        eng = boundary_engine(S, m, [narrow], boundary_every=3,
                              batch_slots=3, prefill_chunk=4,
                              step_token_budget=6)
        reqs = reqs_for(S, (6, 6, 23), max_new=12)
        res = eng.run(reqs)
        return [eng], reqs, res

    _, (tengs, tres) = run_both(model, sc)
    oks = [b for b in tengs[0].boundary_log if b.outcome == "ok"]
    assert oks and all(b.requeued == 0 for b in oks)
    assert all(not r.retries and len(r.tokens) == 12 for r in tres)


def test_grow_boundary_requeues_instead_of_zero_history(model):
    def sc(S, m):
        narrow, full = plans(S, ("attn",))
        eng = boundary_engine(S, m, [narrow, narrow, full],
                              boundary_every=3)
        reqs = reqs_for(S, (6, 6), max_new=16)
        return [eng], reqs, eng.run(reqs)

    _, (tengs, tres) = run_both(model, sc)
    grows = [b for b in tengs[0].boundary_log
             if b.outcome == "requeued_grow"]
    assert grows and grows[0].requeued > 0
    assert all(len(r.tokens) == 16 for r in tres)
    assert any(r.recovered for r in tres)


def test_seeded_faults_under_open_loop_load(model):
    """Open-loop Poisson traffic and a spike, plans alternating at the
    boundaries, swap and reshape faults at seeded rates, chunked joins
    with seeded chunk faults, deadlines and admission: every outcome,
    log and ledger equal to repro's, and the drain ledger complete."""
    def sc(S, m):
        narrow, full = plans(S, ("mlp",))
        swap = S.ch.SwapFailureInjector(0.3, seed=1, steps=("begin",))
        resh = S.ch.ReshapeFailureInjector(0.3, seed=2)
        chunk = S.ch.ChunkFaultInjector(0.1, seed=3)
        eng = boundary_engine(
            S, m, [narrow, full] * 8,
            swapper_kw={"fault_hook": swap, "reshape_fault_hook": resh},
            batch_slots=3, boundary_every=4, boundary_cooldown=8,
            prefill_chunk=4, step_token_budget=9, chunk_fault_hook=chunk)
        loads = [S.ch.TrafficLoad("steady", rate_rps=30.0, duration_s=0.4,
                                  prompt_len=7, max_new_tokens=5,
                                  deadline_s=0.6),
                 S.ch.TrafficLoad("spike", rate_rps=0.0, duration_s=0.4,
                                  prompt_len=7, max_new_tokens=5,
                                  burst_at=0.1, burst_n=6)]
        arrivals = S.ch.open_loop_arrivals(loads, S.cfg.vocab_size, seed=5)
        res = eng.run(arrivals)
        led = eng.drain()
        assert led.complete and led.submitted == len(arrivals)
        assert swap.injected + resh.injected + chunk.injected > 0
        reports = S.ch.class_tail_reports(arrivals, res)
        eng.reports = {k: dataclasses.astuple(v) for k, v in reports.items()}
        return [eng], [a.request for a in arrivals], res

    (jengs, _), (tengs, _) = run_both(model, sc, min_frac=0.3)
    assert tengs[0].reports == jengs[0].reports
    assert any(b.outcome != "ok" for b in tengs[0].boundary_log)
