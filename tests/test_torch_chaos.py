"""The port's chaos harness (``repro_torch.serving.chaos``) against
``repro``'s: schedules, reports and every injector's decisions bit-equal
for the same seeds; then the continuous engine's boundary transactions
(shrink, grow, swap rollback, reshape fault, retry exhaustion, seeded
faults under open-loop load) against ``repro``'s engine (CPU).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.serving import Result as JResult
from repro.serving import chaos as jchaos
from repro_torch import serving as tserving
from repro_torch.models import transformer as tfm
from repro_torch.serving import Result
from repro_torch.serving import chaos as tchaos
from test_torch_continuous import (  # noqa: F401 — the model fixture
    Scripted, _hw, model, port_side, reqs_for, run_both, virtual)
from test_torch_recurrent import one_torch_thread  # noqa: F401

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


# ---------------------------------------------------------------------------
# the fleet's injectors, reports and the table cache's corruptor
# ---------------------------------------------------------------------------
def cost_trace(inj, n=48) -> list:
    """An injector wrapping batch costs, called ``n`` times: each cost or
    the fault's message, then its counters."""
    out = []
    for i in range(n):
        try:
            out.append(inj(1e-3 * (i + 1)))
        except (tchaos.InjectedFault, jchaos.InjectedFault) as e:
            out.append(f"{type(e).__name__}: {e}")
    return out + [getattr(inj, "calls", None), inj.injected]


@pytest.mark.parametrize("seed,rate", [(0, 0.3), (2, 0.5), (7, 1.0),
                                       (1, 0.0)])
def test_straggler_and_replica_injectors_bit_equal(seed, rate):
    for name, args, kw in (
            ("SlowBatchInjector", (rate, 0.25), {}),
            ("ReplicaStallInjector", (4.0,),
             {"start_step": 3, "n_steps": 20, "rate": rate}),
            ("ReplicaStallInjector", (8.0,), {}),
            ("ReplicaCrashInjector", (), {"at_step": 5, "rate": rate / 5}),
            ("ReplicaCrashInjector", (), {"rate": rate})):
        got = cost_trace(getattr(tchaos, name)(*args, seed=seed, **kw))
        want = cost_trace(getattr(jchaos, name)(*args, seed=seed, **kw))
        assert got == want, name
    for ch in (tchaos, jchaos):
        with pytest.raises(ValueError, match="stall factor"):
            ch.ReplicaStallInjector(0.5)


def test_load_report_bit_equal():
    got, want = _results(Result), _results(JResult)
    for rs in (got, want):
        for r in rs[::7]:
            r.deadline_missed = True
    assert dataclasses.astuple(tchaos.LoadReport.from_results(got)) == \
        dataclasses.astuple(jchaos.LoadReport.from_results(want))
    shed = [Result(tokens=np.zeros(0, np.int32), steps=0, shed=True)] * 3
    assert dataclasses.astuple(tchaos.LoadReport.from_results(shed))[:3] \
        == (0, 3, 0)


def test_cache_corruptor_hits_as_repro_and_quarantines(tmp_path):
    """Six table entries on each side; the same seed strikes the same
    positions of the sorted entries, and the port's cache quarantines
    exactly those (tests/test_chaos.py's partial corruption)."""
    from repro.core import LayerShape as JLayerShape
    from repro.core import TPU_V5E as J_HW
    from repro.core.table_cache import ProfileTableCache as JCache
    from repro_torch.core import TPU_V5E, LayerShape
    from repro_torch.core.table_cache import ProfileTableCache

    def fill(Cache, LS, hw, root):
        cache = Cache(root)
        layers = [LS(f"l{i}", tokens=64 * (i + 1), d_in=64, width=100)
                  for i in range(6)]
        for i, layer in enumerate(layers):
            cache.put(hw, layer, np.array([128, 256]),
                      {"latency_s": np.array([1.0, 2.0 + i])})
        return layers

    sides = {}
    for tag, Cache, LS, hw, ch in (("t", ProfileTableCache, LayerShape,
                                    TPU_V5E, tchaos),
                                   ("j", JCache, JLayerShape, J_HW, jchaos)):
        root = tmp_path / tag
        layers = fill(Cache, LS, hw, root)
        files = sorted(Cache(root).root.glob("??/*.npz"))
        assert len(files) == 6
        hit = ch.CacheCorruptor(Cache(root), rate=0.5, seed=1).strike()
        cache = Cache(root)
        got = [cache.get(hw, layer, np.array([128, 256]))
               for layer in layers]
        sides[tag] = ([files.index(p) for p in hit],
                      sum(g is None for g in got), cache.stats.corrupted,
                      len(cache.quarantined()))
    assert sides["t"] == sides["j"]
    positions, missed, corrupted, quarantined = sides["t"]
    assert 0 < len(positions) < 6
    assert missed == corrupted == quarantined == len(positions)


# ---------------------------------------------------------------------------
# the planner's telemetry and the hedge policy
# ---------------------------------------------------------------------------
def telemetry_planners():
    from repro.core import TPU_V5E as J_HW
    from repro_torch.core import TPU_V5E
    return (tserving.ServingWidthPlanner(TPU_V5E, [], device="cpu"),
            jserving.ServingWidthPlanner(J_HW, []))


def test_planner_telemetry_as_repro():
    tp, jp = telemetry_planners()
    assert tp.telemetry_window == jp.telemetry_window == 4096
    for p in (tp, jp):
        assert p.observed_percentile("a", 95) is None
    rng = np.random.default_rng(4)
    for x in rng.exponential(0.2, size=5000):
        for p in (tp, jp):
            p.record("a", x)
    for x in rng.exponential(0.5, size=7):
        for p in (tp, jp):
            p.record("b", x)
    assert tp.telemetry == jp.telemetry and len(tp.telemetry["a"]) == 4096
    for cls in ("a", "b"):
        for q in (-5.0, 0.0, 50.0, 95.0, 99.9, 100.0, 150.0):
            assert tp.observed_percentile(cls, q) == \
                jp.observed_percentile(cls, q)
    assert tp.observed_percentile("c", 50) is None


def test_continuous_run_records_latencies_as_repro(model):
    """With a planner, each finished request's latency is recorded under
    its class (or "default"): the same samples as repro's engine."""
    from test_torch_degradation import serving_ladder

    def sc(S, m):
        planner, _ = serving_ladder(S)
        eng = S.sv.ContinuousServeEngine(
            S.params, S.cfg, **S.kw, max_len=48, batch_slots=3,
            planner=planner, **virtual(S))
        if m is not None:
            m.attach(eng)
        loads = [S.ch.TrafficLoad(**kw) for kw in (
            dict(name="steady", rate_rps=40.0, duration_s=0.3,
                 prompt_len=7, max_new_tokens=4),
            dict(name="spike", rate_rps=0.0, duration_s=0.3, burst_at=0.1,
                 burst_n=4, prompt_len=5, max_new_tokens=3))]
        arrivals = S.ch.open_loop_arrivals(loads, S.cfg.vocab_size, seed=2)
        bare = reqs_for(S, (6, 4), max_new=3, seed=9)
        res = eng.run(arrivals + bare)
        return [eng], [a.request for a in arrivals] + bare, res

    (jengs, _), (tengs, _) = run_both(model, sc, min_frac=0.3)
    got, want = tengs[0].planner.telemetry, jengs[0].planner.telemetry
    assert got == want and set(got) == {"steady", "spike", "default"}


def test_hedge_policy_as_repro():
    tp, jp = telemetry_planners()
    for x in np.random.default_rng(1).exponential(0.05, size=40):
        tp.record("small", x)
        jp.record("small", x)
    for kw in (dict(), dict(quantile=50.0, min_delay_s=0.02),
               dict(quantile=99.9, default_delay_s=0.01, rung=0,
                    max_outstanding=1, hedge_deadline_only=True)):
        tpol, jpol = tserving.HedgePolicy(**kw), jserving.HedgePolicy(**kw)
        for klass in ("small", "", "other"):
            for tpl, jpl in ((tp, jp), (None, None)):
                delay = tpol.hedge_delay(tpl, klass)
                assert delay == jpol.hedge_delay(jpl, klass)
                for elapsed in (0.0, delay * 0.5, delay, delay * 3):
                    for out in (0, 1, 4):
                        for dl in (None, 1.0):
                            args = dict(elapsed_s=elapsed, delay_s=delay,
                                        outstanding=out)
                            assert tpol.should_hedge(
                                **args, request=tserving.Request(
                                    prompt=np.zeros(2, np.int32),
                                    deadline_s=dl)) == jpol.should_hedge(
                                **args, request=jserving.Request(
                                    prompt=np.zeros(2, np.int32),
                                    deadline_s=dl))
    for bad, match in ((dict(quantile=0.0), "quantile"),
                       (dict(quantile=100.5), "quantile"),
                       (dict(rung=-1), "rung"),
                       (dict(max_outstanding=0), "max_outstanding")):
        for sv in (tserving, jserving):
            with pytest.raises(ValueError, match=match):
                sv.HedgePolicy(**bad)


# ---------------------------------------------------------------------------
# the router's device-fault rule
# ---------------------------------------------------------------------------
class StubEngine:
    """A replica stand-in: each step finishes its oldest request on a
    VirtualClock, or raises ``fault``."""

    def __init__(self, fault=None):
        self.clock = tchaos.VirtualClock()
        self.fault = fault
        self.pending, self.results, self.next = [], {}, 0
        self.boundary_log, self.degrader = [], None

    def submit(self, request, *, arrival_t=None, klass=""):
        rid, self.next = self.next, self.next + 1
        self.pending.append((rid, request))
        return rid

    def result(self, rid):
        return self.results.get(rid)

    def _outstanding(self):
        return bool(self.pending)

    def ledger(self):
        return types.SimpleNamespace(in_flight=len(self.pending), queued=0)

    def step(self):
        if self.fault is not None:
            raise self.fault
        self.clock.advance(1e-3)
        rid, _ = self.pending.pop(0)
        self.results[rid] = Result(tokens=np.zeros(1, np.int32), steps=1,
                                   latency_s=self.clock())
        return self._outstanding()

    def evict_in_flight(self):
        out = [types.SimpleNamespace(rid=r, request=q, generated=[],
                                     retries=0) for r, q in self.pending]
        self.pending = []
        return out

    def adopt(self, tr):
        return self.submit(tr.request)

    def cancel(self, rid):
        return False


DEVICE_FAULTS = [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("matmul_tiled launch failed: unspecified launch failure"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
    RuntimeError("CUDA driver error: device-side assert triggered"),
]
HOST_FAULTS = [tchaos.InjectedFault("injected replica crash at costed "
                                    "step 0"),
               RuntimeError("boom"), ValueError("a host-side bug")]


@pytest.mark.parametrize("fault", DEVICE_FAULTS + HOST_FAULTS,
                         ids=lambda e: type(e).__name__ + ":" + str(e)[:16])
def test_router_reraises_device_faults_and_demotes_host_faults(fault):
    """One CUDA context under every replica: a device fault fails the run
    loudly; any other exception out of step() is that replica's death, and
    its work moves to the sibling."""
    from repro_torch.serving.router import is_device_fault

    router = tserving.ReplicaRouter(
        {"r0": StubEngine(fault), "r1": StubEngine()}, slow_factor=None)
    reqs = [tserving.Request(prompt=np.zeros(3, np.int32))
            for _ in range(4)]
    if fault in DEVICE_FAULTS:
        assert is_device_fault(fault)
        with pytest.raises(type(fault)) as got:
            router.run(reqs)
        assert got.value is fault and router.health_log == []
        wrapped = RuntimeError("step failed")
        wrapped.__cause__ = fault
        assert is_device_fault(wrapped)
    else:
        assert not is_device_fault(fault)
        res = router.run(reqs)
        assert router.ledger().complete and router.ledger().finished == 4
        [ev] = router.health_log
        assert ev.replica == "r0" and ev.state == "dead"
        assert ev.reason.startswith(type(fault).__name__)
        assert all(r.migrations == 1 for r in res[::2])


def test_adopt_refuses_a_checkpoint_on_another_device(model):
    """A migrated chunk checkpoint must already be on the adopter's
    device: adopt() raises rather than copying it across."""
    t = port_side(model)
    eng = tserving.ContinuousServeEngine(t.params, t.cfg, device="cpu",
                                         max_len=32, prefill_chunk=4)
    tr = eng._fresh_states(eng._full_heads, batch=1)
    tracked = types.SimpleNamespace(
        rid=7, request=reqs_for(t, (9,))[0], klass="", arrival_t=0.0,
        generated=[], retries=0, prefill_done=4, chunk_state=tr,
        chunk_heads=eng._full_heads.copy(), chunk_eff=eng._full_heads.copy())
    assert eng.adopt(tracked) == 0
    meta = {g: {k: {n: x.to("meta") for n, x in d.items()}
                for k, d in grp.items()} for g, grp in tr.items()}
    tracked.chunk_state = meta
    with pytest.raises(ValueError, match="adopt\\(\\) moves no tensors"):
        eng.adopt(tracked)


# ---------------------------------------------------------------------------
# the CLI (its burst and fleet runs are in test_torch_chaos_cli.py)
# ---------------------------------------------------------------------------
def test_fleet_tokens_sits_where_the_tokens_are():
    """The fleet ladder's class is the step size that serves the median
    token: prompts as whole joins or chunks, decode tokens ``slots`` to a
    step."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve_resilient import fleet_arrivals, fleet_tokens
    cfg = get_config("qwen1.5-0.5b")

    def arrivals(lens, new):
        return fleet_arrivals(cfg, n=len(lens), prompt_lens=lens,
                              new_tokens=new, gap_s=1e-3, seed=0)
    # joins 100 and 10, 18 decode tokens in 5 steps (4, 4, 4, 4, 2):
    # 128 tokens, the 64th (smallest steps first) in the 100-token join
    assert fleet_tokens(arrivals((100, 10), 10), slots=4) == 100
    # the same in 8-token chunks: steps 2 x 2, 4 x 5 and 8 x 13
    assert fleet_tokens(arrivals((100, 10), 10), slots=4,
                        prefill_chunk=8) == 8
    # long outputs: decode steps carry most tokens
    assert fleet_tokens(arrivals((100, 10), 200), slots=4) == 4
    lens = (128, 97, 64, 33, 200, 17, 150, 80)
    new = (16, 8, 24, 16, 8, 32, 16, 12)
    burst = fleet_arrivals(cfg, n=48, prompt_lens=lens, new_tokens=new,
                           gap_s=1e-3, seed=0)
    assert fleet_tokens(burst, slots=4) == 128
    assert fleet_tokens(burst, slots=4, prefill_chunk=64) == 64


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    from repro_torch.launch.serve_resilient import main as cli_main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["--reduced"])
