"""The port's hedged multi-replica serving (``repro_torch.serving.router``
and ``.hedging``) against ``repro``'s, scenario by scenario
(tests/test_hedged_serving.py's, on its reduced qwen, CPU).

Both packages run every scenario on per-replica ``VirtualClock``s with
seeded injectors, so the router ledger, ``hedge_log``, ``health_log``,
each engine's ledger and logs and each result's signature must be equal
exactly. Greedy tokens follow the margin rule of
tests/test_torch_continuous.py; a request's legs and migrations share its
margin key, which keeps the smallest margin recorded for it. ``repro``'s
replicas share one step cache, as its tests do (its arrays are
immutable); the port's each get their own (``WidthVariantCompileCache.
claim``).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced
from repro.models import transformer as jtfm
from repro import serving as jserving
from repro.serving import chaos as jchaos
from repro_torch import serving as tserving
from repro_torch.configs import get_config, reduced_config
from repro_torch.interop import params_from_jax
from repro_torch.models import transformer as tfm
from repro_torch.serving import chaos as tchaos
from test_torch_continuous import Margins, assert_same_engines
from test_torch_degradation import serving_ladder
from test_torch_recurrent import one_torch_thread  # noqa: F401

N_ACCEPT = 24


@pytest.fixture(scope="module")
def fleet_sides():
    """(repro's side, the port's side) on tests/test_hedged_serving.py's
    reduced qwen (repro's initialization at PRNGKey(0), unscaled)."""
    jc = jax_reduced(jax_get_config("qwen1.5-0.5b"), d_model=128,
                     n_layers=2, d_ff=576)
    tc = reduced_config(get_config("qwen1.5-0.5b"), d_model=128,
                        n_layers=2, d_ff=576)
    host = jax.device_get(jtfm.init_params(jax.random.PRNGKey(0), jc))
    j = types.SimpleNamespace(sv=jserving, ch=jchaos, cfg=jc,
                              params=jax.tree.map(jnp.asarray, host), kw={},
                              jax=True, cache=jserving.
                              WidthVariantCompileCache(jc))
    t = types.SimpleNamespace(sv=tserving, ch=tchaos, cfg=tc,
                              params=params_from_jax(host),
                              kw={"device": "cpu"}, jax=False)
    return j, t


class FleetMargins(Margins):
    """``Margins`` over a fleet: a request's hedge legs and migrations
    note under one key, which keeps the smallest margin noted."""

    def _note(self, tr, row) -> None:
        key = (id(tr.request), len(tr.generated))
        old = self.margin.get(key)
        super()._note(tr, row)
        if old is not None:
            self.margin[key] = min(old, self.margin[key])


def arrivals_for(S, n, *, gap_s=0.002, plen=9, max_new=6, seed=1,
                 klass="small"):
    rng = np.random.default_rng(seed)
    return [S.sv.Arrival(t=gap_s * i, request=S.sv.Request(
        prompt=rng.integers(1, S.cfg.vocab_size, size=(plen,))
        .astype(np.int32), max_new_tokens=max_new), klass=klass)
        for i in range(n)]


def replica(S, m, *, slow=None, chunk_hook=None, cached=False, slots=2,
            **kw):
    """tests/test_hedged_serving.py's ``make_replica``: chunked prefill
    on a VirtualClock of its own. ``cached``: repro's replicas share its
    side's step cache, the port's each get a new one."""
    cache = None
    if cached:
        cache = S.cache if S.jax else S.sv.WidthVariantCompileCache(S.cfg)
    eng = S.sv.ContinuousServeEngine(
        S.params, S.cfg, **S.kw, max_len=64, batch_slots=slots,
        clock=S.ch.VirtualClock(), prefill_chunk=4, step_token_budget=8,
        chunk_fault_hook=chunk_hook, compile_cache=cache,
        batch_cost_fn=S.ch.modeled_batch_cost(1e-4, overhead_s=1e-4,
                                              slow=slow), **kw)
    if m is not None:
        m.attach(eng)
    return eng


def signature(results) -> list:
    return [(len(r.tokens), round(r.latency_s, 12), r.shed, r.failed,
             r.hedged, r.won_by, r.migrations) for r in results]


def astuples(log) -> list:
    return [dataclasses.astuple(x) for x in log]


# ---------------------------------------------------------------------------
# the scenarios: each builds a router on one side and serves arrivals
# ---------------------------------------------------------------------------
def sc_hedged(S, m):
    """A plain hedge (rung 0) against a primary stalled 8x."""
    stall = S.ch.ReplicaStallInjector(8.0)
    router = S.sv.ReplicaRouter(
        {"r0": replica(S, m, slow=stall, cached=True),
         "r1": replica(S, m, cached=True)},
        hedge=S.sv.HedgePolicy(default_delay_s=0.01, rung=0),
        slow_factor=None)
    arrs = arrivals_for(S, 10)
    return router, arrs, router.run(arrs)


def sc_both_fault(S, m):
    """Every chunk on every replica faults: both legs fail."""
    def always():
        raise S.ch.InjectedFault("permanent chunk fault")

    router = S.sv.ReplicaRouter(
        {"r0": replica(S, m, chunk_hook=always),
         "r1": replica(S, m, chunk_hook=always)},
        hedge=S.sv.HedgePolicy(default_delay_s=0.0, rung=0),
        slow_factor=None, max_migrations=0)
    arrs = arrivals_for(S, 3)
    return router, arrs, router.run(arrs)


def sc_rung1(S, m):
    """A rung-1 hedge pins the backup's ladder floor for its lifetime."""
    _, ladder = serving_ladder(S, deltas=(0.8, 0.6))
    params = S.params if S.jax else tfm.cast_params(S.params, "cpu")

    def rep(stall=None):
        deg = S.sv.DegradationController(ladder, down_patience=10 ** 6,
                                         up_patience=10 ** 6)
        eng = S.sv.ContinuousServeEngine(
            params, S.cfg, **S.kw, max_len=64, batch_slots=2,
            clock=S.ch.VirtualClock(), prefill_chunk=4,
            swapper=S.sv.WidthSwapper(params, S.cfg),
            admission=S.sv.AdmissionControl(max_queue_batches=8,
                                            target_batch_s=1.0),
            degrader=deg, batch_cost_fn=S.ch.modeled_batch_cost(
                1e-4, overhead_s=1e-4, slow=stall))
        if m is not None:
            m.attach(eng)
        return eng

    router = S.sv.ReplicaRouter(
        {"r0": rep(S.ch.ReplicaStallInjector(8.0)), "r1": rep()},
        hedge=S.sv.HedgePolicy(default_delay_s=0.01, rung=1),
        slow_factor=None)
    arrs = arrivals_for(S, 8)
    return router, arrs, router.run(arrs)


def sc_crash(S, m):
    """Replica 0 dies at its third costed step."""
    router = S.sv.ReplicaRouter(
        {"r0": replica(S, m, slow=S.ch.ReplicaCrashInjector(at_step=2)),
         "r1": replica(S, m)}, slow_factor=None)
    arrs = arrivals_for(S, 12, gap_s=0.001, max_new=10)
    return router, arrs, router.run(arrs)


def sc_ewma(S, m):
    """A 20x straggler trips the EWMA health check."""
    router = S.sv.ReplicaRouter(
        {"r0": replica(S, m, slow=S.ch.ReplicaStallInjector(20.0)),
         "r1": replica(S, m)}, slow_factor=4.0, min_beats=4)
    arrs = arrivals_for(S, 16, gap_s=0.001, max_new=12)
    return router, arrs, router.run(arrs)


def sc_budget(S, m):
    """Both replicas crash, one migration allowed."""
    router = S.sv.ReplicaRouter(
        {"r0": replica(S, m, slow=S.ch.ReplicaCrashInjector(at_step=2)),
         "r1": replica(S, m, slow=S.ch.ReplicaCrashInjector(at_step=4))},
        slow_factor=None, max_migrations=1)
    arrs = arrivals_for(S, 8, gap_s=0.001, max_new=10)
    return router, arrs, router.run(arrs)


def sc_checkpoint(S, m):
    """Replica 0 dies mid-prefill (21-token prompts, 4-token chunks)."""
    router = S.sv.ReplicaRouter(
        {"r0": replica(S, m, slow=S.ch.ReplicaCrashInjector(at_step=1)),
         "r1": replica(S, m)}, slow_factor=None)
    arrs = arrivals_for(S, 4, gap_s=0.0005, plen=21, max_new=6)
    return router, arrs, router.run(arrs)


def sc_checkpoint_base(S, m):
    """sc_checkpoint's arrivals on an undisturbed fleet."""
    router = S.sv.ReplicaRouter({"r0": replica(S, m), "r1": replica(S, m)},
                                slow_factor=None)
    arrs = arrivals_for(S, 4, gap_s=0.0005, plen=21, max_new=6)
    return router, arrs, router.run(arrs)


def _accept(S, m, hedge):
    """The straggler burst: replica 0 stalled 8x, seeded chunk faults on
    both replicas, one step cache each."""
    router = S.sv.ReplicaRouter(
        {"r0": replica(S, m, slow=S.ch.ReplicaStallInjector(8.0),
                       chunk_hook=S.ch.ChunkFaultInjector(0.05, seed=11),
                       cached=True),
         "r1": replica(S, m,
                       chunk_hook=S.ch.ChunkFaultInjector(0.05, seed=12),
                       cached=True)},
        hedge=(S.sv.HedgePolicy(default_delay_s=0.01, rung=0)
               if hedge else None), slow_factor=None)
    arrs = arrivals_for(S, N_ACCEPT, gap_s=0.001, plen=13, max_new=8)
    return router, arrs, router.run(arrs)


def sc_accept_unhedged(S, m):
    return _accept(S, m, False)


def sc_accept_hedged(S, m):
    return _accept(S, m, True)


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_hedged, sc_both_fault, sc_rung1, sc_crash, sc_ewma, sc_budget,
    sc_checkpoint, sc_checkpoint_base, sc_accept_unhedged,
    sc_accept_hedged)}


@pytest.fixture(scope="module")
def fleet(fleet_sides):
    """name -> ((repro's router, results), (the port's router, results),
    margins, repro's arrivals); each scenario runs once per side."""
    j, t = fleet_sides
    done = {}

    def get(name):
        if name not in done:
            m = FleetMargins(j.cfg.vocab_size)
            jr, jarrs, jres = SCENARIOS[name](j, m)
            tr, _, tres = SCENARIOS[name](t, None)
            done[name] = ((jr, jres), (tr, tres), m, jarrs)
        return done[name]

    return get


def engines(router) -> list:
    return [r.engine for r in router.replicas]


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_router_matches_repro(fleet, name):
    """Decisions equal repro's exactly; tokens under the margin rule."""
    (jr, jres), (tr, tres), m, jarrs = fleet(name)
    assert dataclasses.astuple(tr.ledger()) == \
        dataclasses.astuple(jr.ledger())
    assert astuples(tr.hedge_log) == astuples(jr.hedge_log)
    assert astuples(tr.health_log) == astuples(jr.health_log)
    assert_same_engines(engines(jr), engines(tr))
    assert signature(tres) == signature(jres)
    assert [(r.retries, r.recovered, r.cancelled, r.deadline_missed)
            for r in tres] == [(r.retries, r.recovered, r.cancelled,
                                r.deadline_missed) for r in jres]
    assert tr.ledger().complete
    m.check_tokens([a.request for a in jarrs], jres, tres, min_frac=0.5)


def test_hedge_pair_is_one_ledger_entry(fleet):
    _, (router, results), _, _ = fleet("hedged")
    led = router.ledger()
    assert led.complete and led.submitted == len(results) == 10
    assert led.hedged >= 1 and led.hedged == len(router.hedge_log)
    for r in router.replicas:
        assert r.engine.ledger().complete, r.engine.ledger()
    cancelled = sum(res.cancelled for r in router.replicas
                    for res in r.engine._results.values())
    assert cancelled == sum(1 for lg in router._logicals
                            if lg.hedged and len(lg.results) < 2)


def test_backup_wins_on_stalled_primary(fleet):
    _, (router, results), _, _ = fleet("hedged")
    hedged = [r for r in results if r.hedged]
    assert hedged and all(r.won_by in ("primary", "backup") for r in hedged)
    assert router.ledger().hedge_wins_backup >= 1
    assert all(ev.winner for ev in router.hedge_log)
    assert all(not r.hedged or r.won_by for r in results)


def test_both_legs_fault_resolve_failed(fleet):
    _, (router, results), _, _ = fleet("both_fault")
    led = router.ledger()
    assert led.complete and led.failed == 3, led
    assert all(r.failed and not r.shed for r in results)


def test_rung1_hedge_pins_and_releases(fleet):
    _, (router, _), _, _ = fleet("rung1")
    led = router.ledger()
    assert led.complete and led.hedged >= 1
    assert all(ev.rung == 1 for ev in router.hedge_log)
    for r in router.replicas:
        assert r.engine.degrader._pins == []
    # the pinned replica crossed to the narrower rung and back
    pinned = {ev.replica for ev in router.hedge_log}
    assert any(any(p.widths for p in router._by_name[n].engine.plan_log)
               for n in pinned)


def test_crash_migrates_with_zero_lost(fleet):
    _, (router, results), _, _ = fleet("crash")
    led = router.ledger()
    assert led.complete and led.finished == 12 and led.failed == 0
    assert led.migrated >= 1 and any(r.migrations > 0 for r in results)
    [ev] = router.health_log
    assert ev.state == "dead" and ev.reason.startswith("InjectedFault")
    dead = router.replicas[0].engine.ledger()
    assert dead.complete and dead.evicted >= 1


def test_slow_replica_drained_by_ewma(fleet):
    _, (router, _), _, _ = fleet("ewma")
    led = router.ledger()
    assert led.complete and led.finished == 16 and led.migrated >= 1
    assert [h.state for h in router.health_log] == ["slow"]
    assert "ewma" in router.health_log[0].reason


def test_migration_budget_fails_accountably(fleet):
    _, (router, results), _, _ = fleet("budget")
    led = router.ledger()
    assert led.complete and led.failed >= 1
    assert led.finished + led.failed + led.shed == 8
    assert all(r is not None for r in results)


def test_chunk_checkpoint_survives_migration(fleet):
    """The adopter resumes the dead replica's checkpoint: the tokens of
    the undisturbed fleet, bit for bit (both on the port)."""
    _, (router, results), _, _ = fleet("checkpoint")
    _, (_, base), _, _ = fleet("checkpoint_base")
    assert router.ledger().complete and router.ledger().migrated >= 1
    for want, got in zip(base, results):
        assert want.tokens.tolist() == got.tokens.tolist()


def test_acceptance_zero_lost_and_hedged_tail(fleet):
    """The straggler burst: nothing lost either way, the chaos fired, and
    hedging cuts the p99.9 on the virtual clocks."""
    _, (r_un, un), _, _ = fleet("accept_unhedged")
    _, (r_h, h), _, _ = fleet("accept_hedged")
    for router, results in ((r_un, un), (r_h, h)):
        led = router.ledger()
        assert led.complete and led.submitted == N_ACCEPT
        assert led.failed == 0 and led.shed == 0, led
        assert all(len(r.tokens) == 8 for r in results)
        for r in router.replicas:
            cache = r.engine.compile_cache
            assert cache is not None and cache._holder_engine() is r.engine
    assert any(r.engine.chunk_log for r in r_h.replicas)
    p_un = float(np.percentile([r.latency_s for r in un], 99.9))
    p_h = float(np.percentile([r.latency_s for r in h], 99.9))
    assert r_h.ledger().hedged >= 1 and p_h < p_un, (p_h, p_un)


def test_acceptance_run_twice_is_identical(fleet_sides, fleet):
    _, t = fleet_sides
    _, (_, h), _, _ = fleet("accept_hedged")
    again = sc_accept_hedged(t, None)[2]
    assert signature(again) == signature(h)
    assert [r.tokens.tolist() for r in again] == [r.tokens.tolist()
                                                  for r in h]
