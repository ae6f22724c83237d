"""The port's step cache (``repro_torch.serving.compile_cache``) on the
CPU, where an entry is a static step: keys, crossover, capture counting,
fault fallback, static params, the decode ``pos`` as a tensor, and the
cached engine against ``repro``'s engine with its compile cache. The
CUDA-graph entries are tested on the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced
from repro.core import TPU_V5E as J_HW
from repro.models import transformer as jtfm
from repro import serving as jserving
from repro.serving import compile_cache as jcc
from repro_torch import serving as tserving
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import TPU_V5E
from repro_torch.core.plan_address import plan_key
from repro_torch.interop import params_from_jax
from repro_torch.models import transformer as tfm
from repro_torch.serving import (
    COMPILE_STEPS, Request, ServeEngine, TraceCounter, TrafficClass,
    WidthPlan, WidthSwapper, WidthVariantCompileCache, pow2_bucket,
    realized_exec_key, serving_templates,
)
from repro_torch.serving.compile_cache import decode_state_struct
from test_torch_serve import (
    NEW, _assert_greedy_follows, _planner, prompts,
)
from test_torch_recurrent import one_torch_thread  # noqa: F401

FAMILIES = {"qwen1.5-0.5b": {}, "recurrentgemma-2b": {},
            "rwkv6-1.6b": {}, "granite-moe-1b-a400m": {"n_experts": 16}}


@pytest.fixture(scope="module")
def setup():
    cfg = reduced_config(get_config("qwen1.5-0.5b"), d_model=128,
                         n_layers=2, d_ff=576)
    params = tfm.cast_params(
        tfm.init_params(cfg, torch.Generator().manual_seed(0)), "cpu")
    return cfg, params


def make_plan(widths, modules, *, tokens=96, latency_s=1.0,
              baseline_latency_s=2.0, name="t"):
    return WidthPlan(traffic=TrafficClass(name, tokens), widths=widths,
                     latency_s=latency_s,
                     baseline_latency_s=baseline_latency_s,
                     satisfied=True, modules=modules)


def tokens(cfg, shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape))


def tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_equal(a[k], b[k])
                                            for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


def requests(cfg, lens, seed=0, new=NEW):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, size=(n,))
                    .astype(np.int32), max_new_tokens=new) for n in lens]


# ---------------------------------------------------------------------------
# units: buckets, capture counting, keys, crossover, registry, LRU
# ---------------------------------------------------------------------------
def test_pow2_bucket():
    assert pow2_bucket(1) == 8          # lo floor
    assert pow2_bucket(8) == 8
    assert pow2_bucket(9) == 16
    assert pow2_bucket(16) == 16
    assert pow2_bucket(17) == 32
    assert pow2_bucket(3, lo=1) == 4
    assert pow2_bucket(1000) == 1024
    for n in range(0, 300, 7):
        for lo in (1, 8, 64):
            assert pow2_bucket(n, lo) == jcc.pow2_bucket(n, lo)


def test_trace_counter_counts_captures_not_replays(setup):
    cfg, params = setup
    tracer = TraceCounter()
    f = tracer.wrap(lambda x: x * 2)
    f(1)
    assert tracer.count == 1
    cache = WidthVariantCompileCache(cfg)
    t8 = tokens(cfg, (1, 8))
    assert cache.precompile("prefill", cache.full_key, (1, 8), (params, t8))
    assert cache.tracer.count == 1
    cache.prefill(params, t8)
    cache.prefill(params, tokens(cfg, (1, 8), seed=1))   # replays: none
    assert cache.tracer.count == 1 and cache.stats["hits"] == 2
    assert cache.precompile("prefill", cache.full_key, (1, 8), (params, t8))
    assert cache.tracer.count == 1      # already warm: no capture
    cache.precompile("prefill", cache.full_key, (1, 16),
                     (params, tokens(cfg, (1, 16))))
    assert cache.tracer.count == 2      # new shape: one more capture


def test_realized_exec_key_distinct_and_as_repro(setup):
    cfg, _ = setup
    cache = WidthVariantCompileCache(cfg, hw=TPU_V5E)
    jcache = jcc.WidthVariantCompileCache(
        jax_reduced(jax_get_config("qwen1.5-0.5b"), d_model=128,
                    n_layers=2, d_ff=576), hw=J_HW)
    assert cache.full_key == jcache.full_key
    assert cache.fingerprint == jcache.fingerprint
    full = realized_exec_key(
        np.full(cfg.n_layers, cfg.d_ff), np.full(cfg.n_layers, cfg.n_heads))
    assert full == cache.full_key
    narrow = realized_exec_key(
        np.full(cfg.n_layers, 256), np.full(cfg.n_layers, cfg.n_heads))
    assert narrow != full
    for mlp_w, heads in ((np.array([256, 384]), np.array([4, 2])),
                         ([[576], [128]], [1, 4]), (np.int64(7), 3)):
        assert realized_exec_key(mlp_w, heads) == \
            jcc.realized_exec_key(mlp_w, heads)
    # set_active(None) resets to the canonical full key
    cache.set_active(narrow)
    assert cache.active_key == narrow
    cache.set_active(None)
    assert cache.active_key == cache.full_key


@pytest.mark.parametrize("latency,baseline,cost,horizon", [
    (1.0, 2.0, 0.25, 32), (0.999, 1.0, 0.25, 32), (0.99, 1.0, 0.25, 32),
    (1.0, 1.0, 0.0, 1), (2.0, 1.0, 0.25, 32), (1e-4, 2e-4, 1e-3, 8)])
def test_decide_crossover_as_repro(setup, latency, baseline, cost, horizon):
    cfg, _ = setup
    kw = dict(compile_cost_s=cost, horizon_batches=horizon)
    cache = WidthVariantCompileCache(cfg, **kw)
    jcache = jcc.WidthVariantCompileCache(
        jax_reduced(jax_get_config("qwen1.5-0.5b")), **kw)
    for widths in ({"mlp0": 256}, {}):
        plan = make_plan(widths, {}, latency_s=latency,
                         baseline_latency_s=baseline)
        jplan = jserving.WidthPlan(
            traffic=jserving.TrafficClass("t", 96), widths=widths,
            latency_s=latency, baseline_latency_s=baseline, satisfied=True)
        assert cache.decide(plan) == jcache.decide(jplan)
    big = make_plan({"mlp0": 256}, {}, latency_s=1.0, baseline_latency_s=2.0)
    small = make_plan({"mlp0": 256}, {}, latency_s=0.999,
                      baseline_latency_s=1.0)
    default = WidthVariantCompileCache(cfg)
    assert default.decide(big) == "sliced"
    assert default.decide(small) == "masked"
    assert default.decide(make_plan({}, {})) == "sliced"


def test_warm_plan_registry(setup):
    cfg, _ = setup
    cache = WidthVariantCompileCache(cfg)
    p = make_plan({"mlp0": 256}, {})
    q = make_plan({"mlp0": 384}, {})
    assert not cache.plan_is_warm(p)
    cache.mark_plan_warm(p)
    assert cache.plan_is_warm(p)
    assert not cache.plan_is_warm(q)
    assert plan_key(p.widths) != plan_key(q.widths)
    planner = tserving.ServingWidthPlanner(TPU_V5E, [], device="cpu")
    assert not planner.plan_is_warm(p)
    planner = tserving.ServingWidthPlanner(TPU_V5E, [], device="cpu",
                                           compile_cache=cache)
    assert planner.plan_is_warm(p) and not planner.plan_is_warm(q)


def test_lru_bounds_entries(setup):
    cfg, params = setup
    cache = WidthVariantCompileCache(cfg, max_entries=1)
    cache.precompile("prefill", cache.full_key, (1, 8),
                     (params, tokens(cfg, (1, 8))))
    cache.precompile("prefill", cache.full_key, (1, 16),
                     (params, tokens(cfg, (1, 16))))
    assert len(cache) == 1               # oldest evicted
    cache.prefill(params, tokens(cfg, (1, 8)))
    assert cache.stats["misses"] == 1 and cache.stats["hits"] == 0


def test_chunk_kind_waits_for_the_continuous_engine(setup):
    """The continuous engine is ported, so the chunk kind serves: a warm
    chunk replays ``prefill_chunk`` at any position, bit-equal to the
    eager step, into the caller's own states."""
    cfg, params = setup
    cache = WidthVariantCompileCache(cfg)
    assert cache.precompile("chunk", cache.full_key, (1, 8),
                            (params, tokens(cfg, (1, 8)), 0,
                             tfm.init_decode_state(cfg, 1, 32)))
    mine = tfm.init_decode_state(cfg, 1, 32)
    ref = tfm.init_decode_state(cfg, 1, 32)
    for pos in (0, 8, torch.tensor(16)):
        toks = tokens(cfg, (1, 8), seed=int(pos))
        got, st = cache.chunk(params, toks, pos, mine)
        with torch.inference_mode():
            want, ref = tfm.prefill_chunk(params, cfg, toks, pos, ref)
        assert st is mine and tree_equal(st, ref)
        assert torch.equal(got, want)
    assert cache.stats["hits"] == 3 and cache.tracer.count == 1
    with pytest.raises(ValueError, match="unknown kind"):
        cache.precompile("train", cache.full_key, (1, 8), (params,))


# ---------------------------------------------------------------------------
# static steps: replay equals eager, aliasing as a graph's, cold lookups
# ---------------------------------------------------------------------------
def test_warm_prefill_equals_eager_and_aliases(setup):
    cfg, params = setup
    cache = WidthVariantCompileCache(cfg)
    toks = tokens(cfg, (2, 8))
    assert cache.precompile("prefill", cache.full_key, (2, 8),
                            (params, torch.zeros_like(toks)))
    got, st = cache.prefill(params, toks)
    with torch.inference_mode():
        want, want_st = tfm.forward(params, cfg, tokens=toks,
                                    mode="prefill")
    assert torch.equal(got, want) and tree_equal(st, want_st)
    got2, _ = cache.prefill(params, tokens(cfg, (2, 8), seed=1))
    assert got2 is got                   # static outputs, as a graph's
    assert cache.stats == {"aot_compiles": 1, "hits": 2, "misses": 0,
                           "fallbacks": 0}


def test_warm_decode_copies_states_once(setup):
    cfg, params = setup
    cache = WidthVariantCompileCache(cfg)
    b, max_len = 2, 16
    assert cache.precompile(
        "decode", cache.full_key, (b,),
        (params, torch.zeros(b, dtype=torch.long), 0,
         decode_state_struct(cfg, b, max_len)))
    eng = ServeEngine(params, cfg, max_len=max_len, device="cpu")
    with torch.inference_mode():
        _, st = tfm.forward(params, cfg, tokens=tokens(cfg, (b, 5)),
                            mode="prefill")
        st = eng._ensure_states(st)
        ref = eng._ensure_states(
            tfm.forward(params, cfg, tokens=tokens(cfg, (b, 5)),
                        mode="prefill")[1])
    cur = torch.tensor([3, 7])
    traced = cache.tracer.count
    static = None
    for t in range(3):
        logits, st = cache.decode(params, cur, 5 + t, st)
        with torch.inference_mode():
            want, ref = tfm.decode_step(params, cfg, cur, 5 + t, ref)
        assert torch.equal(logits, want) and tree_equal(st, ref)
        static = st if static is None else static
        assert st is static              # the entry's static states
        cur = torch.argmax(logits, dim=-1)
    assert cache.tracer.count == traced and cache.stats["hits"] == 3


def test_cold_lookup_served_eagerly(setup):
    cfg, params = setup
    cache = WidthVariantCompileCache(cfg)
    toks = tokens(cfg, (1, 8))
    logits, _ = cache.prefill(params, toks)
    with torch.inference_mode():
        want, _ = tfm.forward(params, cfg, tokens=toks, mode="prefill")
    assert torch.equal(logits, want)
    assert cache.stats["misses"] == 1 and cache.tracer.count == 0
    assert cache.events[-1].outcome == "miss"


def test_engine_refuses_a_cache_of_another_config(setup):
    cfg, params = setup
    other = reduced_config(get_config("qwen1.5-0.5b"))
    with pytest.raises(ValueError, match="different"):
        ServeEngine(params, cfg, device="cpu",
                    compile_cache=WidthVariantCompileCache(other))


# ---------------------------------------------------------------------------
# faults at every step, absorbed with the tokens unchanged
# ---------------------------------------------------------------------------
def raise_at(step):
    def hook(s):
        if s == step:
            raise RuntimeError(f"injected fault at {s!r}")
    return hook


@pytest.mark.parametrize("step", COMPILE_STEPS)
def test_fault_absorbed_tokens_unchanged(setup, step):
    cfg, params = setup
    reqs = requests(cfg, (8, 5, 6, 3))
    eager = ServeEngine(params, cfg, max_len=32, device="cpu")
    want = eager.generate(reqs)
    cache = WidthVariantCompileCache(cfg, fault_hook=raise_at(step))
    eng = ServeEngine(params, cfg, max_len=32, device="cpu",
                      compile_cache=cache)
    n = eng.warm_compile([], [(4, 8)])
    got = eng.generate(reqs)
    for a, b in zip(want, got):
        assert np.array_equal(a.tokens, b.tokens)
    assert cache.stats["fallbacks"] > 0 and cache.stats["hits"] == 0
    assert any(e.outcome == "fault" for e in cache.events)
    if step == "lookup":
        assert n == 2 and len(cache) == 2
        assert cache.stats["fallbacks"] == NEW      # prefill + NEW-1 steps
    else:
        assert n == 0 and len(cache) == 0
        assert cache.stats["misses"] == NEW


# ---------------------------------------------------------------------------
# realizations: masked and sliced are distinct trees and distinct entries
# ---------------------------------------------------------------------------
def test_masked_and_sliced_use_distinct_keys(setup):
    cfg, params = setup
    _, modules = serving_templates(cfg, TPU_V5E, tokens=96, sites=("mlp",))
    swapper = WidthSwapper(params, cfg)
    plan = make_plan({f"mlp{i}": 256 for i in range(cfg.n_layers)},
                     modules)
    a, ev_a = swapper.apply(plan, masked=True)
    b, ev_b = swapper.apply(plan)
    c, _ = swapper.apply(plan, masked=True)
    assert a is c and a is not b and ev_a.masked and not ev_b.masked
    cache = WidthVariantCompileCache(cfg)
    eng = ServeEngine(params, cfg, max_len=16, device="cpu",
                      swapper=swapper, compile_cache=cache)
    eng.warm_compile([], [(1, 8)])
    assert len(cache) == 2
    masked = make_plan(plan.widths, modules, latency_s=0.999,
                       baseline_latency_s=1.0)
    assert cache.decide(masked) == "masked"
    count = cache.tracer.count
    assert eng.warm_compile([masked], [(1, 8)]) == 4
    # the masked tree warms the full-width key: its entries, no capture
    assert len(cache) == 2 and cache.tracer.count == count
    assert cache.active_key == cache.full_key and cache.plan_is_warm(masked)
    full = {cache._entry_key(kind, cache.full_key, s)
            for kind, s in (("prefill", (1, 8)), ("decode", (1,)))}
    assert set(cache._exec) == full
    assert cache.decide(plan) == "sliced"
    eng.warm_compile([plan], [(1, 8)])
    sliced = realized_exec_key(*swapper.realize_plan(plan))
    assert sliced != cache.full_key and len(cache) == 4
    assert set(cache._exec) - full == {
        cache._entry_key(kind, sliced, s)
        for kind, s in (("prefill", (1, 8)), ("decode", (1,)))}
    assert set(cache._params) == {cache.full_key, sliced}


def test_static_params_copy_the_changed_leaves_only(setup):
    """A key's static params take a tree's leaves by copy, skipping the
    leaves copied in last; a tree that does not fit copies nothing and
    the step runs eagerly; an LRU eviction frees a key's static params
    with its last entry."""
    cfg, params = setup
    _, modules = serving_templates(cfg, TPU_V5E, tokens=96, sites=("mlp",))
    swapper = WidthSwapper(params, cfg)
    plan = make_plan({f"mlp{i}": 256 for i in range(cfg.n_layers)},
                     modules)
    masked, _ = swapper.apply(plan, masked=True)
    cache = WidthVariantCompileCache(cfg, max_entries=2)
    toks = tokens(cfg, (1, 8))
    assert cache.precompile("prefill", cache.full_key, (1, 8),
                            (params, toks))
    store = cache._params[cache.full_key]
    assert all(a is not b and torch.equal(a, b) for a, b in zip(
        store.static, tserving.compile_cache.leaves(params)))
    writes = []
    for t in store.static:
        t.copy_ = (lambda orig: lambda x: (writes.append(1), orig(x))[1])(
            t.copy_)
    cache.prefill(params, toks)
    assert writes == []                      # the leaves loaded last
    got, _ = cache.prefill(masked, toks)
    changed = sum(a is not b for a, b in zip(
        tserving.compile_cache.leaves(masked),
        tserving.compile_cache.leaves(params)))
    assert 0 < len(writes) == changed
    with torch.inference_mode():
        want, _ = tfm.forward(masked, cfg, tokens=toks, mode="prefill")
    assert torch.equal(got, want)
    sliced, _ = swapper.apply(plan)
    fallbacks = cache.stats["fallbacks"]
    got, _ = cache.prefill(sliced, toks)     # sliced shapes: no fit
    with torch.inference_mode():
        want, _ = tfm.forward(sliced, cfg, tokens=toks, mode="prefill")
    assert torch.equal(got, want)
    assert cache.stats["fallbacks"] == fallbacks + 1
    assert all(s is m for s, m in zip(
        store.loaded, tserving.compile_cache.leaves(masked)))
    key = realized_exec_key(*swapper.realize_plan(plan))
    for shape in ((1, 8), (1, 16)):
        cache.precompile("prefill", key, shape,
                         (sliced, tokens(cfg, shape)))
    assert set(cache._params) == {key}       # the full key's entry evicted


# ---------------------------------------------------------------------------
# decode at a tensor pos: the bits of the int form, for every family
# ---------------------------------------------------------------------------
def family(arch, seed=0):
    cfg = reduced_config(get_config(arch), **FAMILIES[arch])
    params = tfm.cast_params(
        tfm.init_params(cfg, torch.Generator().manual_seed(seed)), "cpu")
    return cfg, params


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_decode_pos_as_tensor_is_bit_equal(arch):
    cfg, params = family(arch)
    b, plen, max_len = 3, 6, 24
    eng = ServeEngine(params, cfg, max_len=max_len, device="cpu")
    with torch.inference_mode():
        _, st = tfm.forward(params, cfg, tokens=tokens(cfg, (b, plen)),
                            mode="prefill")
        st = eng._ensure_states(st)
        st_t = {g: {k: {n: x.clone() for n, x in d.items()}
                    for k, d in sub.items()} for g, sub in st.items()}
        cur = torch.tensor([1, 5, 9])
        for t in range(4):
            pos = plen + t
            a, st = tfm.decode_step(params, cfg, cur, pos, st)
            b_, st_t = tfm.decode_step(params, cfg, cur,
                                       torch.full((b,), pos), st_t)
            assert torch.equal(a, b_), (arch, t)
            assert tree_equal(st, st_t), (arch, t)
            cur = torch.argmax(a[:, :cfg.vocab_size], dim=-1)


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_decode_state_struct_fits_the_engines_states(arch):
    """The static decode state has the structure, shapes and dtypes of
    the tree the engine hands decode after a prefill (a local ring of
    ``window`` rows even where ``max_len`` is shorter)."""
    cfg, params = family(arch)
    for max_len in (16, 80):
        eng = ServeEngine(params, cfg, max_len=max_len, device="cpu")
        with torch.inference_mode():
            _, st = tfm.forward(params, cfg, tokens=tokens(cfg, (2, 7)),
                                mode="prefill")
        got = decode_state_struct(cfg, 2, max_len)
        want = eng._ensure_states(st)
        assert got.keys() == want.keys()
        for g in got:
            assert got[g].keys() == want[g].keys()
            for k in got[g]:
                assert {n: (x.shape, x.dtype) for n, x in got[g][k].items()} \
                    == {n: (x.shape, x.dtype) for n, x in want[g][k].items()}


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_cached_engine_serves_as_the_eager_one(arch):
    cfg, params = family(arch, seed=1)
    reqs = requests(cfg, (8, 5, 12, 3), seed=2)
    want = ServeEngine(params, cfg, max_len=24, device="cpu").generate(reqs)
    cache = WidthVariantCompileCache(cfg)
    eng = ServeEngine(params, cfg, max_len=24, device="cpu",
                      compile_cache=cache)
    assert eng.warm_compile([], [(4, 12)]) == 2
    count = cache.tracer.count
    got = eng.generate(reqs) + eng.generate(reqs)
    for a, b in zip(want + want, got):
        assert np.array_equal(a.tokens, b.tokens)
    assert cache.stats == {"aot_compiles": 2, "hits": 2 * NEW, "misses": 0,
                           "fallbacks": 0}
    assert cache.tracer.count == count


# ---------------------------------------------------------------------------
# static params: a replay never runs on other weights than those passed
# ---------------------------------------------------------------------------
def boundary_engine(cfg, params, modules, plans, *, max_plans, warm):
    planner = tserving.ServingWidthPlanner(TPU_V5E, [], modules=modules,
                                           device="cpu")
    for p in plans:
        planner.plans[p.traffic.name] = p
    cache = WidthVariantCompileCache(cfg)
    eng = ServeEngine(params, cfg, max_len=32, device="cpu",
                      planner=planner,
                      swapper=WidthSwapper(params, cfg, max_plans=max_plans),
                      compile_cache=cache)
    if warm:
        eng.warm_compile(plans, [(4, 1), (4, 12), (4, 5)])
    return eng, cache


@pytest.mark.parametrize("max_plans", [1, 8])
def test_boundaries_replay_only_on_the_passed_tree(setup, max_plans):
    """Full width, plan A sliced, plan B masked, full width again: the
    tokens equal an engine whose cache is cold (every step eager, the
    same realizations) at every boundary. With ``max_plans=1`` the
    swapper rebuilds A's and B's trees at serve time, so their steps
    replay on trees other than those captured at warm-up; B's masked
    tree replays the full-width key's steps and its tokens differ from
    full width's, so a replay on the wrong weights would show."""
    cfg, params = setup
    _, modules = serving_templates(cfg, TPU_V5E, tokens=96,
                                   sites=("mlp", "attn"))
    a_w = {n: (cfg.d_ff // 2 if r.site == "mlp" else 2 * cfg.head_dim)
           for n, r in modules.items()}
    b_w = {n: (cfg.d_ff // 8 if r.site == "mlp" else cfg.head_dim)
           for n, r in modules.items()}
    plans = [make_plan({}, modules, tokens=4, name="full"),
             make_plan(a_w, modules, tokens=48, name="A"),
             make_plan(b_w, modules, tokens=20, latency_s=0.999,
                       baseline_latency_s=1.0, name="B")]
    bursts = [requests(cfg, (1, 1, 1, 1), seed=3),
              requests(cfg, (12, 9, 4, 7), seed=4),
              requests(cfg, (5, 5, 2, 3), seed=5),
              requests(cfg, (1, 1, 1, 1), seed=6)]
    cold, _ = boundary_engine(cfg, params, modules, plans,
                              max_plans=max_plans, warm=False)
    warm, cache = boundary_engine(cfg, params, modules, plans,
                                  max_plans=max_plans, warm=True)
    assert cache.decide(plans[1]) == "sliced"
    assert cache.decide(plans[2]) == "masked"
    count = cache.tracer.count
    for reqs in bursts:
        for a, b in zip(cold.generate(reqs), warm.generate(reqs)):
            assert np.array_equal(a.tokens, b.tokens)
    assert [p.traffic.name for p in warm.plan_log] == \
        ["full", "A", "B", "full"]
    assert [e.masked for e in warm.swap_log] == [False, False, True, False]
    assert cache.tracer.count == count
    full_width = ServeEngine(params, cfg, max_len=32, device="cpu")
    assert any(not np.array_equal(a.tokens, b.tokens) for a, b in zip(
        full_width.generate(bursts[2]), cold.generate(bursts[2])))
    # rebuilt trees (max_plans 1) replay too: every step of every burst
    assert cache.stats["misses"] == 0 and cache.stats["fallbacks"] == 0
    assert cache.stats["hits"] == 4 * NEW


# ---------------------------------------------------------------------------
# against repro's engine with its compile cache
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_model():
    jc = jax_reduced(jax_get_config("qwen1.5-0.5b"))
    tc = reduced_config(get_config("qwen1.5-0.5b"))
    host = jax.device_get(jtfm.init_params(jax.random.PRNGKey(0), jc))
    # spread the logits, as tests/test_torch_serve.py does
    host["embed"]["tok_emb"] = host["embed"]["tok_emb"] * 25
    return jc, tc, host


def test_cached_engine_matches_repro_cached_engine(ref_model):
    """The same planned bursts (narrow sliced, then full) through both
    engines with their caches warmed on the same plans and shapes: the
    same greedy tokens, warm counts and cache stats."""
    jc, tc, host = ref_model
    ps = prompts(tc.vocab_size)
    jparams = jax.tree.map(jnp.asarray, host)
    jcache = jcc.WidthVariantCompileCache(jc, hw=J_HW)
    jeng = jserving.ServeEngine(
        jparams, jc, max_len=32, batch_slots=4,
        planner=_planner(jserving, J_HW, jc),
        swapper=jserving.WidthSwapper(jparams, jc), compile_cache=jcache)
    cast = tfm.cast_params(params_from_jax(host), "cpu")
    tcache = WidthVariantCompileCache(tc, hw=TPU_V5E)
    teng = ServeEngine(cast, tc, max_len=32, batch_slots=4, device="cpu",
                       planner=_planner(tserving, TPU_V5E, tc, "cpu"),
                       swapper=WidthSwapper(cast, tc), compile_cache=tcache)
    shapes = [(4, 12), (1, 12)]
    n_j = jeng.warm_compile(list(jeng.planner.plans.values()), shapes)
    n_t = teng.warm_compile(list(teng.planner.plans.values()), shapes)
    assert n_t == n_j == 12
    assert tcache.stats == jcache.stats
    count = tcache.tracer.count
    bursts = [ps, ps[2:3]]                  # narrow, then full
    jres = [r for b in bursts for r in jeng.generate(
        [jserving.Request(prompt=p, max_new_tokens=NEW) for p in b])]
    tres = [r for b in bursts for r in teng.generate(
        [Request(prompt=p, max_new_tokens=NEW) for p in b])]
    uncached = ServeEngine(cast, tc, max_len=32, batch_slots=4,
                           device="cpu",
                           planner=_planner(tserving, TPU_V5E, tc, "cpu"),
                           swapper=WidthSwapper(cast, tc))
    eres = [r for b in bursts for r in uncached.generate(
        [Request(prompt=p, max_new_tokens=NEW) for p in b])]
    for a, b in zip(eres, tres):
        assert np.array_equal(a.tokens, b.tokens)
    _assert_greedy_follows(jc, jeng.swapper.apply(
        jeng.planner.plans["narrow"])[0], jres[:4], tres[:4], ps, NEW)
    _assert_greedy_follows(jc, jparams, jres[4:], tres[4:], ps[2:3], NEW)
    assert [p.traffic.name for p in teng.plan_log] == ["narrow", "full"]
    for k in ("hits", "misses", "fallbacks", "aot_compiles"):
        assert tcache.stats[k] == jcache.stats[k], k
    assert tcache.stats["hits"] == 2 * NEW and tcache.stats["misses"] == 0
    assert tcache.tracer.count == count
    assert tcache.active_key == jcache.active_key == tcache.full_key
