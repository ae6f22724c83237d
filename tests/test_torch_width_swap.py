"""The port's width swapper against ``repro``'s, on the CPU.

``materialize`` is a cut and a zeroing, so the port's output on converted
params equals ``repro``'s, converted, bit for bit (sliced and masked). The
sliced forward equals the masked forward on the plain path within 1e-5
(as ``repro``'s own test: the fp32 products sum a different number of
exact zeros, in an order the CPU's BLAS may change with the length).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced
from repro.core import TPU_V5E as J_HW
from repro.models import init_decode_state as j_init_decode_state
from repro.models import init_params as j_init_params
from repro.serving import TrafficClass as JTraffic
from repro.serving import WidthPlan as JWidthPlan
from repro.serving import WidthSwapper as JWidthSwapper
from repro.serving import serving_templates as j_templates
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import TPU_V5E
from repro_torch.interop import params_from_jax
from repro_torch.models import transformer as tfm
from repro_torch.serving import (
    SWAP_STEPS, TrafficClass, WidthPlan, WidthSwapper, serving_templates,
)
from test_torch_recurrent import one_torch_thread  # noqa: F401


def make_cfgs(arch="qwen1.5-0.5b", gqa=False, **kw):
    kw.setdefault("d_model", 32)
    kw.setdefault("n_layers", 3)
    kw.setdefault("n_heads", 4)
    kw.setdefault("d_ff", 48)
    kw.setdefault("vocab", 64)
    jc = jax_reduced(jax_get_config(arch), **kw)
    tc = reduced_config(get_config(arch), **kw)
    if gqa and jc.n_kv_heads == jc.n_heads:
        jc = dataclasses.replace(jc, n_kv_heads=jc.n_heads // 2)
        tc = dataclasses.replace(tc, n_kv_heads=tc.n_heads // 2)
    return jc, tc


def plan(widths, modules, name="t", tokens=256, cls=WidthPlan,
         traffic=TrafficClass):
    return cls(traffic=traffic(name, tokens), widths=widths, latency_s=1.0,
               baseline_latency_s=2.0, satisfied=True, modules=modules)


def random_widths(cfg, modules, seed):
    rng = np.random.default_rng(seed)
    widths = {}
    for name, ref in modules.items():
        if rng.random() < 0.3:
            continue        # unplanned layers keep canonical width
        if ref.site == "mlp":
            widths[name] = int(rng.integers(1, cfg.d_ff + 1))
        else:
            widths[name] = int(rng.integers(1, cfg.n_heads * cfg.head_dim
                                            + 1))
    return widths


def tree_equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(tree_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


LAYOUTS = {
    "mha": dict(arch="qwen1.5-0.5b"),
    "gqa": dict(arch="deepseek-7b", gqa=True),
    # 3-layer cycle at 4 layers: a stack of ONE unit plus an 'extra' layer
    "single_unit_and_extra": dict(arch="recurrentgemma-2b", n_layers=4),
}


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def layout(request):
    jc, tc = make_cfgs(**LAYOUTS[request.param])
    host = jax.device_get(j_init_params(jax.random.PRNGKey(0), jc))
    _, jmods = j_templates(jc, J_HW, tokens=256, sites=("mlp", "attn"))
    _, tmods = serving_templates(tc, TPU_V5E, tokens=256,
                                 sites=("mlp", "attn"))
    return request.param, jc, tc, host, jmods, tmods


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_materialize_equals_reference(layout, seed):
    _, jc, tc, host, jmods, tmods = layout
    jsw = JWidthSwapper(jax.tree.map(jnp.asarray, host), jc)
    tsw = WidthSwapper(params_from_jax(host), tc)
    widths = random_widths(tc, tmods, seed)
    if seed == 0:   # every module cut, so each group slices
        widths = {n: 1 for n in tmods}
    jm, jh = jsw.realize(widths, jmods)
    tm, th = tsw.realize(widths, tmods)
    assert np.array_equal(jm, tm) and np.array_equal(jh, th)
    for pad in (False, True):
        want = params_from_jax(jax.device_get(
            jsw.materialize(jm, jh, pad_to_full=pad)))
        got = tsw.materialize(tm, th, pad_to_full=pad)
        assert tree_equal(got, want), pad


def test_cut_tensors_are_contiguous(layout):
    """The MLP kernel takes contiguous weights: every cut leaf is."""
    _, _, tc, host, _, tmods = layout
    sw = WidthSwapper(params_from_jax(host), tc)
    mlp_w, heads = sw.realize({n: 1 for n in tmods}, tmods)

    def walk(tree):
        if isinstance(tree, dict):
            return all(walk(v) for v in tree.values())
        return tree.is_contiguous()
    assert walk(sw.materialize(mlp_w, heads))


@pytest.fixture(scope="module")
def served():
    """A reduced qwen and a GQA deepseek the port's model runs, with their
    port params (fp32, CPU) and module maps."""
    out = {}
    for name, kw in (("mha", LAYOUTS["mha"]), ("gqa", LAYOUTS["gqa"])):
        jc, tc = make_cfgs(**kw)
        host = jax.device_get(j_init_params(jax.random.PRNGKey(1), jc))
        _, mods = serving_templates(tc, TPU_V5E, tokens=256,
                                    sites=("mlp", "attn"))
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, tc.vocab_size, size=(2, 7)))
        out[name] = (tc, params_from_jax(host), mods, toks)
    return out


@pytest.mark.parametrize("kind", ["mha", "gqa"])
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_sliced_forward_equals_masked_forward(served, kind, seed):
    cfg, params, mods, toks = served[kind]
    sw = WidthSwapper(params, cfg)
    mlp_w, heads = sw.realize(random_widths(cfg, mods, seed), mods)
    with torch.inference_mode():
        a, _ = tfm.forward(tfm.cast_params(sw.materialize(mlp_w, heads),
                                           "cpu"), cfg, tokens=toks,
                           mode="prefill")
        b, _ = tfm.forward(tfm.cast_params(
            sw.materialize(mlp_w, heads, pad_to_full=True), "cpu"), cfg,
            tokens=toks, mode="prefill")
    np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_warm_swap_is_a_lookup_and_full_plan_is_the_tree(served):
    cfg, params, mods, _ = served["mha"]
    sw = WidthSwapper(params, cfg)
    p = plan({"mlp0": 8, "attn1": cfg.head_dim}, mods)
    first, ev1 = sw.apply(p)
    again, ev2 = sw.apply(p)
    assert not ev1.cache_hit and ev2.cache_hit and again is first
    assert dict(ev2.realized)["mlp0"] == 8
    masked, ev3 = sw.apply(p, masked=True)
    assert not ev3.cache_hit and ev3.masked and masked is not first
    full, ev4 = sw.apply(plan({}, mods))
    assert full is params and not ev4.masked


def test_plan_cache_is_lru_bounded(served):
    cfg, params, mods, _ = served["mha"]
    sw = WidthSwapper(params, cfg, max_plans=2)
    plans = [plan({"mlp0": w}, mods) for w in (8, 16, 24)]
    for p in plans:
        sw.apply(p)
    assert len(sw._cache) == 2
    assert sw.apply(plans[2])[1].cache_hit
    assert not sw.apply(plans[0])[1].cache_hit     # evicted first


@pytest.mark.parametrize("step", SWAP_STEPS)
def test_rollback_at_every_step(served, step):
    cfg, params, mods, _ = served["mha"]

    def hook(name):
        if name == step:
            raise RuntimeError(f"injected at {name}")
    sw = WidthSwapper(params, cfg, fault_hook=hook)
    p = plan({"mlp0": 8}, mods, name="narrow")
    got, ev = sw.apply_guarded(p)
    assert got is params and ev.outcome == "rolled_back"
    assert ev.plan_name == "narrow" and step in ev.error
    assert ev.cache_hit is False
    # a failure before the commit leaves no half-built plan behind
    if SWAP_STEPS.index(step) < SWAP_STEPS.index("commit"):
        assert not sw._cache
    sw.fault_hook = None
    got, ev = sw.apply_guarded(p)
    assert ev.outcome == "ok" and got is not params
    # one stacked group: cut to its widest layer, layer 0 zeroed past 8
    w_up = got["decoder"]["stack"]["u0"]["mlp"]["w_up"]
    assert not w_up[0, :, 8:].any() and w_up[1, :, 8:].all()


def test_plan_without_modules_raises(served):
    cfg, params, mods, _ = served["mha"]
    sw = WidthSwapper(params, cfg)
    for fn in (sw.apply, sw.apply_guarded):
        with pytest.raises(ValueError, match="module mapping"):
            fn(plan({"mlp0": 8}, None))
    with pytest.raises(ValueError, match="no address"):
        sw.apply(plan({"nope": 8}, mods))


def test_reshape_states_matches_reference():
    """Shrinking slices the K/V head prefix, growing zero-fills; equal to
    repro's on the same states."""
    jc, tc = make_cfgs(**LAYOUTS["gqa"])
    host = jax.device_get(j_init_params(jax.random.PRNGKey(0), jc))
    jsw = JWidthSwapper(jax.tree.map(jnp.asarray, host), jc)
    tsw = WidthSwapper(params_from_jax(host), tc)
    rng = np.random.default_rng(0)
    states = jax.device_get(jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(
            np.float32)).astype(x.dtype),
        j_init_decode_state(jc, 2, 16)))
    full = np.full(tc.n_layers, tc.n_heads, np.int64)
    half = np.maximum(full // 2, 1)
    down_j = jsw.reshape_states(jax.tree.map(jnp.asarray, states), full,
                                half)
    down_t = tsw.reshape_states(params_from_jax(states), full, half)
    assert tree_equal(down_t, params_from_jax(jax.device_get(down_j)))
    kv = tc.n_kv_heads // 2
    assert down_t["stack"]["u0"]["k"].shape[-2] == kv
    back_j = jsw.reshape_states(down_j, half, full)
    back_t = tsw.reshape_states(down_t, half, full)
    assert tree_equal(back_t, params_from_jax(jax.device_get(back_j)))
    assert not back_t["stack"]["u0"]["k"][..., kv:, :].any()
    same = params_from_jax(states)
    assert tsw.reshape_states(same, full, full)["stack"]["u0"]["k"] \
        is same["stack"]["u0"]["k"]
    assert tsw.reshape_states(None, full, full) is None


def test_swap_events_match_reference(served):
    """The same plans give the same keys and realized widths."""
    jc, tc = make_cfgs(**LAYOUTS["mha"])
    host = jax.device_get(j_init_params(jax.random.PRNGKey(0), jc))
    _, jmods = j_templates(jc, J_HW, tokens=256, sites=("mlp", "attn"))
    _, tmods = serving_templates(tc, TPU_V5E, tokens=256,
                                 sites=("mlp", "attn"))
    jsw = JWidthSwapper(jax.tree.map(jnp.asarray, host), jc)
    tsw = WidthSwapper(params_from_jax(host), tc)
    for seed in range(4):
        widths = random_widths(tc, tmods, seed)
        _, je = jsw.apply(plan(widths, jmods, cls=JWidthPlan,
                               traffic=JTraffic))
        _, te = tsw.apply(plan(widths, tmods))
        assert (je.key, je.realized, je.cache_hit, je.plan_name) == \
            (te.key, te.realized, te.cache_hit, te.plan_name)
