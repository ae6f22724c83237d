"""Weight interop between the JAX package and the port, and the port's
own copy of the configs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import transformer as jtfm
from repro_torch import configs as tconfigs
from repro_torch.interop import params_from_jax, params_to_numpy
from repro_torch.models import transformer as ttfm
from test_torch_recurrent import one_torch_thread  # noqa: F401


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def assert_bit_equal(a, b):
    la, lb = list(leaves(a)), list(leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert x.tobytes() == y.tobytes(), path


@pytest.mark.parametrize("arch,kw", [
    ("qwen1.5-0.5b", dict(n_layers=2)),
    ("qwen1.5-0.5b", dict(n_layers=3, vocab=250)),
    ("yi-34b", dict(n_layers=2)),
])
def test_params_round_trip_is_bit_exact(arch, kw):
    cfg = jconfigs.reduced_config(jconfigs.get_config(arch), **kw)
    host = jax.device_get(jtfm.init_params(jax.random.PRNGKey(3), cfg))
    tparams = params_from_jax(host)
    for (path, a), (_, t) in zip(leaves(host), leaves(tparams)):
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype) == f"torch.{a.dtype}", path
    assert_bit_equal(params_to_numpy(tparams), host)


def test_bf16_states_round_trip_is_bit_exact():
    cfg = jconfigs.reduced_config(jconfigs.get_config("qwen1.5-0.5b"))
    rng = np.random.default_rng(0)
    states = jax.tree.map(
        lambda z: jnp.asarray(rng.standard_normal(z.shape), z.dtype),
        jtfm.init_decode_state(cfg, 2, 16))
    host = jax.device_get(states)
    back = params_to_numpy(params_from_jax(host))
    assert_bit_equal(back, host)
    tcfg = tconfigs.reduced_config(tconfigs.get_config("qwen1.5-0.5b"))
    port = params_to_numpy(ttfm.init_decode_state(tcfg, 2, 16))
    assert [(p, x.shape, x.dtype) for p, x in leaves(port)] == \
        [(p, x.shape, x.dtype) for p, x in leaves(host)]


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_configs_copied_faithfully(arch):
    assert tconfigs.list_archs() == jconfigs.list_archs()
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()
    jr, tr = jconfigs.reduced_config(j), tconfigs.reduced_config(t)
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    assert ttfm.layer_plan(t) == jtfm.layer_plan(j)
    assert ttfm.decoder_layer_refs(t) == jtfm.decoder_layer_refs(j)
