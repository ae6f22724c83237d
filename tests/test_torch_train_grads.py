"""``transformer.train_loss`` and every leaf's gradient against the JAX
package's ``jax.value_and_grad`` of its ``train_loss``, on the CPU, on
``repro``'s own init converted and the same numpy batches (with a loss
mask): the main path's qwen, granite's MoE layers with their aux terms, and the encoder-decoder (``src_embeds``).

Tolerances: the loss and metrics within METRIC_TOL relative (5e-3, set
from measured spreads in tests/test_torch_train.py); each
leaf's gradient, relative to its largest |grad| in ``repro``, within
max(4e-2, 2 x the spread between two right orders of ``repro`` itself: its
jitted gradients against the same gradients under ``jax.disable_jit()``),
measured on every run. The bf16 forward rounds at the same points in both
packages, but a sum's order moves a bf16 value by a step; the gradient of a
leaf whose true gradient is near 0 (a key bias, which softmax ignores) is
all such noise, and the spread shows how much.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtfm
from repro_torch.interop import params_from_jax
from repro_torch.models import transformer as ttfm
from repro_torch.train import step as tstep
from test_torch_recurrent import one_torch_thread  # noqa: F401 — autouse
from test_torch_train import (BATCH, METRIC_TOL, SEQ, batch_for, build,
                              flat, np32, to_jax, to_torch)

# jits the JAX model; the quick tier skips it with -m "not slow"
pytestmark = pytest.mark.slow

GRAD_FLOOR = 4e-2

# 4 experts: top-8 selects every one (see test_moe_metrics_with_routing for
# 16)
ARCHS = {
    "qwen-reduced": dict(),
    "granite-reduced": dict(arch="granite-moe-1b-a400m"),
    "seamless-reduced": dict(arch="seamless-m4t-medium"),
}


def _repro_grads(jc, host, batch, **kw):
    jp = jax.tree.map(jnp.asarray, host)
    jb = to_jax(batch)

    def f(p):
        return jtfm.train_loss(p, jb, jc, moe_strategy="dense", **kw)
    (jl, jm), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(jp)
    with jax.disable_jit():
        _, jg2 = jax.value_and_grad(f, has_aux=True)(jp)
    return jl, jm, jax.device_get(jg), jax.device_get(jg2)


def _hold_grads(tg, jg, jg2):
    """Each leaf within max(GRAD_FLOOR, 2 x repro's jit/eager spread) of
    repro's jitted gradient, relative to its largest |grad|."""
    tl, jl, jl2 = flat(tg), flat(jg), flat(jg2)
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, t), (_, a), (_, b) in zip(tl, jl, jl2):
        a, b, t = np32(a), np32(b), np32(t)
        assert t.shape == a.shape, path
        scale = max(float(np.abs(a).max()), 1e-30)
        spread = float(np.abs(b - a).max()) / scale
        err = float(np.abs(t - a).max()) / scale
        assert err <= max(GRAD_FLOOR, 2 * spread), (path, err, spread)


def check_family(kw: dict) -> None:
    """``train_loss`` and every leaf's gradient on repro's own init of the
    reduced config ``kw``, with the family's inputs (src_embeds, M-RoPE
    positions) and a loss mask."""
    jc, tc, host = build(kw)
    batch = batch_for(tc)
    mask = np.ones((BATCH, SEQ), np.float32)
    mask[0, :5] = 0.0
    batch["loss_mask"] = mask
    jl, jm, jg, jg2 = _repro_grads(jc, host, batch)
    tp = params_from_jax(host)
    tl, tm, tg = tstep.grads_fn(tp, to_torch(batch), tc, tstep.TrainConfig(
        remat="none", moe_strategy="dense"))
    assert float(tl) == pytest.approx(float(jl), rel=METRIC_TOL)
    assert set(tm) == set(jm) == {"loss", "moe_lb_loss", "moe_z_loss",
                                  "logz_mean"}
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=METRIC_TOL,
                                             abs=1e-6), k
    if tc.moe:
        assert float(tm["moe_lb_loss"]) > 0 and float(tm["moe_z_loss"]) > 0
    _hold_grads(tg, jg, jg2)


@pytest.mark.parametrize("variant", list(ARCHS))
def test_train_loss_and_grads_match_repro(variant):
    check_family(ARCHS[variant])


def test_moe_metrics_with_routing():
    """granite with 16 experts (top-8 picks among them): the loss and the
    aux terms' values. Most tokens route on a near tie there (gap < 0.1
    logit; test_torch_model.TIE_GAP), where the two packages' bf16
    roundings may pick another expert; a flipped expert changes the
    gradients of the experts' weights by O(1) of that token's share, so the
    gradients are held on 4 experts (test_train_loss_and_grads_match_repro)
    and the values here."""
    jc, tc, host = build(dict(arch="granite-moe-1b-a400m", n_experts=16))
    batch = batch_for(tc)
    jl, jm = jtfm.train_loss(jax.tree.map(jnp.asarray, host),
                             to_jax(batch), jc, moe_strategy="dense")
    with torch.no_grad():
        tl, tm = ttfm.train_loss(params_from_jax(host), to_torch(batch), tc,
                                 moe_strategy="dense")
    assert float(tl) == pytest.approx(float(jl), rel=METRIC_TOL)
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=METRIC_TOL), k
