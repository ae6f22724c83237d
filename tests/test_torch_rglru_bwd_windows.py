"""The RG-LRU backward kernel's window walk (``csrc/rglru_scan_bwd.cu``)
transcribed in torch on the CPU, and the host's choice of its form
(``rglru.bwd_form``).

The transcription walks as the kernel does: each CTA a (batch row, strip
of 32 channels) pair, W zero-filled past its last channel to whole strips;
windows aligned to the window size from step 0 and walked from the end,
so the first one walked is ragged; a ring of slots, each window loaded
into slot j % stages over what an earlier window left there, holding
``a`` and ``dy`` over its steps and ``y`` one step earlier, zero-filled
before step 0 and past T, the row before step 0 then replaced by ``h0``;
each lane's carry walked in reverse with the kernel's roundings (an fp32
add and two fp32 multiplies a step, no fused multiply-add), steps past T
skipped; on the TMA route ``db`` and ``da`` staged over ``dy`` and ``a``
in the slot and stored from there, rows past T clipped, on the cp.async
route stored a step at a time. It
must equal ``rglru_bwd_ref`` bit for bit, as the kernel does on the card,
and agree within 2e-4 of the largest gradient (tests/test_kernels.py:23's
fp32 bound) with jax's vjp of ``repro``'s ``rglru_ref`` on the same numpy
inputs, as tests/test_torch_scan_grad.py holds the plain backward.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import rglru as rg
from test_torch_recurrent import one_torch_thread  # noqa: F401 — autouse

FP32_TOL = 2e-4


def walk_windows(a, y, h0, dy, dh_last, *, window: int, stages: int,
                 route: str):
    """(da, db, dh0) as the kernel walks them, in the form (``window``
    steps a window, ``stages`` ring slots) on ``route``."""
    channels = rg.BWD_CHANNELS
    b, t, w = a.shape
    strips = -(-w // channels)

    def strip_view(x):      # (B, ..., W) -> (B, strips, ..., channels)
        x = torch.nn.functional.pad(x, (0, strips * channels - w))
        x = x.reshape(*x.shape[:-1], strips, channels)
        return x.movedim(-2, 1)

    sa_, sy_, sdy_ = strip_view(a), strip_view(y), strip_view(dy)
    h0s = strip_view(h0)
    ag = torch.zeros_like(h0s) if dh_last is None else strip_view(dh_last)
    da, db = torch.zeros_like(sa_), torch.zeros_like(sa_)

    def box(x, start):      # steps [start, start + window), zero-filled
        steps = torch.arange(start, start + window)
        ok = (steps >= 0) & (steps < t)
        out = x.new_zeros(b, strips, window, channels)
        out[:, :, ok] = x[:, :, steps[ok]]
        return out

    # the ring, NaN until a load fills it: a read of what no load of this
    # window wrote shows in the result
    ring = torch.full((stages, 3, b, strips, window, channels), torch.nan)
    nwin = -(-t // window)
    for j in range(nwin):
        t0 = (nwin - 1 - j) * window
        sa, sdy, sy = ring[j % stages]
        sa.copy_(box(sa_, t0))
        sdy.copy_(box(sdy_, t0))
        sy.copy_(box(sy_, t0 - 1))
        if t0 == 0:
            sy[:, :, 0] = h0s
        n = min(window, t - t0)
        for r in range(n - 1, -1, -1):
            g = sdy[:, :, r] + ag
            d = g * sy[:, :, r]
            ag = sa[:, :, r] * g
            if route == "tma":
                sdy[:, :, r], sa[:, :, r] = g, d
            else:
                db[:, :, t0 + r], da[:, :, t0 + r] = g, d
        if route == "tma":
            db[:, :, t0:t0 + n] = sdy[:, :, :n]
            da[:, :, t0:t0 + n] = sa[:, :, :n]

    def unstrip(x):         # (B, strips, ..., channels) -> (B, ..., W)
        x = x.movedim(1, -2)
        return x.reshape(*x.shape[:-2], strips * channels)[..., :w]

    return unstrip(da), unstrip(db), unstrip(ag)


@functools.lru_cache(maxsize=None)
def inputs_and_jax(t: int, w: int, dh_last: bool):
    """Numpy inputs of a case (B 2) made from a seed, the plain forward's
    y on them, and jax's vjp of ``repro``'s ``rglru_ref``."""
    rng = np.random.default_rng(1000 * t + 10 * w + dh_last)
    a = rng.uniform(0.3, 0.999, (2, t, w)).astype(np.float32)
    bb = rng.standard_normal((2, t, w)).astype(np.float32)
    h0 = rng.standard_normal((2, w)).astype(np.float32)
    dy = rng.standard_normal((2, t, w)).astype(np.float32)
    dh = rng.standard_normal((2, w)).astype(np.float32) if dh_last \
        else np.zeros((2, w), np.float32)
    _, vjp = jax.vjp(jref.rglru_ref, jnp.asarray(a), jnp.asarray(bb),
                     jnp.asarray(h0))
    want = [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(dh)))]
    ta, tb, th0, tdy, tdh = (torch.from_numpy(x) for x in (a, bb, h0, dy,
                                                          dh))
    y, _ = rg.rglru_ref(ta, tb, th0)
    return (ta, y, th0, tdy, tdh if dh_last else None), want


@pytest.mark.parametrize("t", [1, 31, 32, 33, 97, 128, 300])
@pytest.mark.parametrize("w", [7, 33, 260])
@pytest.mark.parametrize("dh_last", [False, True])
@pytest.mark.parametrize("route", ["tma", "cp.async"])
@pytest.mark.parametrize("window", rg.BWD_WINDOWS)
def test_window_walk_equals_plain_and_jax(t, w, dh_last, route, window):
    """At each window, in a ring of 2 slots (reused from the third window
    on; the depth changes only which slot a window takes)."""
    args, want = inputs_and_jax(t, w, dh_last)
    got = walk_windows(*args, window=window, stages=2, route=route)
    for g, p in zip(got, rg.rglru_bwd_ref(*args)):
        assert torch.equal(g, p)
    for name, g, j in zip(("da", "db", "dh0"), got, want):
        scale = max(float(np.abs(j).max()), 1e-30)
        assert np.abs(g.numpy() - j).max() <= FP32_TOL * scale, name


def test_bwd_forms_fit_a_cta():
    """The compiled forms: one-warp CTAs, windows 32 and 64, 1-4 slots,
    each within a CTA's 232,448 B."""
    forms = rg.bwd_forms()
    assert rg.BWD_CHANNELS == 32
    assert forms == [(tw, s) for tw in (32, 64) for s in (1, 2, 3, 4)]
    assert all(rg.bwd_smem_bytes(*f) <= rg.MAX_SMEM == 232448
               for f in forms)
    assert rg.bwd_smem_bytes(32, 3) == 128 + 3 * 3 * 32 * 32 * 4 + 32
    assert rg.bwd_smem_bytes(64, 4) == 98464


def test_bwd_form_fills_one_wave_at_the_training_shape():
    """recurrentgemma-2b's training shape: 640 one-warp CTAs (strips of 128
    would give 160 CTAs, the busiest of 132 SMs 2 x 128 channels against 5
    x 32); windows of 32 and 3 slots, 37,024 B, 6 an SM, so all 640 run in
    one wave: 112 SMs hold 5 and 20 hold 4. A fourth slot (4 an SM) would
    take two waves."""
    f = rg.bwd_form(8, 128, 2560)
    assert f == {"ctas": 640, "channels": 32, "window": 32, "stages": 3,
                 "smem_bytes": 37024, "ctas_per_sm": 6, "waves": 1,
                 "busiest_ctas": 5, "route": "tma"}
    assert f["ctas"] - 4 * 132 == 112
    assert rg.bwd_ctas_per_sm(rg.bwd_smem_bytes(32, 4)) * 132 < 640
    g = rg.bwd_form(8, 128, 2500)
    assert (g["ctas"], g["window"], g["stages"], g["waves"],
            g["busiest_ctas"], g["route"]) == (632, 32, 3, 1, 5, "tma")


def test_bwd_form_routes():
    """The forward's route rules: TMA where W % 4 == 0 and the bases are
    16-byte aligned, else cp.async (W 2501, an odd base offset)."""
    f = rg.bwd_form(2, 97, 2501)
    assert (f["ctas"], f["channels"], f["window"], f["stages"],
            f["smem_bytes"], f["route"]) == (158, 32, 32, 4, 49312,
                                              "cp.async")
    assert rg.bwd_form(8, 128, 2560, aligned=False)["route"] == "cp.async"
    assert rg.bwd_form(1, 5, 7)["route"] == "cp.async"
    assert rg.bwd_form(1, 5, 8)["route"] == "tma"


def test_bwd_form_off_the_path():
    """T 2048 at batch 1 (80 CTAs, 52 SMs idle) and 4 (320, 3 an SM):
    windows of 64, as many slots as keep the busiest SM's CTAs resident;
    one step takes one slot of the smaller window; a grid past one wave
    counts its waves."""
    f = rg.bwd_form(1, 2048, 2560)
    assert (f["ctas"], f["window"], f["stages"], f["smem_bytes"],
            f["waves"], f["busiest_ctas"]) == (80, 64, 4, 98464, 1, 1)
    f = rg.bwd_form(4, 2048, 2560)
    assert (f["ctas"], f["window"], f["stages"], f["ctas_per_sm"],
            f["waves"], f["busiest_ctas"]) == (320, 64, 3, 3, 1, 3)
    f = rg.bwd_form(8, 1, 2560)
    assert (f["window"], f["stages"], f["smem_bytes"]) == (32, 1, 12448)
    f = rg.bwd_form(64, 128, 2560)
    assert (f["ctas"], f["channels"], f["waves"], f["busiest_ctas"]) == \
        (5120, 32, 3, 39)


def test_bwd_form_takes_the_fewest_waves_then_the_deepest_ring():
    """Fewer waves first: B 16 (1,280 CTAs) fits one wave only at one slot
    of 32 steps (16 an SM), and a ring of 2 would take two. Then the most
    steps in flight up to T, then the smaller window: B 12 x W 1408 (528
    CTAs) holds 128 steps either as 4 x 32 or 2 x 64, and takes 4 x 32;
    on 100 SMs both (4 an SM) would take two waves, and 3 x 32 (6 an SM)
    is the deepest ring that fits one."""
    f = rg.bwd_form(16, 128, 2560)
    assert (f["ctas"], f["window"], f["stages"], f["ctas_per_sm"],
            f["waves"]) == (1280, 32, 1, 16, 1)
    f = rg.bwd_form(12, 128, 1408)
    assert (f["ctas"], f["window"], f["stages"], f["waves"],
            f["busiest_ctas"]) == (528, 32, 4, 1, 4)
    f = rg.bwd_form(12, 128, 1408, sms=100)
    assert (f["window"], f["stages"], f["waves"]) == (32, 3, 1)
