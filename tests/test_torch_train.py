"""The port's training path (``repro_torch.train`` and
``transformer.train_loss``) against the JAX package's, on the CPU: the
reference's own ``init_params`` converted (``interop.params_from_jax``),
the same numpy batches.

Tolerances, each stated where it is used:
- data: bit-equal (both are the same numpy code);
- AdamW, per leaf over 3 updates on the same gradients: fp32 to 1e-6 of the
  leaf's largest value (both compute the same fp32 formulas; XLA and torch
  round pow, sqrt and a fused multiply-add at other last bits, a few fp32
  ulps, 6e-8 each); int8 moments: a code may land one step away where a
  value sits on a rounding midpoint in one package's last bit;
- losses and metrics: 5e-3 relative, set from measured spreads: five
  times the largest between two right orders of ``repro`` itself (its
  jitted train_loss or step against the same under ``jax.disable_jit()``:
  up to 1.0e-3, a grad norm; 8.2e-4, granite's 16-expert balance loss;
  losses up to 2.4e-4), and 3.4 times the largest gap measured between
  the port and ``repro`` (1.46e-3, a grad norm; 1.07e-3, granite's z
  loss; losses 2e-6 to 3.7e-4);
- the train step's params: see test_three_train_steps_match_repro.

The loss and every leaf's gradient of each family are held to ``repro``'s
in tests/test_torch_train_grads.py and tests/test_torch_train_families.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import data as jdata
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch.interop import params_from_jax
from repro_torch.models import transformer as ttfm
from repro_torch.train import data as tdata
from repro_torch.train import optim as toptim
from repro_torch.train import step as tstep
from test_torch_model import configs, jax_init
from test_torch_recurrent import (  # noqa: F401 — autouse
    one_torch_thread, perturb_fp32_reads)

# jits the JAX model; the quick tier skips it with -m "not slow"
pytestmark = pytest.mark.slow

METRIC_TOL = 5e-3
SEQ, BATCH = 32, 2

def flat(tree, prefix=()):
    """[(path, leaf)] of nested dicts in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def np32(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def build(kw, seed=0):
    jc, tc = configs(**kw)
    host = perturb_fp32_reads(jax.device_get(jax_init(seed, jc)))
    return jc, tc, host


def batch_for(tc, step=0, seq=SEQ, batch=BATCH, seed=0):
    src = tdata.SyntheticLM(tdata.DataConfig(
        vocab_size=tc.vocab_size, seq_len=seq, global_batch=batch,
        seed=seed))
    return tdata.augment_for_arch(src.batch(step), tc, seq, step)


def to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 11)])
def test_synthetic_batches_bit_equal(seed, step):
    kw = dict(vocab_size=1000, seq_len=48, global_batch=3, seed=seed)
    got = tdata.SyntheticLM(tdata.DataConfig(**kw)).batch(step)
    want = jdata.SyntheticLM(jdata.DataConfig(**kw)).batch(step)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("dtype", ["uint16", "uint32"])
def test_memmap_batches_bit_equal(tmp_path, dtype):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(5).integers(0, 60000, size=5000).astype(
        dtype).tofile(path)
    kw = dict(vocab_size=32000, seq_len=64, global_batch=4, seed=2,
              path=path, dtype=dtype)
    src = tdata.make_source(tdata.DataConfig(**kw))
    ref = jdata.make_source(jdata.DataConfig(**kw))
    assert isinstance(src, tdata.MemmapLM) and src.n_windows == ref.n_windows
    for step in (0, 1, 9):
        got, want = src.batch(step), ref.batch(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "qwen2-vl-7b",
                                  "qwen1.5-0.5b"])
def test_augment_for_arch_bit_equal(arch):
    jc, tc = configs(arch=arch)
    base = tdata.SyntheticLM(tdata.DataConfig(
        vocab_size=tc.vocab_size, seq_len=16, global_batch=2)).batch(4)
    got = tdata.augment_for_arch(dict(base), tc, 16, step=4)
    want = jdata.augment_for_arch(dict(base), jc, 16, step=4)
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def _opt_trees(seed=0):
    rng = np.random.default_rng(seed)
    params = {"a": {"w": rng.standard_normal((6, 40)).astype(np.float32)},
              "b": rng.standard_normal((33,)).astype(np.float32) * 0.1,
              "c": rng.standard_normal((3, 4, 16)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(np.shape(v)) * 0.05).astype(np.float32)
              for k, v in flat_dict(params).items()} for _ in range(3)]
    return params, grads


def flat_dict(tree):
    return {"/".join(p): v for p, v in flat(tree)}


def nest(flat_tree):
    out = {}
    for key, v in flat_tree.items():
        d = out
        parts = key.split("/")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


@pytest.mark.parametrize("form", ["f32", "q8", "bf16_kahan"])
def test_adamw_update_matches_repro(form):
    """Three updates of the same gradients, leaf by leaf: params, moments,
    compensation, count and grad norm. The port writes into its tensors in
    place and returns them."""
    cfg_kw = dict(quantize_moments=form == "q8",
                  master_dtype="bf16_kahan" if form == "bf16_kahan"
                  else "f32")
    jcfg, tcfg = joptim.AdamWConfig(**cfg_kw), toptim.AdamWConfig(**cfg_kw)
    params, grads = _opt_trees()
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_jax(params)
    if form == "bf16_kahan":
        jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
        tp = {k: v for k, v in nest({p: t.bfloat16() for p, t in
                                     flat_dict(tp).items()}).items()}
    js, ts = joptim.adamw_init(jp, jcfg), toptim.adamw_init(tp, tcfg)
    lr = joptim.cosine_schedule(1e-2, 1, 10)
    tlr = toptim.cosine_schedule(1e-2, 1, 10)
    for i, g in enumerate(grads):
        gt = nest(g)
        gj = jax.tree.map(jnp.asarray, gt)
        gtt = params_from_jax(gt)
        if form == "bf16_kahan":
            gj = jax.tree.map(lambda x: x.astype(jnp.bfloat16), gj)
            gtt = nest({p: t.bfloat16() for p, t in flat_dict(gtt).items()})
        jp, js, jm = joptim.adamw_update(gj, js, jp, lr(jnp.asarray(i + 1)),
                                         jcfg)
        ids = [id(t) for _, t in flat(tp)]
        tp, ts, tm = toptim.adamw_update(gtt, ts, tp, tlr(i + 1), tcfg)
        assert [id(t) for _, t in flat(tp)] == ids        # in place
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
    assert int(ts.count) == int(js.count) == 3
    for (path, a), (_, b) in zip(flat(jax.device_get(jp)), flat(tp)):
        a, b = np32(a), np32(b)
        if form == "bf16_kahan":
            # a bf16 master: the same value, or one bf16 step apart where
            # the fp32 sums round across a midpoint
            step = 2.0 ** (np.floor(np.log2(np.abs(a) + 1e-30)) - 7)
            assert np.all(np.abs(a - b) <= step), path
        else:
            assert np.abs(a - b).max() <= 1e-6 * np.abs(a).max(), path
    is_q = lambda x: isinstance(x, joptim.Quantized)
    for name in ("mu", "nu"):
        jl = jax.tree.leaves(getattr(js, name), is_leaf=is_q)
        tl = [t for _, t in flat(getattr(ts, name))]
        for a, b in zip(jl, tl):
            if form == "q8":
                assert isinstance(b, toptim.Quantized)
                assert b.q.dtype == torch.int8
                assert np.abs(np.asarray(a.q, np.int32)
                              - b.q.numpy().astype(np.int32)).max() <= 1
                np.testing.assert_allclose(b.scale.numpy(), np.asarray(
                    a.scale), rtol=1e-6)
            else:
                a, b = np32(a), np32(b)
                assert np.abs(a - b).max() <= 1e-6 * np.abs(a).max()
    if form == "bf16_kahan":
        for a, (_, b) in zip(jax.tree.leaves(js.comp), flat(ts.comp)):
            assert b.dtype == torch.bfloat16
            a, b = np32(a), np32(b)
            # the compensation is the bits a bf16 store lost: at most half
            # a bf16 step of the param, equal unless the stores differed
            assert np.abs(a - b).max() <= 2.0 ** -8 * 4


def test_q8_roundtrip_and_schedule():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 128)).astype(np.float32) * 0.1)
    z = toptim.quantize_q8(x)
    err = (toptim.dequantize_q8(z) - x).abs()
    assert bool((err <= x.abs().amax(-1, keepdim=True) / 127.0 + 1e-8).all())
    jz = joptim.quantize_q8(jnp.asarray(x.numpy()))
    assert np.abs(np.asarray(jz.q, np.int32)
                  - z.q.numpy().astype(np.int32)).max() <= 1
    lr_j, lr_t = joptim.cosine_schedule(3e-3, 5, 100), \
        toptim.cosine_schedule(3e-3, 5, 100)
    for s in (0, 1, 4, 5, 6, 50, 99, 100, 150):
        assert float(lr_t(s)) == pytest.approx(float(lr_j(jnp.asarray(s))),
                                               rel=1e-6, abs=1e-12)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def test_three_train_steps_match_repro():
    """Three ``build_train_step`` steps against repro's, from repro's init:
    each step's metrics within METRIC_TOL (lr to 1e-6), and the params after
    them. An element whose gradient is near 0 may take the other sign in
    the two packages, and Adam then moves it by lr the other way: each
    of the first steps moves an element by lr x |m^/(sqrt(v^) + eps)| <=
    1.001 lr (Cauchy-Schwarz over the bias-corrected moments' weights), so
    two runs part by at most 2.002 x the summed lr (plus weight decay's
    share of the difference, ~1e-4 of it). A leaf whose true gradient is
    near 0 (a key bias, which softmax ignores) reaches that bound: its
    gradients are rounding noise in both packages."""
    jc, tc, host = build({})
    tcj = jstep.TrainConfig(moe_strategy="dense", remat="none")
    tct = tstep.TrainConfig(moe_strategy="dense", remat="none")
    lr_j = joptim.cosine_schedule(3e-3, 1, 10)
    lr_t = toptim.cosine_schedule(3e-3, 1, 10)
    jfn = jax.jit(jstep.build_train_step(jc, tcj, lr_j))
    tfn = tstep.build_train_step(tc, tct, lr_t)
    jp = jax.tree.map(jnp.asarray, host)
    js = joptim.adamw_init(jp)
    tp = params_from_jax(host)
    ts = toptim.adamw_init(tp)
    lrs = 0.0
    for s in range(3):
        batch = batch_for(tc, step=s)
        jp, js, jm = jfn(jp, js, to_jax(batch), jnp.asarray(s))
        tp, ts, tm = tfn(tp, ts, to_torch(batch), s)
        assert set(tm) == set(jm)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        for k in ("loss", "total_loss", "logz_mean", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(jm[k]),
                                                 rel=METRIC_TOL), (s, k)
        lrs += float(jm["lr"])
    assert lrs > 0
    bound = 2.002 * lrs * (1 + 1e-3)
    for (path, a), (_, b) in zip(flat(jax.device_get(jp)), flat(tp)):
        d = np.abs(np32(a) - np32(b))
        assert d.max() <= bound, (path, d.max(), bound)


def test_microbatches_two_against_one():
    """Gradient accumulation over 2 microbatches against the whole batch,
    as repro's tests/test_train.py holds repro: the same loss and metrics,
    and gradients within 2 bf16 steps (2^-6) of each leaf's largest, since
    each microbatch's products round dW to bf16 apart (f32 accumulation).
    With bf16 accumulation, within 4 steps."""
    _, tc, host = build({})
    batch = to_torch(batch_for(tc, batch=4))
    tp = params_from_jax(host)
    l1, m1, g1 = tstep.grads_fn(tp, batch, tc, tstep.TrainConfig(
        remat="none"))
    for acc, tol in (("f32", 2.0 ** -6), ("bf16", 2.0 ** -5)):
        l2, m2, g2 = tstep.grads_fn(tp, batch, tc, tstep.TrainConfig(
            remat="none", microbatches=2, accum_dtype=acc))
        assert float(l2) == pytest.approx(float(l1), rel=1e-5)
        for k in m1:
            assert float(m2[k]) == pytest.approx(float(m1[k]), rel=1e-5,
                                                 abs=1e-7)
        for (path, a), (_, b) in zip(flat(g1), flat(g2)):
            assert b.dtype == (torch.bfloat16 if acc == "bf16"
                               else torch.float32)
            a, b = np32(a), np32(b)
            assert np.abs(a - b).max() <= tol * np.abs(a).max(), path


@pytest.mark.parametrize("variant", ["qwen-reduced", "granite-reduced"])
def test_remat_modes_equal(variant):
    """The four remat modes recompute the same operations in the same
    order, so the loss and every gradient are bit-equal (a "sqrt" stack
    needs 4 units: qwen at 4 layers)."""
    kw = dict(arch="granite-moe-1b-a400m") if variant == "granite-reduced" \
        else {}
    kw["n_layers"] = 4
    _, tc, host = build(kw)
    batch = to_torch(batch_for(tc))
    out = {}
    for remat in ttfm.REMAT:
        tp = params_from_jax(host)
        out[remat] = tstep.grads_fn(tp, batch, tc, tstep.TrainConfig(
            remat=remat, moe_strategy="dense"))
    l0, m0, g0 = out["none"]
    for remat, (l, m, g) in out.items():
        assert torch.equal(l, l0), remat
        for k in m0:
            assert torch.equal(m[k], m0[k]), (remat, k)
        for (path, a), (_, b) in zip(flat(g0), flat(g)):
            assert torch.equal(a, b), (remat, path)


def test_eval_step_and_forward_api():
    """``build_eval_step`` gives train_loss's metrics with no gradient, and
    ``forward`` keeps its (logits, states) return with ``remat``."""
    _, tc, host = build({})
    tp = params_from_jax(host)
    batch = to_torch(batch_for(tc))
    m = tstep.build_eval_step(tc, tstep.TrainConfig())(tp, batch)
    assert set(m) == {"loss", "moe_lb_loss", "moe_z_loss", "logz_mean",
                      "total_loss"}
    assert m["loss"].grad_fn is None
    logits, states = ttfm.forward(tp, tc, tokens=batch["tokens"],
                                  remat="full")
    assert states is None and logits.shape[:2] == batch["tokens"].shape
    with pytest.raises(ValueError, match="remat"):
        ttfm.forward(tp, tc, tokens=batch["tokens"], remat="half")
    assert dataclasses.asdict(tstep.TrainConfig()) == dataclasses.asdict(
        jstep.TrainConfig()) | {"adamw": dataclasses.asdict(
            toptim.AdamWConfig())}
