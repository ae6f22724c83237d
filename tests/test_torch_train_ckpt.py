"""The port's checkpoints (``repro_torch.train.checkpoint``) against the JAX
package's on-disk layout, on the CPU: a checkpoint that either package
writes restores into the other, leaf for leaf and bit for bit, and the next
step's loss agrees; a partial save is ignored and ``keep`` is honoured; and
the training CLI's kill-and-resume, in process, equals the uninterrupted
run bit for bit.

Tolerances: restored leaves bit-equal (fp32, int32 and int8 go through
``.npy`` unchanged); the next step's loss on the two packages within
METRIC_TOL relative (5e-3, set from measured spreads in
tests/test_torch_train.py); the resumed CLI run's checkpoint and losses
bit-equal to the uninterrupted one (one process, one thread, the same
operations in the same order); an async save's files bit-equal to the tree
at the call.
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jckpt
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch.interop import params_from_jax
from repro_torch.launch import train as train_cli
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optim as toptim
from repro_torch.train import step as tstep
from test_torch_recurrent import one_torch_thread  # noqa: F401 — autouse
from test_torch_train import METRIC_TOL, batch_for, build, to_jax, to_torch

# jits the JAX model; the quick tier skips it with -m "not slow"
pytestmark = pytest.mark.slow


def _trained(quantize: bool):
    """Both packages one step into training from repro's init (so that the
    moments and count are not zero): (jc, tc, repro (params, state), port
    (params, state))."""
    jc, tc, host = build({})
    acfg_j = joptim.AdamWConfig(quantize_moments=quantize)
    acfg_t = toptim.AdamWConfig(quantize_moments=quantize)
    jfn = jax.jit(jstep.build_train_step(
        jc, jstep.TrainConfig(adamw=acfg_j, remat="none"),
        joptim.cosine_schedule(3e-3, 1, 10)))
    tfn = tstep.build_train_step(
        tc, tstep.TrainConfig(adamw=acfg_t, remat="none"),
        toptim.cosine_schedule(3e-3, 1, 10))
    jp = jax.tree.map(jnp.asarray, host)
    tp = params_from_jax(host)
    batch = batch_for(tc, step=0)
    jp, js, _ = jfn(jp, joptim.adamw_init(jp, acfg_j), to_jax(batch),
                    jnp.asarray(1))
    tp, ts, _ = tfn(tp, toptim.adamw_init(tp, acfg_t), to_torch(batch), 1)
    return jc, tc, (jp, js), (tp, ts), jfn, tfn


def _leaves_equal(jtree, ttree):
    jl = jax.tree.leaves(jtree)
    tl = tckpt.flatten(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(a, b.detach().numpy())


@pytest.mark.parametrize("quantize", [False, True])
def test_repro_checkpoint_restores_into_the_port(tmp_path, quantize):
    jc, tc, (jp, js), (tp, ts), jfn, tfn = _trained(quantize)
    jckpt.save(str(tmp_path), 1, (jp, js))
    assert tckpt.latest_step(str(tmp_path)) == 1
    rp, rs = tckpt.restore(str(tmp_path), 1, (tp, ts))
    assert isinstance(rs, toptim.AdamState)
    if quantize:
        leaf = rs.mu["embed"]["tok_emb"]
        assert isinstance(leaf, toptim.Quantized) and \
            leaf.q.dtype == torch.int8
    _leaves_equal((jp, js), (rp, rs))
    # the next step from the restored state, in each package
    batch = batch_for(tc, step=1)
    _, _, jm = jfn(jp, js, to_jax(batch), jnp.asarray(2))
    _, _, tm = tfn(rp, rs, to_torch(batch), 2)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                              rel=METRIC_TOL)


@pytest.mark.parametrize("quantize", [False, True])
def test_port_checkpoint_restores_into_repro(tmp_path, quantize):
    jc, tc, (jp, js), (tp, ts), jfn, tfn = _trained(quantize)
    tckpt.save(str(tmp_path), 1, (tp, ts))
    assert jckpt.latest_step(str(tmp_path)) == 1
    rp, rs = jckpt.restore(str(tmp_path), 1, (jp, js))
    _leaves_equal((rp, rs), (tp, ts))
    batch = batch_for(tc, step=1)
    _, _, jm = jfn(rp, rs, to_jax(batch), jnp.asarray(2))
    _, _, tm = tfn(tp, ts, to_torch(batch), 2)
    assert float(jm["loss"]) == pytest.approx(float(tm["loss"]),
                                              rel=METRIC_TOL)


def test_flatten_order_is_jax_tree_flatten():
    """Sorted dict keys, NamedTuples in field order, None holds no leaf;
    unflatten inverts flatten."""
    tree = {"b": torch.zeros(2), "a": {"z": torch.ones(1), "c": None},
            "s": toptim.AdamState(torch.zeros((), dtype=torch.int32),
                                  {"w": toptim.Quantized(
                                      torch.zeros(2, 3, dtype=torch.int8),
                                      torch.ones(2, 1))},
                                  {"w": torch.full((2, 3), 2.0)}, None)}
    jtree = jax.tree.map(lambda t: np.asarray(t), tree,
                         is_leaf=torch.is_tensor)
    want = [np.asarray(x) for x in jax.tree.leaves(jtree)]
    got = tckpt.flatten(tree)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    again = tckpt.unflatten(tree, [t + 1 for t in got])
    assert again["s"].comp is None and again["a"]["c"] is None
    assert torch.equal(again["s"].mu["w"].scale, torch.full((2, 1), 2.0))


def test_bf16_leaves_round_trip(tmp_path):
    """A bf16 master and its Kahan compensation (``bf16_kahan``) restore
    bit for bit through the 16-bit pattern."""
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(5, 7, generator=g).bfloat16()}
    state = toptim.adamw_init(params, toptim.AdamWConfig(
        master_dtype="bf16_kahan"))
    state.comp["w"].copy_(torch.randn(5, 7, generator=g).bfloat16() * 1e-3)
    tckpt.save(str(tmp_path), 3, (params, state))
    rp, rs = tckpt.restore(str(tmp_path), 3, (params, state))
    assert rp["w"].dtype == torch.bfloat16 and torch.equal(rp["w"],
                                                           params["w"])
    assert torch.equal(rs.comp["w"], state.comp["w"])


def test_partial_save_is_ignored_and_keep_is_honoured(tmp_path):
    params = {"w": torch.arange(6.0).reshape(2, 3)}
    state = toptim.adamw_init(params)
    tckpt.save(str(tmp_path), 3, (params, state))
    # a crash mid-save: a .tmp directory without a manifest
    os.makedirs(tmp_path / "step_7.tmp")
    (tmp_path / "step_7.tmp" / "arr_0.npy").write_bytes(b"garbage")
    assert tckpt.latest_step(str(tmp_path)) == 3
    assert jckpt.latest_step(str(tmp_path)) == 3
    for s in (4, 5, 6):
        t = tckpt.save(str(tmp_path), s, (params, state), keep=2,
                       blocking=s != 5)
        if t is not None:
            t.join()
    assert tckpt.list_steps(str(tmp_path)) == [5, 6]
    assert not (tmp_path / "step_7.tmp").exists()      # collected
    with pytest.raises(ValueError, match="arrays"):
        tckpt.restore(str(tmp_path), 6, params)


def test_async_save_holds_the_tree_as_it_was(tmp_path):
    """``save(blocking=False)`` writes the leaves as they were at the call,
    though an AdamW update changes them in place before the writer is
    joined."""
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(64, 96, generator=g),
              "b": torch.randn(96, generator=g).bfloat16()}
    acfg = toptim.AdamWConfig(quantize_moments=True)
    state = toptim.adamw_init(params, acfg)
    grads = {k: torch.randn(v.shape, generator=g).to(v.dtype)
             for k, v in params.items()}
    params, state, _ = toptim.adamw_update(grads, state, params, 1e-2, acfg)
    before = [x.clone() for x in tckpt.flatten((params, state))]
    t = tckpt.save(str(tmp_path), 1, (params, state), blocking=False)
    params, state, _ = toptim.adamw_update(grads, state, params, 1e-2, acfg)
    for x in tckpt.flatten((params, state)):
        x.add_(1)
    t.join()
    got = tckpt.flatten(tckpt.restore(str(tmp_path), 1, (params, state)))
    assert len(got) == len(before)
    for x, y in zip(got, before):
        assert torch.equal(x, y)


def _cli(ckpt_dir, steps=6):
    return ["--device", "cpu", "--reduced", "--steps", str(steps),
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(ckpt_dir),
            "--ckpt-every", "2", "--log-every", "100"]


def test_cli_kill_and_resume_is_exact(tmp_path, monkeypatch):
    """The CLI trains 6 steps with a checkpoint every 2; a second run gets
    SIGTERM while it loads step 3's batch, finishes that step, checkpoints
    at 4 and returns; a relaunch resumes at 4. Its losses and its final
    checkpoint equal the uninterrupted run's bit for bit."""
    full = train_cli.main(_cli(tmp_path / "full"))
    assert len(full) == 6 and tckpt.latest_step(str(tmp_path / "full")) == 6

    real = train_cli.make_source

    class Preempting:
        def __init__(self, cfg):
            self.src = real(cfg)

        def batch(self, step):
            if step == 3:
                signal.raise_signal(signal.SIGTERM)
            return self.src.batch(step)

    monkeypatch.setattr(train_cli, "make_source", Preempting)
    before = signal.getsignal(signal.SIGTERM)
    first = train_cli.main(_cli(tmp_path / "cut"))
    assert signal.getsignal(signal.SIGTERM) == before
    assert len(first) == 4 and tckpt.latest_step(str(tmp_path / "cut")) == 4
    monkeypatch.setattr(train_cli, "make_source", real)
    rest = train_cli.main(_cli(tmp_path / "cut"))
    assert first + rest == full
    a = tckpt.restore(str(tmp_path / "full"), 6, _like())
    b = tckpt.restore(str(tmp_path / "cut"), 6, _like())
    for x, y in zip(tckpt.flatten(a), tckpt.flatten(b)):
        assert torch.equal(x, y)


def _like():
    """The CLI's (params, state) structure for its --reduced qwen."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import init_params
    cfg = reduced_config(get_config("qwen1.5-0.5b"), n_layers=2, d_model=64)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    return params, toptim.adamw_init(params)


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.main(["--reduced", "--steps", "1"])
