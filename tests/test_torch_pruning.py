"""The port's pruning baselines (``repro_torch.core.pruning``), the
tail-aware discretization and Table 2's pipeline
(``repro_torch.launch.pruning_opt``) against the JAX package's, on the CPU.

Tolerances: HRank's scores exactly (means of integer ranks, counted from
fp32 singular values on the same inputs), except for a map with a
singular value within a factor 2 of the rank threshold, whose count two
SVD libraries may differ on by one; SOFT's L2 norms within 1e-6
relative (two fp32 reductions in other orders); filter choices, plans and
discretized widths exactly. The pipeline, with ``--hw tpu_lite`` at 2
train and 1 finetune step: widths, params, FLOPs and modeled latency
exactly, and each accuracy within 1/128 (a sample's argmax may flip
between two fp32 forwards that differ by 1e-6, and 1/256 is one of the 256
eval samples). The GPU form's witness (:func:`table2_witness`) likewise,
at 2 train and 1 finetune step.

Run as a script, this file prints the witness at full steps (150 train,
80 finetune) for seeds 0 and 1 at latency batch and image (32, 16) and
(64, 32): each method's widths and accuracy from the port and from
``repro``'s own pipeline on the same init, Ours at the GPU form's widths.

    JAX_PLATFORMS=cpu PYTHONPATH=src:. python tests/test_torch_pruning.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_recurrent import one_torch_thread  # noqa: F401
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # minimal env: deterministic in-repo fallback
    from _hypothesis_fallback import given, settings, st

from benchmarks import pruning_opt as jpo
from repro.core import TPU_LITE as J_TPU_LITE
from repro.core import TPU_V5E as J_TPU_V5E
from repro.core import TunableLayer as JTunable
from repro.core import analytic_candidates as janalytic
from repro.core import discretize_pruning_space as jdiscretize
from repro.core import pruning as jpruning
from repro.models import convnet as jcn
from repro_torch.core import (
    H100_SXM, TPU_LITE, TPU_V5E, TunableLayer, analytic_candidates,
    discretize_pruning_space, pruning,
)
from repro_torch.core.tail_model import CtaWaveModel
from repro_torch.interop import params_from_jax
from repro_torch.launch import pruning_opt as po
from repro_torch.models import convnet as cn


@pytest.fixture(scope="module")
def ref_init():
    """The reference's init as its Table 2 run makes it (eagerly; the
    pipeline test's reference run then reuses the compiled draws)."""
    return jax.device_get(jcn.init_convnet(
        jax.random.PRNGKey(0), jcn.DEFAULT_WIDTHS, image=jpo.IMAGE))


# ---------------------------------------------------------------------------
# the criteria
# ---------------------------------------------------------------------------
def test_rank_scores_on_the_reference_tests_input():
    """tests/test_pruning.py:17-23's input: random maps, three constant
    channels."""
    acts = jax.random.normal(jax.random.PRNGKey(0), (4, 16, 16, 8))
    acts = acts.at[..., :3].set(1.0)
    want = jpruning.feature_map_rank_scores(acts)
    got = pruning.feature_map_rank_scores(torch.tensor(np.asarray(acts)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got[:3].max() < got[3:].min()


def near_threshold(a: np.ndarray, tol=None) -> np.ndarray:
    """Per channel of (B, H, W, C) ``a``, the maps with a singular value
    within a factor 2 of HRank's threshold: there two SVD libraries (the
    reference's and PyTorch's LAPACK) may count a noise-level value on
    either side."""
    b, h, w, c = a.shape
    sv = torch.linalg.svdvals(torch.from_numpy(a.copy()).permute(
        0, 3, 1, 2).reshape(b * c, h, w))
    th = sv[:, :1] * (tol if tol is not None
                      else max(h, w) * torch.finfo(torch.float32).eps)
    return ((sv > th / 2) & (sv < th * 2)).any(-1).reshape(b, c).sum(0) \
        .numpy()


def test_rank_scores_on_the_nets_activations(ref_init):
    """The converted net's ReLU activations on Table 2's probe batch
    (rank-deficient maps: zero rows and columns), and an explicit ``tol``:
    the reference's scores exactly in every channel none of whose maps has
    a singular value within a factor 2 of the threshold; elsewhere at most
    one rank (1/batch) per such map apart. On this input one of conv2's
    320 scores differs: one of its 10240 maps has a singular value 2 %
    above the threshold, which one library counts and the other not."""
    probe = jcn.synthetic_cifar(77, 32, jpo.IMAGE)
    _, wacts = jcn.forward_convnet(ref_init, probe["images"],
                                   collect_acts=True)
    _, acts = cn.forward_convnet(params_from_jax(ref_init),
                                 cn.synthetic_cifar(77, 32, jpo.IMAGE)[
                                     "images"], collect_acts=True)
    flipped = 0
    for name, a in wacts.items():
        a = np.asarray(a)
        for tol in (None, 1e-3):
            want = jpruning.feature_map_rank_scores(a, tol=tol)
            assert len(np.unique(want)) < len(want)     # ties
            near = near_threshold(a, tol)
            for got in (pruning.feature_map_rank_scores(
                    torch.from_numpy(a.copy()), tol=tol),
                    # the port's own activations, 1e-6 away
                    pruning.feature_map_rank_scores(acts[name], tol=tol)):
                np.testing.assert_array_equal(got[near == 0],
                                              want[near == 0])
                assert (np.abs(got - want) <= near / a.shape[0]).all()
                flipped += int((got != want).sum())
    assert flipped <= 4


@pytest.mark.parametrize("shape", [(3, 3, 4, 6), (3, 3, 127, 211), (40, 7)])
def test_l2_scores(shape):
    k = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        np.float32)
    got = pruning.l2_filter_scores(torch.from_numpy(k))
    np.testing.assert_allclose(got, jpruning.l2_filter_scores(jnp.asarray(k)),
                               rtol=1e-6)
    assert got.dtype == np.float32


@given(keep=st.integers(0, 20), seed=st.integers(0, 1000))
@settings(max_examples=30, deadline=None)
def test_keep_indices_ties(keep, seed):
    """Scores drawn from a few values (HRank's means of integer ranks tie
    often): the same filters as the reference, so ties break alike."""
    scores = np.random.default_rng(seed).integers(0, 4, 16).astype(
        np.float32) / 4
    np.testing.assert_array_equal(pruning.keep_indices(scores, keep),
                                  jpruning.keep_indices(scores, keep))
    np.testing.assert_array_equal(pruning.soft_prune_mask(scores, keep),
                                  jpruning.soft_prune_mask(scores, keep))


def test_keep_indices_all_tied():
    scores = np.full(10, 3.5, np.float32)
    for keep in (1, 4, 10):
        np.testing.assert_array_equal(pruning.keep_indices(scores, keep),
                                      jpruning.keep_indices(scores, keep))


def test_plans():
    base = {"conv0": 128, "conv1": 192, "conv2": 320, "conv3": 448, "x": 1}
    for ratio in (0.66, 0.5, 0.01, 1.3):
        assert pruning.uniform_flops_plan(base, ratio) == \
            jpruning.uniform_flops_plan(base, ratio)
    rng = np.random.default_rng(0)
    scores = {n: rng.integers(0, 5, w).astype(np.float32)
              for n, w in base.items()}
    targets = pruning.uniform_flops_plan(base, 0.66)
    got = pruning.build_plan(lambda n: scores[n], targets)
    want = jpruning.build_plan(lambda n: scores[n], targets)
    assert got.widths == want.widths
    assert got.total_width == want.total_width
    for n in want.indices:
        np.testing.assert_array_equal(got.indices[n], want.indices[n])


@pytest.mark.parametrize("hw_pair", [(TPU_LITE, J_TPU_LITE),
                                     (TPU_V5E, J_TPU_V5E)])
@pytest.mark.parametrize("batch", [1, 32])
def test_discretize_pruning_space(hw_pair, batch):
    """Section 4.4's snap of continuous targets onto the tail-free
    candidates, on the Table 2 convnet's layers."""
    hw, jhw = hw_pair
    shapes = cn.conv_layer_shapes((128, 192, 320, 448), batch=batch,
                                  image=16)
    jshapes = jcn.conv_layer_shapes((128, 192, 320, 448), batch=batch,
                                    image=16)
    layers = [TunableLayer(layer=s, candidates=analytic_candidates(
        hw, s, max_width=2 * s.width, min_width=8), params_per_unit=s.d_in)
        for s in shapes]
    jlayers = [JTunable(layer=s, candidates=janalytic(
        jhw, s, max_width=2 * s.width, min_width=8), params_per_unit=s.d_in)
        for s in jshapes]
    rng = np.random.default_rng(batch)
    for _ in range(5):
        targets = {s.name: int(rng.integers(1, 2 * s.width)) for s in shapes}
        assert discretize_pruning_space(layers, targets) == \
            jdiscretize(jlayers, targets)


# ---------------------------------------------------------------------------
# Table 2's pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("widths", [(84, 127, 211, 296), (84, 127, 128, 256),
                                    (128, 192, 320, 448)])
def test_model_latency_and_tunables(widths):
    assert po.model_latency(widths) == jpo.model_latency(widths)
    for got, want in zip(po.tunables(widths), jpo.tunables(widths)):
        np.testing.assert_array_equal(got.candidates, want.candidates)
        assert got.params_per_unit == want.params_per_unit
        assert got.layer.tokens == want.layer.tokens


def test_pipeline_matches_reference(ref_init):
    """``run`` with ``--hw tpu_lite`` at 2 train and 1 finetune step, from
    the reference's own init, against ``benchmarks/pruning_opt.run``."""
    csv, jcsv = [], []
    want = jpo.run(jcsv, verbose=False, train_steps=2, finetune_steps=1)
    out = po.run(csv, verbose=False, train_steps=2, finetune_steps=1,
                 hw="tpu_lite", device="cpu",
                 params=params_from_jax(ref_init))
    assert out["hw"] == "tpu_lite" and out["csv"] == csv[0]
    assert [r["method"] for r in out["rows"]] == \
        [r["method"] for r in want]
    for got, ref in zip(out["rows"], want):
        for key in ("widths", "params", "flops", "latency_us", "tflops"):
            assert got[key] == ref[key], (got["method"], key)
        assert abs(got["acc"] - ref["acc"]) <= 1 / 128
        assert "timed" not in got
    assert set(out["reductions"]) == {"latency_us"}
    assert csv[0][0] == jcsv[0][0] and csv[0][2] == jcsv[0][2]


def test_pipeline_gpu_form():
    """The default spec on the CPU is ``H100_SXM`` (``CtaWaveModel``): at
    latency batch 32 Algorithm 2 cuts conv0 and conv1 to one CTA column,
    the modeled reduction the GPU form predicts, and each row's latency is
    the model's sum over the conv products."""
    out = po.run(verbose=False, train_steps=1, finetune_steps=1,
                 eval_steps=1, device="cpu", batch=32)
    assert out["hw"] == H100_SXM.name
    rows = {r["method"]: r for r in out["rows"]}
    for m in po.METHODS:
        assert rows[m]["widths"] == [84, 127, 211, 296]
        assert rows[f"{m}+Ours"]["widths"] == [64, 64, 211, 296]
        assert out["reductions"]["latency_us"][m] > 0.2
    model = CtaWaveModel(H100_SXM)
    for r in out["rows"] + [out["base"]]:
        want = sum(model.latency_batch(s, [s.width])[0] for s in
                   cn.conv_layer_shapes(r["widths"], batch=32, image=16))
        assert r["latency_us"] == pytest.approx(want * 1e6, rel=1e-12)


def test_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        po.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        po.run(train_steps=0, finetune_steps=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        po.run(train_steps=0, finetune_steps=0, device="cpu", timed=True)


# ---------------------------------------------------------------------------
# the GPU form's widths through repro's own pipeline: a witness for Ours'
# accuracy at widths repro's TPU model never picks
# ---------------------------------------------------------------------------
def reference_rows(init, ours: dict, *, train_steps: int,
                   finetune_steps: int, image: int) -> dict:
    """``repro``'s own Table 2 steps (``benchmarks/pruning_opt``'s train
    and eval_acc, ``repro``'s pruning criteria and ``prune_convnet``) from
    ``init`` at ``image``, each method's Ours pruned to the widths
    ``ours[method]`` gives: method -> (widths, accuracy)."""
    old, jpo.IMAGE = jpo.IMAGE, image     # the reference reads its constant
    try:
        params, _ = jpo.train(init, train_steps)
        probe = jcn.synthetic_cifar(77, 32, image)
        _, acts = jcn.forward_convnet(params, probe["images"],
                                      collect_acts=True)
        names = jcn.conv_names(jcn.DEFAULT_WIDTHS)
        full = dict(zip(names, jcn.DEFAULT_WIDTHS))
        out = {}
        for method in po.METHODS:
            if method == "HRank":
                def score_fn(n):
                    return jpruning.feature_map_rank_scores(acts[n])
            else:
                def score_fn(n):
                    return jpruning.l2_filter_scores(params[n]["kernel"])
            for tag, targets in (
                    (method, jpruning.uniform_flops_plan(full, po.RATIO)),
                    (f"{method}+Ours", dict(zip(names, ours[method])))):
                plan = jpruning.build_plan(score_fn, targets)
                pruned, _ = jpo.train(jcn.prune_convnet(params, plan.indices),
                                      finetune_steps, lr=po.FINETUNE_LR)
                out[tag] = ([plan.widths[n] for n in names],
                            jpo.eval_acc(pruned))
    finally:
        jpo.IMAGE = old
    return out


def table2_witness(seed: int, batch: int, image: int, *, train_steps: int,
                   finetune_steps: int) -> list:
    """The port's pipeline on the GPU form (``H100_SXM``) on the CPU from
    ``repro``'s init at ``PRNGKey(seed)``, and ``repro``'s own steps from
    the same init with each Ours at the port's widths: (method, widths,
    port's accuracy, repro's widths, repro's accuracy) per row."""
    init = jax.device_get(jcn.init_convnet(
        jax.random.PRNGKey(seed), jcn.DEFAULT_WIDTHS, image=image))
    out = po.run(verbose=False, train_steps=train_steps,
                 finetune_steps=finetune_steps, hw=H100_SXM, device="cpu",
                 batch=batch, image=image, params=params_from_jax(init))
    rows = {r["method"]: r for r in out["rows"]}
    ref = reference_rows(init, {m: rows[f"{m}+Ours"]["widths"]
                                for m in po.METHODS},
                         train_steps=train_steps,
                         finetune_steps=finetune_steps, image=image)
    return [(m, r["widths"], r["acc"]) + ref[m] for m, r in rows.items()]


def test_table2_witness():
    """At 2 train and 1 finetune step: the GPU form's Ours widths at
    latency batch 32, and every row's accuracy within 1/128 of
    ``repro``'s own steps on the same widths."""
    rows = table2_witness(0, 32, 16, train_steps=2, finetune_steps=1)
    assert [r[0] for r in rows] == ["HRank", "HRank+Ours", "SOFT",
                                    "SOFT+Ours"]
    for method, widths, acc, ref_widths, ref_acc in rows:
        assert widths == ref_widths == ([64, 64, 211, 296] if "Ours" in
                                        method else [84, 127, 211, 296])
        assert abs(acc - ref_acc) <= 1 / 128, method


if __name__ == "__main__":
    for seed in (0, 1):
        for batch, image in ((32, 16), (64, 32)):
            for method, widths, acc, _, ref_acc in table2_witness(
                    seed, batch, image, train_steps=po.TRAIN_STEPS,
                    finetune_steps=po.FINETUNE_STEPS):
                print(f"seed {seed} ({batch}, {image}) {method:>10} "
                      f"{widths}: accuracy port {acc:.4f}, repro "
                      f"{ref_acc:.4f}", flush=True)
