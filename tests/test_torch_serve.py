"""The port's serving engine and CLI against the JAX package's, with and
without width plans and admission control, and the port's independence
from JAX (CPU)."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced
from repro.models import transformer as jtfm
from repro import serving as jserving
from repro.core import TPU_V5E as J_HW
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch import serving as tserving
from repro_torch.configs import get_config, reduced_config
from repro_torch.core import TPU_V5E
from repro_torch.interop import params_from_jax
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve_batched import main as serve_batched_main
from repro_torch.launch.train import main as train_main
from repro_torch.models import transformer as ttfm
from repro_torch.serving import Request, ServeEngine
from test_torch_recurrent import (  # noqa: F401 — autouse
    perturb_fp32_reads, one_torch_thread)

ROOT = Path(__file__).resolve().parents[1]
TOL = 4e-2          # bf16 tolerance, relative to the largest logit
PROMPT_LENS = (8, 5, 12, 3)
NEW = 8


@pytest.fixture(scope="module")
def model():
    jc = jax_reduced(jax_get_config("qwen1.5-0.5b"))
    tc = reduced_config(get_config("qwen1.5-0.5b"))
    host = jax.device_get(jtfm.init_params(jax.random.PRNGKey(0), jc))
    # a larger embedding (std 0.5, tied) spreads the logits, so that most
    # greedy choices have a clear margin to test against
    host["embed"]["tok_emb"] = host["embed"]["tok_emb"] * 25
    return jc, tc, host


def prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).astype(np.int32)
            for n in PROMPT_LENS]


@pytest.mark.slow     # jits the JAX engine
def test_greedy_generate_matches_jax_engine(model):
    jc, tc, host = model
    ps = prompts(tc.vocab_size)
    jeng = JServeEngine(jax.tree.map(jnp.asarray, host), jc, max_len=32,
                        batch_slots=4)
    jres = jeng.generate([JRequest(prompt=p, max_new_tokens=NEW)
                          for p in ps])
    teng = ServeEngine(params_from_jax(host), tc, max_len=32,
                       batch_slots=4, device="cpu")
    tres = teng.generate([Request(prompt=p, max_new_tokens=NEW)
                          for p in ps])
    assert len(tres) == len(jres) == len(ps)

    # JAX's logits along its own tokens: the left-padded batch of prompt +
    # generated tokens, one forward; position plen-1+t predicts token t
    plen = max(PROMPT_LENS)
    seq = np.zeros((len(ps), plen + NEW - 1), np.int32)
    for i, (p, r) in enumerate(zip(ps, jres)):
        seq[i, plen - len(p):plen] = p
        seq[i, plen:] = r.tokens[:-1]
    logits, _, _ = jax.jit(lambda p, t: jtfm.forward(
        p, jc, tokens=t, mode="prefill"))(jax.tree.map(jnp.asarray, host),
                                          jnp.asarray(seq))
    logits = np.asarray(logits[:, plen - 1:, :jc.vocab_size]
                        .astype(jnp.float32))
    tol = TOL * np.abs(logits).max()
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    compared = 0
    for i, (j, t) in enumerate(zip(jres, tres)):
        assert t.tokens.dtype == np.int32 and len(t.tokens) == NEW
        for step in range(NEW):
            if margin[i, step] <= 2 * tol:
                break       # a near tie: the two may part from here on
            assert t.tokens[step] == j.tokens[step], (i, step)
            compared += 1
    assert compared >= NEW * len(ps) // 2


def _planner(pkg, hw, cfg, device=None):
    """A planner of ``pkg`` (repro's or the port's serving module) holding
    two hand-made plans on the MLP and attention sites: "narrow" (half the
    FFN, two of four heads) for 4 x 12 = 48 prompt tokens and "full" for
    one 12-token prompt, as tests/test_serving.py:178 builds them."""
    _, modules = pkg.serving_templates(cfg, hw, sites=("mlp", "attn"))
    kw = {} if device is None else {"device": device}
    planner = pkg.ServingWidthPlanner(hw, [], modules=modules, **kw)
    narrow = {name: (cfg.d_ff // 2 if ref.site == "mlp"
                     else 2 * cfg.head_dim)
              for name, ref in modules.items()}
    for name, tokens, widths in (("narrow", 48, narrow), ("full", 12, {})):
        planner.plans[name] = pkg.WidthPlan(
            traffic=pkg.TrafficClass(name, tokens), widths=widths,
            latency_s=1.0, baseline_latency_s=2.0, satisfied=True,
            modules=modules)
    return planner


def _assert_greedy_follows(jc, jparams, jres, tres, ps, new):
    """The port's greedy tokens equal the JAX engine's up to the first
    step where JAX's own logits (one forward along its tokens on
    ``jparams``) have a top-2 margin within twice the bf16 tolerance."""
    plen = max(len(p) for p in ps)
    seq = np.zeros((len(ps), plen + new - 1), np.int32)
    for i, (p, r) in enumerate(zip(ps, jres)):
        seq[i, plen - len(p):plen] = p
        seq[i, plen:] = r.tokens[:-1]
    logits, _, _ = jax.jit(lambda p, t: jtfm.forward(
        p, jc, tokens=t, mode="prefill"))(jparams, jnp.asarray(seq))
    logits = np.asarray(logits[:, plen - 1:, :jc.vocab_size]
                        .astype(jnp.float32))
    tol = TOL * np.abs(logits).max()
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    compared = 0
    for i, (j, t) in enumerate(zip(jres, tres)):
        assert len(t.tokens) == len(j.tokens) == new
        for step in range(new):
            if margin[i, step] <= 2 * tol:
                break
            assert t.tokens[step] == j.tokens[step], (i, step)
            compared += 1
    assert compared >= new * len(ps) // 2


def test_planned_serving_matches_jax_engine(model):
    """Greedy serving with a planner and a swapper: per batch, the same
    class, the same realized widths and cache hits, and the same tokens
    as the JAX engine on the same plans."""
    jc, tc, host = model
    ps = prompts(tc.vocab_size)
    jparams = jax.tree.map(jnp.asarray, host)
    jeng = JServeEngine(jparams, jc, max_len=32, batch_slots=4,
                        planner=_planner(jserving, J_HW, jc),
                        swapper=jserving.WidthSwapper(jparams, jc))
    cast = ttfm.cast_params(params_from_jax(host), "cpu")
    teng = ServeEngine(cast, tc, max_len=32, batch_slots=4, device="cpu",
                       planner=_planner(tserving, TPU_V5E, tc, "cpu"),
                       swapper=tserving.WidthSwapper(cast, tc))
    for reqs in ([ps], [ps, ps[2:3]]):      # narrow; narrow (warm), full
        jres = [r for b in reqs for r in jeng.generate(
            [JRequest(prompt=p, max_new_tokens=NEW) for p in b])]
        tres = [r for b in reqs for r in teng.generate(
            [Request(prompt=p, max_new_tokens=NEW) for p in b])]
        flat = [p for b in reqs for p in b]
        _assert_greedy_follows(jc, jeng.swapper.apply(
            jeng.planner.plans["narrow"])[0], jres[:4], tres[:4], flat[:4],
            NEW)
        if len(flat) > 4:
            _assert_greedy_follows(jc, jparams, jres[4:], tres[4:],
                                   flat[4:], NEW)
    assert [p.traffic.name for p in teng.plan_log] == \
        [p.traffic.name for p in jeng.plan_log] == \
        ["narrow", "narrow", "full"]
    fields = ("plan_name", "key", "realized", "cache_hit", "outcome",
              "masked")
    assert [tuple(getattr(e, f) for f in fields) for e in teng.swap_log] \
        == [tuple(getattr(e, f) for f in fields) for e in jeng.swap_log]
    assert [e.cache_hit for e in teng.swap_log] == [False, True, False]
    w_up = teng.swapper.apply(teng.planner.plans["narrow"])[0][
        "decoder"]["stack"]["u0"]["mlp"]["w_up"]
    assert w_up.shape[-1] == tc.d_ff // 2 and w_up.dtype == torch.bfloat16
    assert teng.swapper.apply(teng.planner.plans["full"])[0] is cast


class _Clock:
    """A virtual clock: advances only by the modeled batch costs."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += float(dt)


def test_admission_on_a_virtual_clock_matches_jax_engine(model):
    """Deadlines, shedding and batch telemetry on a virtual clock with a
    modeled batch cost: the same shed set, deadline misses, latencies
    and BatchStats as the JAX engine."""
    jc, tc, host = model
    rng = np.random.default_rng(5)
    ps = [rng.integers(0, tc.vocab_size, size=(4,)).astype(np.int32)
          for _ in range(10)]
    deadlines = [None, 0.05, 0.5, 0.02, None, 0.3, 0.1, 0.6, None, 0.2]

    def cost(plan, tokens):
        return 0.004 * tokens + (0.01 if plan is None else 0.0)

    def run(pkg, eng_cls, req_cls, params, cfg, **kw):
        eng = eng_cls(params, cfg, max_len=8, batch_slots=2,
                      admission=pkg.AdmissionControl(max_queue_batches=2,
                                                     target_batch_s=0.03),
                      clock=_Clock(), batch_cost_fn=cost, **kw)
        res = eng.generate([req_cls(prompt=p, max_new_tokens=2,
                                    deadline_s=d)
                            for p, d in zip(ps, deadlines)])
        return eng, res

    jeng, jres = run(jserving, JServeEngine, JRequest,
                     jax.tree.map(jnp.asarray, host), jc)
    teng, tres = run(tserving, ServeEngine, Request, params_from_jax(host),
                     tc, device="cpu")
    assert [r.shed for r in tres] == [r.shed for r in jres]
    assert any(r.shed for r in tres) and not all(r.shed for r in tres)
    assert [r.deadline_missed for r in tres] == \
        [r.deadline_missed for r in jres]
    assert any(r.deadline_missed for r in tres)
    assert [r.latency_s for r in tres] == [r.latency_s for r in jres]
    assert [(b.tokens, b.latency_s, b.plan_name, b.signal)
            for b in teng.batch_log] == \
        [(b.tokens, b.latency_s, b.plan_name, b.signal)
         for b in jeng.batch_log]
    assert (teng.admission.admitted, teng.admission.shed,
            teng.admission.batch_ewma) == (jeng.admission.admitted,
                                           jeng.admission.shed,
                                           jeng.admission.batch_ewma)


def test_engine_refuses_a_swapper_on_other_params(model):
    _, tc, host = model
    params = params_from_jax(host)
    with pytest.raises(ValueError, match="cast params"):
        ServeEngine(params, tc, device="cpu",
                    swapper=tserving.WidthSwapper(params, tc))
    eng = ServeEngine(params, tc, device="cpu")
    ServeEngine(eng.params, tc, device="cpu",
                swapper=tserving.WidthSwapper(eng.params, tc))


def test_serve_batched_example_runs_on_cpu(capsys):
    """``python -m repro_torch.launch.serve_batched --device cpu``: the
    reduced config of examples/serve_batched.py planned on TPU_V5E."""
    engine = serve_batched_main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "plan[decode]" in out and "plan[prefill]" in out
    assert len(engine.swap_log) == 3 and engine.swap_log[-1].cache_hit
    assert all(w % 128 == 0 or w == 576 for p in engine.planner.plans
               .values() for w in p.widths.values())


def test_sampling_follows_the_softmax(model):
    """2048 copies of one prompt at temperature 8 (where this model's
    next-token distribution has one token near 0.17 and a long tail): the
    sampled token's frequencies match softmax(logits / T) within 4
    standard errors."""
    _, tc, host = model
    params = params_from_jax(host)
    prompt = prompts(tc.vocab_size)[1]
    n, T = 2048, 8.0
    eng = ServeEngine(params, tc, max_len=16, batch_slots=n, rng_seed=1,
                      device="cpu")
    res = eng.generate([Request(prompt=prompt, max_new_tokens=2,
                                temperature=T) for _ in range(n)])
    assert all(r.tokens.shape == (2,) for r in res)
    first = {int(r.tokens[0]) for r in res}
    assert len(first) == 1           # the first token is always greedy
    drawn = np.array([r.tokens[1] for r in res])
    assert ((drawn >= 0) & (drawn < tc.vocab_size)).all()

    cp = ttfm.cast_params(params, "cpu")
    toks = torch.from_numpy(prompt.astype(np.int64))[None]
    _, st = ttfm.forward(cp, tc, tokens=toks, mode="prefill")
    st = eng._ensure_states(st)
    logits, _ = ttfm.decode_step(cp, tc, torch.tensor([first.pop()]),
                                 len(prompt), st)
    p = torch.softmax(logits[0, :tc.vocab_size].float() / T, -1).numpy()
    freq = np.bincount(drawn, minlength=tc.vocab_size) / n
    for tok in np.argsort(p)[-5:]:
        se = np.sqrt(p[tok] * (1 - p[tok]) / n)
        assert abs(freq[tok] - p[tok]) <= 4 * se + 1e-3, (tok, freq[tok],
                                                           p[tok])

    again = ServeEngine(params, tc, max_len=16, batch_slots=n, rng_seed=1,
                        device="cpu").generate(
        [Request(prompt=prompt, max_new_tokens=2, temperature=T)
         for _ in range(n)])
    assert np.array_equal(drawn, [r.tokens[1] for r in again])


def test_batches_eos_and_capacity(model):
    _, tc, host = model
    eng = ServeEngine(params_from_jax(host), tc, max_len=20, batch_slots=4,
                      device="cpu")
    ps = prompts(tc.vocab_size, seed=2) + prompts(tc.vocab_size, seed=3)[:2]
    res = eng.generate([Request(prompt=p, max_new_tokens=6) for p in ps])
    assert len(res) == 6 and len(eng.batch_log) == 2
    assert eng.batch_log[0].tokens == 4 * (12 + 6)
    solo = eng.generate([Request(prompt=ps[4], max_new_tokens=6)])[0]
    eos = int(solo.tokens[2])
    cut = eng.generate([Request(prompt=ps[4], max_new_tokens=6,
                                eos_id=eos)])[0]
    assert cut.tokens[-1] == eos and len(cut.tokens) <= 3
    with pytest.raises(ValueError, match="max_len"):
        eng.generate([Request(prompt=ps[2], max_new_tokens=10)])


def test_cli_runs_on_cpu(capsys):
    res = serve_main(["--device", "cpu", "--reduced", "--requests", "2",
                      "--prompt-len", "4", "--new-tokens", "3"])
    assert len(res) == 2 and all(len(r.tokens) == 3 for r in res)
    assert "on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "qwen2-vl-7b"])
def test_cli_refuses_archs_outside_the_slice(arch):
    """As ``repro``'s serving CLI does (src/repro/launch/serve.py:35): the
    encoder-decoder and M-RoPE archs, whose inputs are not text tokens
    alone, run through the model API instead."""
    with pytest.raises(SystemExit, match="decoder-only text archs"):
        serve_main(["--device", "cpu", "--reduced", "--arch", arch])


def test_entry_points_default_to_the_card(model):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, tc, host = model
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(params_from_jax(host), tc)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_main(["--reduced"])
    with pytest.raises(RuntimeError, match="cuda"):
        train_main(["--reduced", "--steps", "1"])


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(names), bad)\n"
        "new = {'repro_torch.models.recurrent', 'repro_torch.kernels.rglru',"
        " 'repro_torch.kernels.rwkv6', 'repro_torch.models.moe',"
        " 'repro_torch.kernels.moe_gmm', 'repro_torch.kernels.autotune',"
        " 'repro_torch.serving.degradation', 'repro_torch.serving.hedging',"
        " 'repro_torch.serving.router',"
        " 'repro_torch.launch.serve_resilient',"
        " 'repro_torch.models.convnet', 'repro_torch.core.pruning',"
        " 'repro_torch.launch.pruning_opt', 'repro_torch.train',"
        " 'repro_torch.train.data', 'repro_torch.train.optim',"
        " 'repro_torch.train.step', 'repro_torch.train.checkpoint',"
        " 'repro_torch.launch.train'}\n"
        "sys.exit(1 if bad or len(names) < 20 or new - set(names) else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_imports_neither_jax_nor_repro():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    assert mods, "no imports found"
    for m in mods:
        assert m.split(".")[0] not in ("jax", "jaxlib", "repro"), m


def test_chip_smoke_fails_without_card_or_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


# ---------------------------------------------------------------------------
# the recurrent families: recurrentgemma (rglru, rglru, local) and rwkv6
# ---------------------------------------------------------------------------
RECURRENT = ("recurrentgemma-2b", "rwkv6-1.6b")


def recurrent_model(arch, norms=False):
    """Both reduced configs and the reference's own init, with the
    fp32-read leaves (and, with ``norms``, every norm) perturbed."""
    jc = jax_reduced(jax_get_config(arch))
    tc = reduced_config(get_config(arch))
    host = perturb_fp32_reads(jax.device_get(
        jtfm.init_params(jax.random.PRNGKey(1), jc)), norms=norms)
    return jc, tc, host


@pytest.mark.slow     # jits the JAX engine
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_greedy_generate_matches_jax_engine(arch):
    jc, tc, host = recurrent_model(arch)
    ps = prompts(tc.vocab_size, seed=4)
    jparams = jax.tree.map(jnp.asarray, host)
    jres = JServeEngine(jparams, jc, max_len=32, batch_slots=4).generate(
        [JRequest(prompt=p, max_new_tokens=NEW) for p in ps])
    teng = ServeEngine(params_from_jax(host), tc, max_len=32,
                       batch_slots=4, device="cpu")
    tres = teng.generate([Request(prompt=p, max_new_tokens=NEW)
                          for p in ps])
    # JAX's logits along its own tokens, one forward over the left-padded
    # prompts and generated tokens. A step is compared where both engines
    # generated the same tokens before it (so they saw the same history)
    # and JAX's top-2 margin is clear of twice the bf16 tolerance; these
    # small models' logits are flat, so ties are common and a tie does not
    # end the row's comparison.
    plen = max(len(p) for p in ps)
    seq = np.zeros((len(ps), plen + NEW - 1), np.int32)
    for i, (p, r) in enumerate(zip(ps, jres)):
        seq[i, plen - len(p):plen] = p
        seq[i, plen:] = r.tokens[:-1]
    logits, _, _ = jtfm.forward(jparams, jc, tokens=jnp.asarray(seq),
                                mode="prefill")
    logits = np.asarray(logits[:, plen - 1:, :jc.vocab_size], np.float32)
    tol = TOL * np.abs(logits).max()
    top2 = np.sort(logits, axis=-1)[..., -2:]
    compared = 0
    for i, (j, t) in enumerate(zip(jres, tres)):
        assert len(t.tokens) == len(j.tokens) == NEW
        for step in range(NEW):
            if not np.array_equal(t.tokens[:step], j.tokens[:step]):
                break
            if top2[i, step, 1] - top2[i, step, 0] > 2 * tol:
                assert t.tokens[step] == j.tokens[step], (i, step)
                compared += 1
    assert compared >= NEW * len(ps) // 4


def test_rwkv_prompt_as_long_as_the_heads_serves():
    """The longest prompt has n_heads tokens. ``repro``'s engine grows
    every state leaf whose sequence-like axis equals the prompt length,
    so it pads RWKV's (units, B, H, dh, dh) state along H and fails in
    decode; the port grows only global-attention caches, by layer kind.
    Its tokens follow ``repro``'s model-level prefill and decode_step."""
    jc, tc, host = recurrent_model("rwkv6-1.6b")
    assert tc.n_heads == 4
    rng = np.random.default_rng(6)
    ps = [rng.integers(0, tc.vocab_size, size=(n,)).astype(np.int32)
          for n in (4, 2, 3)]
    new = 8
    tres = ServeEngine(params_from_jax(host), tc, max_len=16,
                       batch_slots=4, device="cpu").generate(
        [Request(prompt=p, max_new_tokens=new) for p in ps])
    assert all(len(r.tokens) == new for r in tres)

    jparams = jax.tree.map(jnp.asarray, host)
    toks = np.zeros((3, 4), np.int32)
    for i, p in enumerate(ps):
        toks[i, 4 - len(p):] = p
    logits, st, _ = jtfm.forward(jparams, jc, tokens=jnp.asarray(toks),
                                 mode="prefill")
    dec = jax.jit(lambda p, t, pos, s: jtfm.decode_step(p, jc, t, pos, s))
    steps = [np.asarray(logits[:, -1, :jc.vocab_size], np.float32)]
    for t in range(new - 1):
        # teacher-forced on the port's tokens, so a near tie cannot make
        # the two sequences part
        cur = jnp.asarray([r.tokens[t] for r in tres], jnp.int32)
        lg, st = dec(jparams, cur, jnp.asarray(4 + t, jnp.int32), st)
        steps.append(np.asarray(lg[:, :jc.vocab_size], np.float32))
    compared = 0
    for t, lg in enumerate(steps):
        tol = TOL * np.abs(lg).max()
        top2 = np.sort(lg, axis=-1)[:, -2:]
        for i, r in enumerate(tres):
            if top2[i, 1] - top2[i, 0] > 2 * tol:
                assert r.tokens[t] == int(np.argmax(lg[i])), (i, t)
                compared += 1
    assert compared >= new * len(ps) // 4      # flat logits: see above


# the norms that repro's model reads through apply_norm, in fp32: its call
# sites in src/repro/models/transformer.py (apply_layer's norm1, norm2 and
# norm_cross, encode's enc_norm, forward's and decode_step's final_norm)
NORM_READS = ("norm1", "norm2", "norm_cross", "enc_norm", "final_norm")


@pytest.mark.parametrize("arch", RECURRENT + ("granite-moe-1b-a400m",
                                              "seamless-m4t-medium"))
def test_cast_params_keeps_the_fp32_reads(arch):
    """Every leaf ``repro`` reads in fp32 stays fp32 with the reference's
    (perturbed) value, bit for bit; every other leaf is its bf16 cast.
    The rule is the reference's use (``FP32_READS``), not a key name:
    ``ln_x`` is a norm whose key lacks "norm". Each norm of
    ``NORM_READS``, a list taken from ``repro``'s call sites and not from
    ``FP32_READS``, is checked by name as well."""
    _, tc, host = recurrent_model(arch, norms=arch == "seamless-m4t-medium")
    params = params_from_jax(host)
    cast = ttfm.cast_params(params, "cpu")
    kept = []

    def walk(t, c, path):
        for k in t:
            if isinstance(t[k], dict):
                walk(t[k], c[k], path + (k,))
                continue
            rule = [ttfm.FP32_READS.get(p, ()) for p in path]
            fp32 = any(r is None for r in rule) or (
                bool(path) and k in (ttfm.FP32_READS.get(path[-1]) or ())) \
                or (len(path) >= 2 and path[-1] in (
                    ttfm.FP32_READS.get(path[-2]) or ()))
            if fp32:
                kept.append(path + (k,))
                assert c[k].dtype == torch.float32, path + (k,)
                assert torch.equal(c[k], t[k]), path + (k,)
            else:
                assert c[k].dtype == torch.bfloat16, path + (k,)
                assert torch.equal(c[k], t[k].to(torch.bfloat16))
    walk(params, cast, ())
    names = {p[-1] if p[-2] != "ln_x" else "ln_x" for p in kept}
    want = {"recurrentgemma-2b": {"a_param", "in_gate_w", "in_gate_b",
                                  "rec_gate_w", "rec_gate_b"},
            "rwkv6-1.6b": {"decay_w", "decay_lora_a", "decay_lora_b",
                           "bonus_u", "ln_x"},
            "granite-moe-1b-a400m": {"router"},
            "seamless-m4t-medium": set()}[arch]
    assert want <= names and names - want <= {"scale", "bias"}

    seen = set()

    def norms(t, c, path):
        for k in t:
            if k in NORM_READS:
                seen.add(k)
                for n in t[k]:
                    assert c[k][n].dtype == torch.float32, path + (k, n)
                    assert torch.equal(c[k][n], t[k][n]), path + (k, n)
            elif isinstance(t[k], dict):
                norms(t[k], c[k], path + (k,))
    norms(params, cast, ())
    assert {"norm1", "final_norm"} <= seen
    if arch == "seamless-m4t-medium":
        assert seen == set(NORM_READS)
        # the perturbed norms are off bf16's grid: a cast would move them
        nc = cast["decoder"]["stack"]["u0"]["norm_cross"]["scale"]
        assert not torch.equal(nc, nc.to(torch.bfloat16).float())
    # the perturbed values are off bf16's grid: a cast would move them
    dw = cast["decoder"]["stack"]["u0"].get("rwkv", {}).get("decay_w")
    if dw is not None:
        assert not torch.equal(dw, dw.to(torch.bfloat16).float())


@pytest.mark.parametrize("arch", RECURRENT)
def test_cli_serves_the_recurrent_archs_on_cpu(arch, capsys):
    res = serve_main(["--device", "cpu", "--reduced", "--arch", arch,
                      "--requests", "3", "--prompt-len", "5",
                      "--new-tokens", "3"])
    assert len(res) == 3 and all(len(r.tokens) == 3 for r in res)
    assert "on cpu" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the MoE family: granite-moe-1b-a400m (every layer top-8 of 32 experts)
# ---------------------------------------------------------------------------
def granite_model(seed=2):
    """granite reduced with 16 experts (top-8: the default 4 would select
    every expert) in both packages, the reference's own init, its router
    perturbed like the other fp32 reads."""
    arch = "granite-moe-1b-a400m"
    jc = jax_reduced(jax_get_config(arch), n_experts=16)
    tc = reduced_config(get_config(arch), n_experts=16)
    host = perturb_fp32_reads(jax.device_get(
        jtfm.init_params(jax.random.PRNGKey(seed), jc)))
    return jc, tc, host


@pytest.mark.slow     # jits the JAX engine
def test_moe_greedy_generate_matches_jax_engine():
    """Greedy tokens of the port's engine (dense experts, as ``repro``'s
    engine serves them) against ``repro``'s ServeEngine, compared as the
    recurrent families' are: where both generated the same tokens so far
    and JAX's top-2 margin is clear of twice the bf16 tolerance."""
    jc, tc, host = granite_model()
    assert (tc.n_experts, tc.experts_per_token) == (16, 8)
    ps = prompts(tc.vocab_size, seed=5)
    jparams = jax.tree.map(jnp.asarray, host)
    jres = JServeEngine(jparams, jc, max_len=32, batch_slots=4).generate(
        [JRequest(prompt=p, max_new_tokens=NEW) for p in ps])
    tres = ServeEngine(params_from_jax(host), tc, max_len=32, batch_slots=4,
                       device="cpu").generate(
        [Request(prompt=p, max_new_tokens=NEW) for p in ps])
    plen = max(len(p) for p in ps)
    seq = np.zeros((len(ps), plen + NEW - 1), np.int32)
    for i, (p, r) in enumerate(zip(ps, jres)):
        seq[i, plen - len(p):plen] = p
        seq[i, plen:] = r.tokens[:-1]
    logits, _, _ = jtfm.forward(jparams, jc, tokens=jnp.asarray(seq),
                                mode="prefill")
    logits = np.asarray(logits[:, plen - 1:, :jc.vocab_size], np.float32)
    tol = TOL * np.abs(logits).max()
    top2 = np.sort(logits, axis=-1)[..., -2:]
    compared = 0
    for i, (j, t) in enumerate(zip(jres, tres)):
        assert len(t.tokens) == len(j.tokens) == NEW
        for step in range(NEW):
            if not np.array_equal(t.tokens[:step], j.tokens[:step]):
                break
            if top2[i, step, 1] - top2[i, step, 0] > 2 * tol:
                assert t.tokens[step] == j.tokens[step], (i, step)
                compared += 1
    assert compared >= NEW * len(ps) // 4


def test_cli_serves_moe_on_cpu(capsys):
    res = serve_main(["--device", "cpu", "--reduced", "--arch",
                      "granite-moe-1b-a400m", "--requests", "3",
                      "--prompt-len", "5", "--new-tokens", "3"])
    assert len(res) == 3 and all(len(r.tokens) == 3 for r in res)
    assert "on cpu" in capsys.readouterr().out
