"""The port's serving engine and CLI against the JAX package's, and the
port's independence from JAX (CPU)."""

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
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch.configs import get_config, reduced_config
from repro_torch.interop import params_from_jax
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import transformer as ttfm
from repro_torch.serving import Request, ServeEngine

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


def test_cli_refuses_archs_outside_the_slice():
    with pytest.raises(SystemExit, match="not ported"):
        serve_main(["--device", "cpu", "--reduced", "--arch", "rwkv6-1.6b"])


def test_entry_points_default_to_the_card(model):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, tc, host = model
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(params_from_jax(host), tc)
    with pytest.raises(RuntimeError, match="cuda"):
        serve_main(["--reduced"])


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
        "sys.exit(1 if bad or len(names) < 20 else 0)\n")
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
