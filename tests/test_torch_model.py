"""The port's layers, prefill and decode against the JAX package's, on the
same converted weights and the same numpy inputs (CPU; the port takes its
kernels' plain versions there, the JAX package its einsum paths)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch.configs import get_config, reduced_config
from repro_torch.interop import params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from test_torch_recurrent import perturb_fp32_reads

# jits the JAX model; the quick tier skips it with -m "not slow"
pytestmark = pytest.mark.slow

# bf16 tolerance of repro's kernel tests (tests/test_kernels.py:23), taken
# relative to the largest value compared: both packages round to bf16 at
# the same points, so they differ by a few bf16 steps of the values that
# flow through a layer wherever a sum's order or an fp32 op's last bit
# differs, and a small output can carry the rounding of large inputs
TOL = 4e-2

VARIANTS = {
    "qwen-reduced": dict(),
    "gqa-3layer": dict(n_layers=3, n_kv_heads=2),
    "vocab250": dict(vocab=250),
    # layernorm and a parallel attention + MLP block
    "command-r-reduced": dict(arch="command-r-plus-104b"),
    # untied unembedding, no qkv bias
    "deepseek-reduced": dict(arch="deepseek-7b"),
    # hybrid: (rglru, rglru, local) with a ring cache of 64 rows, MQA
    "recurrentgemma-reduced": dict(arch="recurrentgemma-2b"),
    # attention-free: RWKV6 time-mix and channel-mix, layernorm
    "rwkv6-reduced": dict(arch="rwkv6-1.6b"),
}


def configs(arch="qwen1.5-0.5b", n_layers=2, n_kv_heads=None, vocab=256):
    """The same reduced config in both packages."""
    kw = dict(n_layers=n_layers, vocab=vocab)
    jc = jax_reduced(jax_get_config(arch), **kw)
    tc = reduced_config(get_config(arch), **kw)
    if n_kv_heads is not None:
        jc = dataclasses.replace(jc, n_kv_heads=n_kv_heads)
        tc = dataclasses.replace(tc, n_kv_heads=n_kv_heads)
    return jc, tc


def jax_init(seed, cfg):
    return jax.jit(jtfm.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg)


def bf16_pair(a):
    """One fp32 numpy array as bf16 in both packages (the same bits)."""
    return (jnp.asarray(a).astype(jnp.bfloat16),
            torch.from_numpy(a).to(torch.bfloat16))


def close(t, j, tol=TOL):
    j = np.asarray(j.astype(jnp.float32))
    np.testing.assert_allclose(t.float().numpy(), j, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(j).max())))


def build(variant):
    """Both configs and the reference's own init, converted; the leaves
    the reference reads in fp32 are perturbed (they start as constants)."""
    jc, tc = configs(**VARIANTS[variant])
    host = perturb_fp32_reads(jax.device_get(jax_init(0, jc)))
    return jc, tc, jax.tree.map(jnp.asarray, host), params_from_jax(host)


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    return build(request.param)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm(kind):
    rng = np.random.default_rng(0)
    jx, tx = bf16_pair(rng.standard_normal((2, 5, 64)).astype(np.float32))
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    tp = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    close(tlayers.apply_norm(tp, tx, kind), jlayers.apply_norm(jp, jx, kind))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    rng = np.random.default_rng(1)
    jx, tx = bf16_pair(rng.standard_normal((2, 5, 4, 16)).astype(np.float32))
    pos = rng.integers(0, 1000, size=(2, 5))
    close(tlayers.apply_rope(tx, torch.from_numpy(pos), theta),
          jlayers.apply_rope(jx, jnp.asarray(pos, jnp.int32), theta))


@pytest.mark.parametrize("gated", [True, False])
def test_mlp(gated):
    rng = np.random.default_rng(2)
    jx, tx = bf16_pair(rng.standard_normal((2, 5, 64)).astype(np.float32))
    w = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("w_up", (64, 96)), ("w_gate", (64, 96)),
                      ("w_down", (96, 64)))}
    if not gated:
        del w["w_gate"]
    jp = {k: jnp.asarray(v) for k, v in w.items()}
    tp = {k: torch.from_numpy(v) for k, v in w.items()}
    close(tlayers.apply_mlp(tp, tx, gated), jlayers.apply_mlp(jp, jx, gated))


def test_qkv_proj_with_bias():
    rng = np.random.default_rng(3)
    jx, tx = bf16_pair(rng.standard_normal((2, 5, 64)).astype(np.float32))
    shapes = {"wq": (64, 4, 16), "wk": (64, 2, 16), "wv": (64, 2, 16),
              "bq": (4, 16), "bk": (2, 16), "bv": (2, 16)}
    w = {n: (0.2 * rng.standard_normal(s)).astype(np.float32)
         for n, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in w.items()}
    tp = {k: torch.from_numpy(v) for k, v in w.items()}
    for t, j in zip(tattn.qkv_proj(tp, tx), jattn.qkv_proj(jp, jx)):
        assert tuple(t.shape) == j.shape
        close(t, j)


@pytest.mark.parametrize("q_chunk", [1024, 16])
def test_local_attention_prefill(q_chunk):
    """recurrentgemma's sliding window (MQA), in one query chunk and in
    chunks whose key strips start past 0."""
    rng = np.random.default_rng(11)
    jq, tq = bf16_pair(rng.standard_normal((2, 70, 4, 16)).astype(np.float32))
    jk, tk = bf16_pair(rng.standard_normal((2, 70, 1, 16)).astype(np.float32))
    jv, tv = bf16_pair(rng.standard_normal((2, 70, 1, 16)).astype(np.float32))
    got = tattn.local_attention_prefill(tq, tk, tv, window=24,
                                        q_chunk=q_chunk)
    assert got.dtype == torch.bfloat16
    close(got, jattn.local_attention_prefill(jq, jk, jv, window=24,
                                             q_chunk=q_chunk))


@pytest.mark.parametrize("lengths", [13, [5, 20, 1]])
def test_decode_attention(lengths):
    rng = np.random.default_rng(4)
    jq, tq = bf16_pair(rng.standard_normal((3, 4, 16)).astype(np.float32))
    jk, tk = bf16_pair(rng.standard_normal((3, 20, 2, 16)).astype(np.float32))
    jv, tv = bf16_pair(rng.standard_normal((3, 20, 2, 16)).astype(np.float32))
    if isinstance(lengths, int):
        jl, tl = lengths, lengths
    else:
        jl = jnp.asarray(lengths, jnp.int32)
        tl = torch.tensor(lengths)
    close(tattn.decode_attention(tq, tk, tv, tl),
          jattn.decode_attention(jq, jk, jv, jl))


def test_embed_unembed_vocab_pad():
    jc, tc = configs(vocab=250)
    jparams = jax_init(1, jc)
    tparams = params_from_jax(jax.device_get(jparams))
    assert ttfm.padded_vocab(tc) == jtfm.padded_vocab(jc) == 256
    toks = np.random.default_rng(5).integers(0, 250, size=(2, 7))
    jx = jlayers.embed_tokens(jparams["embed"], jnp.asarray(toks), jc.d_model)
    tx = tlayers.embed_tokens(tparams["embed"], torch.from_numpy(toks),
                              tc.d_model)
    np.testing.assert_array_equal(tx.float().numpy(),
                                  np.asarray(jx.astype(jnp.float32)))
    jl = jtfm._mask_vocab_pad(jlayers.unembed(jparams["embed"], jx, True),
                              jc)
    tl = ttfm._mask_vocab_pad(tlayers.unembed(tparams["embed"], tx, True),
                              tc)
    close(tl, jl)
    assert (tl[..., 250:] == torch.tensor(-1e9, dtype=torch.bfloat16)).all()
    assert tl.dtype == torch.bfloat16
    close(tlayers.unembed(tparams["embed"], tx, True, softcap=0.5),
          jlayers.unembed(jparams["embed"], jx, True, softcap=0.5))


# ---------------------------------------------------------------------------
# prefill and decode through the whole stack
# ---------------------------------------------------------------------------
def _prefill(model, toks):
    jc, tc, jparams, tparams = model
    jlog, jst, _ = jax.jit(lambda p, t: jtfm.forward(
        p, jc, tokens=t, mode="prefill"))(jparams, jnp.asarray(toks))
    tlog, tst = ttfm.forward(tparams, tc, tokens=torch.from_numpy(toks),
                             mode="prefill")
    return jlog, jst, tlog, tst


def test_forward_prefill_logits_and_states(model):
    jc, tc, _, _ = model
    toks = np.random.default_rng(6).integers(0, tc.vocab_size, size=(3, 12))
    jlog, jst, tlog, tst = _prefill(model, toks)
    assert tuple(tlog.shape) == jlog.shape
    close(tlog[..., :tc.vocab_size], jlog[..., :jc.vocab_size])
    jleaves = jax.tree_util.tree_leaves_with_path(jst)
    count = lambda t: (sum(count(v) for v in t.values())
                       if isinstance(t, dict) else 1)
    # per stacked slot: k, v (attn, local); h, conv; shift, s, cmix_shift
    slots = {(r["group"], r["key"]): r["kind"]
             for r in ttfm.decoder_layer_refs(tc)}
    per_kind = {"attn": 2, "local": 2, "rglru": 2, "rwkv": 3}
    assert len(jleaves) == count(tst) == sum(per_kind[k]
                                             for k in slots.values())
    for path, jleaf in jleaves:
        node = tst
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == jleaf.shape
        assert node.dtype == {jnp.dtype(jnp.bfloat16): torch.bfloat16,
                              jnp.dtype(jnp.float32): torch.float32}[
                                  jleaf.dtype]
        close(node, jleaf)


def _grow(cfg, tree, max_len, pad_fn):
    """The global-attention caches grown to ``max_len`` rows; rings and
    recurrent states as they are (the port's engine does the same)."""
    tree = {g: dict(sub) for g, sub in tree.items()}
    for r in ttfm.decoder_layer_refs(cfg):
        if r["kind"] == "attn":
            cache = tree[r["group"]][r["key"]]
            tree[r["group"]][r["key"]] = {
                n: pad_fn(a, max_len - a.shape[-3]) if a.shape[-3] < max_len
                else a for n, a in cache.items()}
    return tree


def test_teacher_forced_decode(model):
    """Five decode steps fed the same tokens in both packages."""
    _teacher_forced(model, plen=9, steps=5, seed=7)


def test_ring_cache_rolls_past_the_window():
    """recurrentgemma's local layer with a 70-token prompt, past the
    reduced window of 64: prefill rolls the ring by 70 % 64 and decode
    writes slot pos % 64 over the oldest rows."""
    m = build("recurrentgemma-reduced")
    assert m[1].window == 64
    _teacher_forced(m, plen=70, steps=4, seed=12)


def _teacher_forced(model, *, plen, steps, seed):
    jc, tc, jparams, tparams = model
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, tc.vocab_size, size=(3, plen))
    feed = rng.integers(0, tc.vocab_size, size=(steps, 3))
    _, jst, _, tst = _prefill(model, toks)
    max_len = plen + steps
    jst = _grow(tc, jst, max_len, lambda a, p: jnp.pad(
        a, [(0, 0)] * (a.ndim - 3) + [(0, p), (0, 0), (0, 0)]))
    tst = _grow(tc, tst, max_len, lambda a, p: torch.nn.functional.pad(
        a, (0, 0, 0, 0, 0, p)))
    jdec = jax.jit(lambda p, t, pos, st: jtfm.decode_step(p, jc, t, pos, st))
    for step in range(steps):
        pos = plen + step
        jlog, jst = jdec(jparams, jnp.asarray(feed[step], jnp.int32),
                         jnp.asarray(pos, jnp.int32), jst)
        tlog, tst = ttfm.decode_step(tparams, tc,
                                     torch.from_numpy(feed[step]), pos, tst)
        assert tuple(tlog.shape) == jlog.shape
        close(tlog[:, :tc.vocab_size], jlog[:, :jc.vocab_size])


def test_ragged_decode_positions(model):
    """A (B,) position vector: rows at their own offsets, as repro's
    continuous engine decodes; a uniform vector equals the scalar path."""
    jc, tc, jparams, tparams = model
    rng = np.random.default_rng(8)
    b, max_len = 3, 16
    pos = np.array([3, 9, 15])
    cur = rng.integers(0, tc.vocab_size, size=(b,))
    jst = jax.tree.map(
        lambda z: jnp.asarray(0.5 * rng.standard_normal(z.shape), z.dtype),
        jtfm.init_decode_state(jc, b, max_len))
    tst = params_from_jax(jax.device_get(jst))
    jlog, _ = jax.jit(lambda p, t, q, st: jtfm.decode_step(p, jc, t, q, st))(
        jparams, jnp.asarray(cur, jnp.int32), jnp.asarray(pos, jnp.int32), jst)
    tlog, _ = ttfm.decode_step(tparams, tc, torch.from_numpy(cur),
                               torch.from_numpy(pos), tst)
    close(tlog[:, :tc.vocab_size], jlog[:, :jc.vocab_size])

    s1 = params_from_jax(jax.device_get(jst))
    s2 = params_from_jax(jax.device_get(jst))
    a, _ = ttfm.decode_step(tparams, tc, torch.from_numpy(cur), 7, s1)
    v, _ = ttfm.decode_step(tparams, tc, torch.from_numpy(cur),
                            torch.full((b,), 7), s2)
    torch.testing.assert_close(a, v, rtol=0, atol=0)


def test_init_params_layout_matches_jax(model):
    jc, tc, jparams, _ = model
    tparams = ttfm.init_params(tc, torch.Generator().manual_seed(0))
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    n = 0
    for path, jleaf in jleaves:
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == jleaf.shape, path
        assert node.dtype == torch.float32
        n += 1
    count = lambda t: (sum(count(v) for v in t.values())
                       if isinstance(t, dict) else 1)
    assert count(tparams) == n
