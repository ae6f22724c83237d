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
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch.configs import get_config, reduced_config
from repro_torch.interop import params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from test_torch_recurrent import (  # noqa: F401 — autouse
    perturb_fp32_reads, one_torch_thread)

# jits the JAX model; the quick tier skips it with -m "not slow"
pytestmark = pytest.mark.slow

# bf16 tolerance of repro's kernel tests (tests/test_kernels.py:23), taken
# relative to the largest value compared: both packages round to bf16 at
# the same points, so they differ by a few bf16 steps of the values that
# flow through a layer wherever a sum's order or an fp32 op's last bit
# differs, and a small output can carry the rounding of large inputs
TOL = 4e-2
# top-k routing: where an MoE router's k-th and (k+1)-th logits lie closer
# than this, the two packages may pick different experts, for their bf16
# roundings of the attention output move the router's logits by up to
# half of it on these models wherever no earlier layer routed the token on
# a near tie (test_moe_router_logits_follow_the_reference); a token routed
# on a near tie in some layer is left out of the MoE tests' comparisons
TIE_GAP = 0.1

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
    # every layer MoE, top-8 of 16 experts (the default 4 would select
    # every expert and hide routing), tied embeddings
    "granite-reduced": dict(arch="granite-moe-1b-a400m", n_experts=16),
    # dense and MoE layers alternating, top-1 with a shared expert
    "llama4-reduced": dict(arch="llama4-maverick-400b-a17b"),
}
MOE_VARIANTS = ("granite-reduced", "llama4-reduced")


def configs(arch="qwen1.5-0.5b", n_layers=2, n_kv_heads=None, vocab=256,
            n_experts=4):
    """The same reduced config in both packages."""
    kw = dict(n_layers=n_layers, vocab=vocab, n_experts=n_experts)
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
    t = t.float().numpy() if torch.is_tensor(t) else t
    np.testing.assert_allclose(t, j, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(j).max())))


def at(a, keep, axis=0):
    """``a`` (torch or JAX) as fp32 numpy, at the tokens ``keep`` marks: a
    bool mask over its axes from ``axis`` on ((B, S), or (B,) in decode)."""
    a = a.float().numpy() if torch.is_tensor(a) else \
        np.asarray(a.astype(jnp.float32))
    return a[(slice(None),) * axis + (keep,)]


def routing_ties(fn):
    """Run ``fn`` (which runs the port's forward or decode step) and return
    (ties, its result): ``ties`` marks the tokens that some MoE layer of
    the port routed on a near tie (``TIE_GAP``); None without MoE layers."""
    gaps, real = [], tmoe.route

    def spy(p, x, k):
        lg = (x.float() @ p["router"].float()).sort(-1, descending=True)[0]
        if k < lg.shape[-1]:
            gaps.append((lg[..., k - 1] - lg[..., k]).numpy())
        return real(p, x, k)
    tmoe.route = spy
    try:
        out = fn()
    finally:
        tmoe.route = real
    return (np.min(gaps, axis=0) < TIE_GAP if gaps else None), out


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
    ties, (jlog, jst, tlog, tst) = routing_ties(lambda: _prefill(model,
                                                                 toks))
    keep = np.ones(toks.shape, bool) if ties is None else ~ties
    assert keep.mean() >= 0.25      # granite-reduced: top-8 of 16 experts
    assert tuple(tlog.shape) == jlog.shape
    close(at(tlog[..., :tc.vocab_size], keep),
          at(jlog[..., :jc.vocab_size], keep))
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
        if keep.all():
            close(node, jleaf)
        else:           # MoE layers: global-attention caches (B, S, KV, dh)
            close(at(node, keep, node.dim() - 4), at(jleaf, keep,
                                                     jleaf.ndim - 4))


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


@pytest.mark.parametrize("strategy", ["dense", "capacity"])
@pytest.mark.parametrize("variant", MOE_VARIANTS)
def test_moe_strategies_prefill_and_ragged_decode(variant, strategy):
    """The MoE families under an explicit ``moe_strategy`` (the tests above
    run ``auto``, which is dense in both packages without a mesh): prefill
    logits, then two ragged decode steps, each from ``repro``'s states
    converted (so that a step's comparison rests on that step alone),
    against ``repro``'s forward and decode_step; near-tie tokens aside."""
    jc, tc, jparams, tparams = build(variant)
    assert tc.moe and (tc.experts_per_token, tc.n_experts) == (
        {"granite-reduced": (8, 16), "llama4-reduced": (1, 4)}[variant])
    rng = np.random.default_rng(13)
    plen, steps = 10, 2
    toks = rng.integers(0, tc.vocab_size, size=(12, plen))
    jlog, jst, _ = jax.jit(lambda p, t: jtfm.forward(
        p, jc, tokens=t, mode="prefill", moe_strategy=strategy))(
        jparams, jnp.asarray(toks))
    ties, (tlog, _) = routing_ties(lambda: ttfm.forward(
        tparams, tc, tokens=torch.from_numpy(toks), mode="prefill",
        moe_strategy=strategy))
    compared = [~ties]
    close(at(tlog[..., :tc.vocab_size], ~ties),
          at(jlog[..., :jc.vocab_size], ~ties))
    jst = _grow(tc, jst, plen + steps, lambda a, p: jnp.pad(
        a, [(0, 0)] * (a.ndim - 3) + [(0, p), (0, 0), (0, 0)]))
    jdec = jax.jit(lambda p, t, q, st: jtfm.decode_step(
        p, jc, t, q, st, moe_strategy=strategy))
    for step in range(steps):
        pos = np.array([plen - 3, plen - 1, plen - 2, plen - 1, plen - 5,
                        plen - 4] * 2) + step
        cur = rng.integers(0, tc.vocab_size, size=(12,))
        tst = params_from_jax(jax.device_get(jst))
        jlog, jst = jdec(jparams, jnp.asarray(cur, jnp.int32),
                         jnp.asarray(pos, jnp.int32), jst)
        ties, (tlog, _) = routing_ties(lambda: ttfm.decode_step(
            tparams, tc, torch.from_numpy(cur), torch.from_numpy(pos), tst,
            moe_strategy=strategy))
        ties = ties[:, 0]
        compared.append(~ties)
        close(at(tlog[:, :tc.vocab_size], ~ties),
              at(jlog[:, :jc.vocab_size], ~ties))
    # top-8 of 16 experts puts most of granite's tokens on a near tie in
    # one of its two layers: a few rows in every phase, a quarter in all
    assert min(c.sum() for c in compared) >= 2
    assert np.concatenate([c.ravel() for c in compared]).mean() >= 0.25


@pytest.mark.parametrize("variant", MOE_VARIANTS)
def test_moe_router_logits_follow_the_reference(variant):
    """The premise of ``TIE_GAP``: in each MoE layer of the port's prefill,
    the router logits of every token that no earlier layer routed on a
    near tie lie within TIE_GAP / 2 of ``repro``'s (run eagerly, so that
    its router inputs can be read), and where the port's k-th and (k+1)-th
    logits are also TIE_GAP apart here both pick the same experts."""
    jc, tc, jparams, tparams = build(variant)
    toks = np.random.default_rng(6).integers(0, tc.vocab_size, size=(3, 12))
    seen = {"j": [], "t": []}
    jroute, troute = jmoe.route, tmoe.route

    def jspy(p, x, k):
        out = jroute(p, x, k)
        seen["j"].append((np.asarray(jnp.einsum(
            "...d,de->...e", x.astype(jnp.float32), p["router"])),
            np.asarray(out[1])))
        return out

    def tspy(p, x, k):
        out = troute(p, x, k)
        seen["t"].append(((x.float() @ p["router"].float()).numpy(),
                          out[1].numpy()))
        return out
    jmoe.route, tmoe.route = jspy, tspy
    try:
        with jax.disable_jit():
            jtfm.forward(jparams, jc, tokens=jnp.asarray(toks),
                         mode="prefill")
        ttfm.forward(tparams, tc, tokens=torch.from_numpy(toks),
                     mode="prefill")
    finally:
        jmoe.route, tmoe.route = jroute, troute
    n_moe = sum(m == "moe" for _, m in ttfm.layer_plan(tc))
    assert len(seen["j"]) == len(seen["t"]) == n_moe
    k = tc.experts_per_token
    clear = np.ones(toks.shape, bool)      # no near tie in a layer so far
    for (jl, ji), (tl, ti) in zip(seen["j"], seen["t"]):
        assert np.abs(jl - tl)[clear].max() <= TIE_GAP / 2
        if k < tl.shape[-1]:
            top = -np.sort(-tl, axis=-1)
            clear &= top[..., k - 1] - top[..., k] >= TIE_GAP
        np.testing.assert_array_equal(np.sort(ti, -1)[clear],
                                      np.sort(ji, -1)[clear])
    assert clear.mean() >= 0.25
