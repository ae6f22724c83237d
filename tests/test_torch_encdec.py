"""The encoder-decoder (seamless-m4t-medium) in the port against the JAX
package's, on the same converted weights and the same numpy inputs (CPU):
``kv_proj``, unmasked attention with Sq != Skv, ``encode``, the reduced
model's prefill logits and every state leaf, decode on grown caches and
before any prefill, the parameter layout and counts, and the entry points
that refuse an encoder-decoder, as ``repro``'s do."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro_torch.configs import get_config, list_archs
from repro_torch.configs import reduced_config
from repro_torch.interop import params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.serving import ServeEngine
from repro_torch.serving.continuous import ContinuousServeEngine
from test_torch_model import bf16_pair, close, configs, jax_init
from test_torch_recurrent import (  # noqa: F401 — autouse
    perturb_fp32_reads, one_torch_thread)

ARCH = "seamless-m4t-medium"
S_SRC = 19              # encoder frames, unaligned to the 12-token prompts


@pytest.fixture(scope="module")
def model():
    """Reduced seamless (2 decoder and 2 encoder layers, layernorm, qkv
    bias, GeLU MLP) in both packages on the reference's own init, every
    norm moved off bf16's grid."""
    jc, tc = configs(arch=ARCH)
    assert tc.is_encdec and tc.encoder_layers == 2 and not tc.mlp_gated
    host = perturb_fp32_reads(jax.device_get(jax_init(0, jc)), norms=True)
    return jc, tc, jax.tree.map(jnp.asarray, host), params_from_jax(host)


def src_embeds(b, s, d, seed=0):
    """Frame embeddings as ``repro``'s data stub makes them
    (``src/repro/train/data.py``: standard normal x 0.02)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, d)) * 0.02).astype(np.float32)


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def test_kv_proj_with_bias():
    rng = np.random.default_rng(1)
    jx, tx = bf16_pair(rng.standard_normal((2, 5, 64)).astype(np.float32))
    w = {n: (0.2 * rng.standard_normal(s)).astype(np.float32)
         for n, s in (("wk", (64, 2, 16)), ("wv", (64, 2, 16)),
                      ("bk", (2, 16)), ("bv", (2, 16)))}
    got = tattn.kv_proj({k: torch.from_numpy(v) for k, v in w.items()}, tx)
    want = jattn.kv_proj({k: jnp.asarray(v) for k, v in w.items()}, jx)
    for t, j in zip(got, want):
        assert tuple(t.shape) == j.shape
        close(t, j)


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_unmasked_attention(kv_heads):
    """Sq=12 queries over Skv=19 keys, no mask (the encoder's and
    cross-attention's form): the port's prefill attention (the flash
    kernel's plain version here) against ``repro``'s chunked attention."""
    rng = np.random.default_rng(2)
    jq, tq = bf16_pair(rng.standard_normal((2, 12, 4, 16)).astype(np.float32))
    jk, tk = bf16_pair(rng.standard_normal((2, 19, kv_heads, 16)).astype(
        np.float32))
    jv, tv = bf16_pair(rng.standard_normal((2, 19, kv_heads, 16)).astype(
        np.float32))
    got = tattn.prefill_attention(tq, tk, tv, mask_kind="none")
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 12, 4, 16)
    close(got, jattn.chunked_attention(jq, jk, jv, mask_kind="none"))


def test_encode(model):
    jc, tc, jparams, tparams = model
    src = src_embeds(3, S_SRC, tc.d_model)
    want = jax.jit(lambda p, e: jtfm.encode(p, jc, e))(jparams,
                                                       jnp.asarray(src))
    got = ttfm.encode(tparams, tc, torch.from_numpy(src))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    close(got, want)


def _prefill(model, toks, src):
    jc, tc, jparams, tparams = model
    jlog, jst, _ = jax.jit(lambda p, t, e: jtfm.forward(
        p, jc, tokens=t, src_embeds=e, mode="prefill"))(
        jparams, jnp.asarray(toks), jnp.asarray(src))
    tlog, tst = ttfm.forward(tparams, tc, tokens=torch.from_numpy(toks),
                             src_embeds=torch.from_numpy(src),
                             mode="prefill")
    return jlog, jst, tlog, tst


def test_prefill_logits_and_every_state_leaf(model):
    """Logits, and k, v, ck, cv (bf16) and clen (int32, the encoder
    length, one per stacked layer) of every decoder layer."""
    jc, tc, _, _ = model
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tc.vocab_size, size=(3, 12))
    jlog, jst, tlog, tst = _prefill(model, toks,
                                    src_embeds(3, S_SRC, tc.d_model, 3))
    close(tlog[..., :tc.vocab_size], jlog[..., :jc.vocab_size])
    leaves = jax.tree_util.tree_leaves_with_path(jst)
    names = sorted(path[-1].key for path, _ in leaves)
    assert names == ["ck", "clen", "cv", "k", "v"]
    for path, jleaf in leaves:
        node = _leaf(tst, path)
        assert tuple(node.shape) == jleaf.shape, path
        if path[-1].key == "clen":
            assert node.dtype == torch.int32
            assert node.tolist() == np.asarray(jleaf).tolist() == [S_SRC] * 2
        else:
            assert node.dtype == torch.bfloat16
            close(node, jleaf)


def _grow_kv(tree, max_len, pad_fn):
    """The self-attention caches grown to ``max_len`` rows along axis -3;
    the encoder K/V and its length as they are."""
    out = {g: {k: dict(st) for k, st in sub.items()}
           for g, sub in tree.items()}
    for sub in out.values():
        for st in sub.values():
            for n in ("k", "v"):
                st[n] = pad_fn(st[n], max_len - st[n].shape[-3])
    return out


def test_teacher_forced_decode_on_grown_caches(model):
    """Five decode steps fed the same tokens in both packages, after a
    prefill whose self-attention caches were grown to 17 rows; the
    cross-attention reads the prefill's encoder K/V."""
    jc, tc, jparams, tparams = model
    rng = np.random.default_rng(4)
    plen, steps = 12, 5
    toks = rng.integers(0, tc.vocab_size, size=(3, plen))
    feed = rng.integers(0, tc.vocab_size, size=(steps, 3))
    _, jst, _, tst = _prefill(model, toks, src_embeds(3, S_SRC, tc.d_model,
                                                      4))
    jst = _grow_kv(jst, plen + steps, lambda a, p: jnp.pad(
        a, [(0, 0)] * (a.ndim - 3) + [(0, p), (0, 0), (0, 0)]))
    tst = _grow_kv(tst, plen + steps, lambda a, p: torch.nn.functional.pad(
        a, (0, 0, 0, 0, 0, p)))
    ck = tst["stack"]["u0"]["ck"].clone()
    jdec = jax.jit(lambda p, t, pos, st: jtfm.decode_step(p, jc, t, pos, st))
    for step in range(steps):
        pos = plen + step
        jlog, jst = jdec(jparams, jnp.asarray(feed[step], jnp.int32),
                         jnp.asarray(pos, jnp.int32), jst)
        tlog, tst = ttfm.decode_step(tparams, tc,
                                     torch.from_numpy(feed[step]), pos, tst)
        close(tlog[:, :tc.vocab_size], jlog[:, :jc.vocab_size])
    assert torch.equal(tst["stack"]["u0"]["ck"], ck)
    close(tst["stack"]["u0"]["k"], jst["stack"]["u0"]["k"])


def test_decode_before_prefill(model):
    """``repro``'s own case (tests/test_models.py): a decode step on zero
    states with room for an encoder (``clen`` 0) attends to no encoder
    row; both packages give the same logits."""
    jc, tc, jparams, tparams = model
    enc_len = 8
    jst = jtfm.init_decode_state(jc, 2, 16, enc_len=enc_len)
    tst = ttfm.init_decode_state(tc, 2, 16, enc_len=enc_len)
    for path, jleaf in jax.tree_util.tree_leaves_with_path(jst):
        node = _leaf(tst, path)
        assert tuple(node.shape) == jleaf.shape and not node.any()
        assert node.dtype == (torch.int32 if path[-1].key == "clen"
                              else torch.bfloat16)
    tok = np.array([3, 7])
    jlog, _ = jtfm.decode_step(jparams, jc, jnp.asarray(tok, jnp.int32),
                               jnp.asarray(0), jst)
    tlog, _ = ttfm.decode_step(tparams, tc, torch.from_numpy(tok), 0, tst)
    assert bool(torch.isfinite(tlog.float()).all())
    close(tlog[:, :tc.vocab_size], jlog[:, :jc.vocab_size])


def test_init_params_layout_matches_jax(model):
    """The port's own init has ``repro``'s tree (encoder, enc_norm, each
    decoder layer's norm_cross and cross.attn), so converting weights is a
    copy."""
    _, tc, jparams, _ = model
    tparams = ttfm.init_params(tc, torch.Generator().manual_seed(0))
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    for path, jleaf in jleaves:
        node = _leaf(tparams, path)
        assert tuple(node.shape) == jleaf.shape, path
        assert node.dtype == torch.float32
    count = lambda t: (sum(count(v) for v in t.values())
                       if isinstance(t, dict) else 1)
    assert count(tparams) == len(jleaves)
    assert {"encoder", "enc_norm"} <= set(tparams)
    assert {"norm_cross", "cross"} <= set(tparams["decoder"]["stack"]["u0"])


@pytest.mark.parametrize("arch", list_archs())
def test_count_params_analytic_as_repro(arch):
    """Every config, full and reduced, counts as in ``repro``; the reduced
    encoder-decoder's count is its tree's, less the vocab pad."""
    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jred
    for jc, tc in ((jget(arch), get_config(arch)),
                   (jred(jget(arch)), reduced_config(get_config(arch)))):
        for kw in ({}, {"active_only": True},
                   {"include_embeddings": False}):
            assert ttfm.count_params_analytic(tc, **kw) == \
                jtfm.count_params_analytic(jc, **kw)
    if arch == ARCH:
        tc = reduced_config(get_config(arch))
        p = ttfm.init_params(tc, torch.Generator().manual_seed(0))
        n = sum(a.size for a in jax.tree_util.tree_leaves(
            jax.tree.map(lambda t: t.numpy(), p)))
        pad = ttfm.padded_vocab(tc) - tc.vocab_size
        assert n - pad * tc.d_model * (1 if tc.tie_embeddings else 2) == \
            ttfm.count_params_analytic(tc)


def test_entry_points_refuse_an_encoder_decoder(model):
    """``ServeEngine`` raises a clear error (``repro``'s fails an assert in
    its token-only prefill), ``ContinuousServeEngine`` and
    ``prefill_chunk`` refuse as ``repro``'s do, and ``forward`` needs the
    encoder's input."""
    _, tc, _, tparams = model
    with pytest.raises(ValueError, match="decoder-only"):
        ServeEngine(tparams, tc, device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        ContinuousServeEngine(tparams, tc, device="cpu")
    st = ttfm.init_decode_state(tc, 1, 8, enc_len=4)
    with pytest.raises(ValueError, match="decoder-only"):
        ttfm.prefill_chunk(tparams, tc, torch.zeros((1, 4), dtype=torch.long),
                           0, st)
    with pytest.raises(ValueError, match="src_embeds"):
        ttfm.forward(tparams, tc, tokens=torch.zeros((1, 4),
                                                     dtype=torch.long))
