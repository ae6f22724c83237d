"""M-RoPE (qwen2-vl-7b's multimodal rope) in the port against the JAX
package's, on the same converted weights and the same numpy inputs (CPU):
``layers.apply_mrope`` alone, then the reduced qwen2-vl-7b's prefill,
decode, ragged decode and chunked prefill with positions whose (t, h, w)
axes differ (a vision grid, then text), and its greedy serving on text
tokens, where the three axes are equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JServeEngine
from repro_torch.interop import params_from_jax
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.serving import Request, ServeEngine
from test_torch_model import _grow, bf16_pair, close, configs, jax_init
from test_torch_recurrent import (  # noqa: F401 — autouse
    perturb_fp32_reads, one_torch_thread)

ARCH = "qwen2-vl-7b"
GRID = (2, 4)          # the vision grid's rows and columns in a prompt


def grid_positions(b: int, s: int, start: int = 0, grid=GRID) -> np.ndarray:
    """(B, S, 3) M-RoPE positions of prompts that open with an image: its
    ``gh x gw`` patches at t = 0, h = i // gw, w = i % gw, then text at
    max + 1 onward on all three axes (Qwen2-VL's layout); ``start`` skips
    that many tokens, for a later chunk or decode step."""
    gh, gw = grid
    n = gh * gw
    i = np.arange(start, start + s)
    text = max(gh, gw) + i - n
    pos = np.stack([np.where(i < n, 0, text), np.where(i < n, i // gw, text),
                    np.where(i < n, i % gw, text)], axis=-1)
    return np.broadcast_to(pos, (b, s, 3)).astype(np.int32).copy()


@pytest.fixture(scope="module")
def model():
    """Reduced qwen2-vl-7b (2 layers, dh 16, GQA 4:1, sections (2, 3, 3))
    in both packages on the reference's own init, every fp32 read and norm
    moved off bf16's grid."""
    jc, tc = configs(arch=ARCH)
    assert tc.rope_kind == "mrope" and tc.mrope_sections == (2, 3, 3)
    host = perturb_fp32_reads(jax.device_get(jax_init(0, jc)), norms=True)
    return jc, tc, jax.tree.map(jnp.asarray, host), params_from_jax(host)


def test_grid_positions_differ_by_axis():
    pos = grid_positions(1, 12)[0]
    assert pos[:8].tolist() == [[0, 0, 0], [0, 0, 1], [0, 0, 2], [0, 0, 3],
                                [0, 1, 0], [0, 1, 1], [0, 1, 2], [0, 1, 3]]
    assert pos[8:].tolist() == [[4, 4, 4], [5, 5, 5], [6, 6, 6], [7, 7, 7]]
    assert (grid_positions(1, 3, start=12)[0, :, 0] == [8, 9, 10]).all()


# ---------------------------------------------------------------------------
# apply_mrope
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sections,dh", [((2, 3, 3), 16), ((16, 24, 24), 128)])
def test_apply_mrope_matches_repro(sections, dh):
    """Positions whose three axes differ, at the reduced and the full
    config's sections."""
    rng = np.random.default_rng(0)
    jx, tx = bf16_pair(rng.standard_normal((2, 7, 4, dh)).astype(np.float32))
    pos = rng.integers(0, 1000, size=(2, 7, 3))
    assert (pos[..., 0] != pos[..., 1]).any()
    got = tlayers.apply_mrope(tx, torch.from_numpy(pos), 1e6, sections)
    assert got.dtype == torch.bfloat16
    close(got, jlayers.apply_mrope(jx, jnp.asarray(pos, jnp.int32), 1e6,
                                   sections))


@pytest.mark.parametrize("sections,dh", [((2, 3, 3), 16), ((16, 24, 24), 128)])
def test_mrope_with_equal_axes_is_rope(sections, dh):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 7, 4, dh)).astype(
        np.float32)).to(torch.bfloat16)
    pos = torch.from_numpy(rng.integers(0, 1000, size=(2, 7)))
    got = tlayers.apply_mrope(x, pos[..., None].expand(2, 7, 3), 1e6,
                              sections)
    assert torch.equal(got, tlayers.apply_rope(x, pos, 1e6))


def test_apply_mrope_refuses_sections_that_do_not_split_the_bands():
    x = torch.zeros((1, 2, 1, 16))
    with pytest.raises(ValueError, match="sections"):
        tlayers.apply_mrope(x, torch.zeros((1, 2, 3)), 1e4, (2, 3, 2))


@pytest.mark.parametrize("offset", [5, torch.tensor(5),
                                    torch.tensor([5, 7, 9])])
def test_default_positions_have_three_equal_axes(model, offset):
    """The int, 0-d and ragged (B,) forms of ``pos`` alike give (B, S, 3)
    with the standard rope's positions on every axis."""
    _, tc, _, _ = model
    s = 1 if torch.is_tensor(offset) and offset.dim() == 1 else 4
    got = ttfm._positions(tc, 3, s, offset, "cpu")
    assert tuple(got.shape) == (3, s, 3)
    std = ttfm._positions(dataclasses.replace(tc, rope_kind="standard"),
                          3, s, offset, "cpu")
    for axis in range(3):
        assert torch.equal(got[..., axis], std)


# ---------------------------------------------------------------------------
# the reduced model
# ---------------------------------------------------------------------------
def _prefill(model, toks, pos, embeds=None):
    jc, tc, jparams, tparams = model
    if embeds is None:
        jlog, jst, _ = jax.jit(lambda p, t, q: jtfm.forward(
            p, jc, tokens=t, positions=q, mode="prefill"))(
            jparams, jnp.asarray(toks), jnp.asarray(pos))
        tlog, tst = ttfm.forward(tparams, tc, tokens=torch.from_numpy(toks),
                                 positions=torch.from_numpy(pos),
                                 mode="prefill")
    else:
        je, te = bf16_pair(embeds)
        jlog, jst, _ = jax.jit(lambda p, e, q: jtfm.forward(
            p, jc, embeds=e, positions=q, mode="prefill"))(
            jparams, je, jnp.asarray(pos))
        tlog, tst = ttfm.forward(tparams, tc, embeds=te,
                                 positions=torch.from_numpy(pos),
                                 mode="prefill")
    return jlog, jst, tlog, tst


def _close_states(tst, jst):
    leaves = jax.tree_util.tree_leaves_with_path(jst)
    assert len(leaves) == 2      # k, v of the stacked slot (2 layers deep)
    for path, jleaf in leaves:
        node = tst
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == jleaf.shape and node.dtype == \
            torch.bfloat16
        close(node, jleaf)


def test_prefill_logits_and_states_with_grid_positions(model):
    jc, tc, _, _ = model
    toks = np.random.default_rng(2).integers(0, tc.vocab_size, size=(3, 12))
    jlog, jst, tlog, tst = _prefill(model, toks, grid_positions(3, 12))
    close(tlog[..., :tc.vocab_size], jlog[..., :jc.vocab_size])
    _close_states(tst, jst)
    # the grid moves the logits: equal axes give others
    other, _ = ttfm.forward(model[3], tc, tokens=torch.from_numpy(toks),
                            mode="prefill")
    assert not torch.equal(other, tlog)


def test_prefill_from_embeds(model):
    """Precomputed (B, S, d) embeddings in place of tokens (the vision
    frontend's patches): cast to bf16, not scaled by sqrt(d)."""
    jc, tc, _, _ = model
    emb = np.random.default_rng(3).standard_normal(
        (3, 12, tc.d_model)).astype(np.float32)
    jlog, jst, tlog, tst = _prefill(model, None, grid_positions(3, 12), emb)
    close(tlog[..., :tc.vocab_size], jlog[..., :jc.vocab_size])
    _close_states(tst, jst)


def test_teacher_forced_decode_with_positions(model):
    """Five decode steps fed the same tokens, each at its (B, 1, 3) text
    position after the grid: rope turns by the position, the cache row is
    ``pos``, and the two differ."""
    jc, tc, jparams, tparams = model
    rng = np.random.default_rng(4)
    plen, steps = 12, 5
    toks = rng.integers(0, tc.vocab_size, size=(3, plen))
    feed = rng.integers(0, tc.vocab_size, size=(steps, 3))
    _, jst, _, tst = _prefill(model, toks, grid_positions(3, plen))
    jst = _grow(tc, jst, plen + steps, lambda a, p: jnp.pad(
        a, [(0, 0)] * (a.ndim - 3) + [(0, p), (0, 0), (0, 0)]))
    tst = _grow(tc, tst, plen + steps, lambda a, p: torch.nn.functional.pad(
        a, (0, 0, 0, 0, 0, p)))
    jdec = jax.jit(lambda p, t, pos, st, q: jtfm.decode_step(
        p, jc, t, pos, st, positions=q))
    for step in range(steps):
        pos = plen + step
        p3 = grid_positions(3, 1, start=pos)
        assert p3[0, 0, 0] < pos
        jlog, jst = jdec(jparams, jnp.asarray(feed[step], jnp.int32),
                         jnp.asarray(pos, jnp.int32), jst, jnp.asarray(p3))
        tlog, tst = ttfm.decode_step(tparams, tc,
                                     torch.from_numpy(feed[step]), pos, tst,
                                     positions=torch.from_numpy(p3))
        close(tlog[:, :tc.vocab_size], jlog[:, :jc.vocab_size])


def test_ragged_decode(model):
    """A (B,) write position with each row's own (B, 1, 3) positions, and
    with the default ones (equal axes); a uniform vector equals the scalar
    path bit for bit."""
    jc, tc, jparams, tparams = model
    rng = np.random.default_rng(5)
    b, max_len = 3, 16
    pos = np.array([3, 9, 15])
    cur = rng.integers(0, tc.vocab_size, size=(b,))
    jst = jax.tree.map(
        lambda z: jnp.asarray(0.5 * rng.standard_normal(z.shape), z.dtype),
        jtfm.init_decode_state(jc, b, max_len))
    jdec = jax.jit(lambda p, t, q, st, r: jtfm.decode_step(
        p, jc, t, q, st, positions=r))
    p3 = np.stack([grid_positions(1, 1, start=int(x))[0] for x in pos])
    for positions in (p3, None):
        jlog, _ = jdec(jparams, jnp.asarray(cur, jnp.int32),
                       jnp.asarray(pos, jnp.int32), jst,
                       None if positions is None else jnp.asarray(positions))
        tlog, _ = ttfm.decode_step(
            tparams, tc, torch.from_numpy(cur), torch.from_numpy(pos),
            params_from_jax(jax.device_get(jst)),
            positions=None if positions is None
            else torch.from_numpy(positions))
        close(tlog[:, :tc.vocab_size], jlog[:, :jc.vocab_size])
    a, _ = ttfm.decode_step(tparams, tc, torch.from_numpy(cur), 7,
                            params_from_jax(jax.device_get(jst)))
    v, _ = ttfm.decode_step(tparams, tc, torch.from_numpy(cur),
                            torch.full((b,), 7),
                            params_from_jax(jax.device_get(jst)))
    torch.testing.assert_close(a, v, rtol=0, atol=0)


def test_prefill_chunk_with_positions(model):
    """A 12-token grid prompt in two chunks of 6, each with its slice of
    the positions, into caches of 16 rows: each chunk's logits, and the
    caches after both."""
    jc, tc, jparams, tparams = model
    toks = np.random.default_rng(6).integers(0, tc.vocab_size, size=(2, 12))
    pos3 = grid_positions(2, 12)
    jst = jtfm.init_decode_state(jc, 2, 16)
    tst = ttfm.init_decode_state(tc, 2, 16)
    jchunk = jax.jit(lambda p, t, q, st, r: jtfm.prefill_chunk(
        p, jc, t, q, st, positions=r))
    for c0 in (0, 6):
        sl = slice(c0, c0 + 6)
        jlog, jst = jchunk(jparams, jnp.asarray(toks[:, sl]),
                           jnp.asarray(c0, jnp.int32), jst,
                           jnp.asarray(pos3[:, sl]))
        tlog, tst = ttfm.prefill_chunk(
            tparams, tc, torch.from_numpy(toks[:, sl]), torch.tensor(c0),
            tst, positions=torch.from_numpy(pos3[:, sl]))
        close(tlog[..., :tc.vocab_size], jlog[..., :jc.vocab_size])
    _close_states(tst, jst)


def test_greedy_serving_on_text_matches_repro_engine(model):
    """``ServeEngine`` on text tokens (equal axes), as ``repro``'s engine
    serves qwen2-vl: greedy tokens under the margin rule
    (``tests/test_torch_serve.py``): where both engines generated the same
    tokens so far and JAX's own top-2 margin along its tokens is clear of
    twice the bf16 tolerance, the tokens are equal."""
    jc, tc, jparams, tparams = model
    rng = np.random.default_rng(7)
    ps = [rng.integers(0, tc.vocab_size, size=(n,)).astype(np.int32)
          for n in (8, 5, 12, 3)]
    new = 8
    jres = JServeEngine(jparams, jc, max_len=32, batch_slots=4).generate(
        [JRequest(prompt=p, max_new_tokens=new) for p in ps])
    tres = ServeEngine(tparams, tc, max_len=32, batch_slots=4,
                       device="cpu").generate(
        [Request(prompt=p, max_new_tokens=new) for p in ps])
    plen = max(len(p) for p in ps)
    seq = np.zeros((len(ps), plen + new - 1), np.int32)
    for i, (p, r) in enumerate(zip(ps, jres)):
        seq[i, plen - len(p):plen] = p
        seq[i, plen:] = r.tokens[:-1]
    logits, _, _ = jax.jit(lambda p, t: jtfm.forward(
        p, jc, tokens=t, mode="prefill"))(jparams, jnp.asarray(seq))
    logits = np.asarray(logits[:, plen - 1:, :jc.vocab_size], np.float32)
    tol = 4e-2 * np.abs(logits).max()
    top2 = np.sort(logits, axis=-1)[..., -2:]
    compared = 0
    for i, (j, t) in enumerate(zip(jres, tres)):
        assert len(t.tokens) == len(j.tokens) == new
        for step in range(new):
            if not np.array_equal(t.tokens[:step], j.tokens[:step]):
                break
            if top2[i, step, 1] - top2[i, step, 0] > 2 * tol:
                assert t.tokens[step] == j.tokens[step], (i, step)
                compared += 1
    assert compared >= new * len(ps) // 4
