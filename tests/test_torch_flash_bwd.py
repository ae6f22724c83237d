"""The attention backward kernel's decomposition, on the CPU.

``csrc/flash_attention_bwd.cu`` cannot run here; its arithmetic and its
walk can. A numpy mirror of the kernel takes the module's block sizes and
its grid in launch order (``flash_attention.bwd_order``, which the card's
tests hold equal to the kernel's own ``cta_of``), and does per CTA what the
kernel does: a dK/dV CTA walks (head of its GQA group, query block) from the
first block that sees one of its keys, a dQ CTA its key blocks up to its
last visible key; each computes D = rowsum(dO * O) in fp32 from the O and
dO rows of the block in hand and rounds P and dS to bf16 as operands of
the products that read them, with fp32 sums. The mirror is held to
``attention_bwd_ref`` and to jax's grads of ``repro``'s plain attention
within 4e-2 of each gradient's largest value (the bf16 bound of
tests/test_kernels.py:23), and its walks to visiting every visible (query,
key) pair of every head once in each role.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from test_torch_attention_grad import BF16_TOL, CASES, _close, _inputs, \
    _jax_grads
from test_torch_recurrent import one_torch_thread  # noqa: F401

# the backward's masks: CASES without the local one
BWD_CASES = [c for c in CASES if c[6] in fa.BWD_MASKS]
LOG2E = 1.4426950408889634


def _bf16(x: np.ndarray) -> np.ndarray:
    """fp32 values rounded to the nearest bf16 (ties to even), as fp32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _rows(blk: int, s: int) -> np.ndarray:
    return np.arange(blk * fa.BLOCK_Q, min((blk + 1) * fa.BLOCK_Q, s))


def mirror_bwd(q, k, v, o, lse, do, mask_kind: str):
    """(dq, dk, dv) as the kernel's CTAs compute them, in ``bwd_order``, and
    the visits of each role: int arrays (B, H, Sq, Skv), one per visible
    pair a CTA of that role took in."""
    b, sq, h, dh = q.shape
    skv, kv = k.shape[1], k.shape[2]
    group = h // kv
    scale = 1.0 / np.sqrt(dh)
    dq = np.zeros(q.shape, np.float32)
    dk = np.zeros(k.shape, np.float32)
    dv = np.zeros(v.shape, np.float32)
    visits = [np.zeros((b, h, sq, skv), np.int64) for _ in range(2)]

    def block(bi, hh, rows, keys):
        """One block's P and dS (queries x keys), recomputed from Q, K, V,
        dO and the lse, with D from this CTA's own O and dO rows."""
        qq, kk, vv = q[bi, rows, hh], k[bi, keys, hh // group], \
            v[bi, keys, hh // group]
        d_o = do[bi, rows, hh]
        delta = (d_o * o[bi, rows, hh]).sum(-1, dtype=np.float32)
        seen = np.ones((len(rows), len(keys)), bool)
        if mask_kind == "causal":
            seen = keys[None, :] <= rows[:, None]
        s = qq @ kk.T
        p = np.where(seen, np.exp2(s * (scale * LOG2E)
                                   - lse[bi, hh, rows][:, None] * LOG2E), 0)
        ds = p * (d_o @ vv.T - delta[:, None])
        visits_of = seen.astype(np.int64)
        return p.astype(np.float32), ds.astype(np.float32), visits_of

    for role, blk, bh in fa.bwd_order(b, sq, skv, h, kv, mask_kind):
        walk = fa.bwd_walk(role, blk, sq, skv, h, kv, mask_kind)
        if role == 0:
            bi, kvh = divmod(bh, kv)
            keys = _rows(blk, skv)
            acc_k = np.zeros((len(keys), dh), np.float32)
            acc_v = np.zeros((len(keys), dh), np.float32)
            for g, qb in walk:
                hh, rows = kvh * group + g, _rows(qb, sq)
                p, ds, seen = block(bi, hh, rows, keys)
                acc_v += _bf16(p).T @ do[bi, rows, hh]
                acc_k += _bf16(ds).T @ q[bi, rows, hh]
                visits[0][bi, hh][np.ix_(rows, keys)] += seen
            dk[bi, keys, kvh] = _bf16(acc_k * scale)
            dv[bi, keys, kvh] = _bf16(acc_v)
        else:
            bi, hh = divmod(bh, h)
            rows = _rows(blk, sq)
            acc_q = np.zeros((len(rows), dh), np.float32)
            for kb in walk:
                keys = _rows(kb, skv)
                _, ds, seen = block(bi, hh, rows, keys)
                acc_q += _bf16(ds) @ k[bi, keys, hh // group]
                visits[1][bi, hh][np.ix_(rows, keys)] += seen
            dq[bi, rows, hh] = _bf16(acc_q * scale)
    return dq, dk, dv, visits


def _bf16_case(case):
    """bf16 q, k, v, dO of ``case`` and the plain forward's bf16 O and fp32
    lse from them (the kernel's inputs), as torch tensors."""
    *_, mask, window = case
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _inputs(case))
    o, lse = fa.attention_ref(q, k, v, mask_kind=mask, window=window,
                              lse=True)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("case", BWD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_mirror_vs_plain_and_jax_grads(case):
    """The mirror's (dq, dk, dv) against ``attention_bwd_ref`` on the same
    bf16 inputs, O and lse, and against jax's grads of ``repro``'s plain
    attention of the same bf16 q, k, v: each within 4e-2 of the largest
    gradient (the mirror rounds P, dS and each gradient to bf16)."""
    mask = case[6]
    ts = _bf16_case(case)
    got = mirror_bwd(*(t.float().numpy() for t in ts), mask)[:3]
    want = fa.attention_bwd_ref(*ts, mask_kind=mask)
    for g, w in zip(got, want):
        _close(g, w.float().numpy(), BF16_TOL)
    q, k, v, _, _, do = (t.float().numpy() for t in ts)
    for g, w in zip(got, _jax_grads(q, k, v, do, mask, 0,
                                    dtype=jnp.bfloat16)):
        _close(g, w, BF16_TOL)


@pytest.mark.parametrize("case", BWD_CASES + [
    (2, 150, 150, 4, 2, 64, "causal", 0), (1, 32, 150, 4, 4, 64, "none", 0),
    (1, 150, 97, 2, 1, 64, "causal", 0)],
    ids=lambda c: "-".join(map(str, c)))
def test_every_visible_pair_once_a_role(case):
    """Over the grid, each visible (query, key) pair of each head is taken
    in by exactly one dK/dV CTA and one dQ CTA, and no masked pair is; each
    CTA of ``bwd_order`` appears once, in ``bwd_grid_blocks``' counts."""
    b, sq, skv, h, kv, dh, mask, _ = case
    rng = np.random.default_rng(0)
    zeros = [np.zeros(s, np.float32) for s in
             ((b, sq, h, dh), (b, skv, kv, dh), (b, skv, kv, dh),
              (b, sq, h, dh))]
    lse = rng.standard_normal((b, h, sq)).astype(np.float32)
    *_, visits = mirror_bwd(zeros[0], zeros[1], zeros[2], zeros[3], lse,
                            zeros[0], mask)
    want = np.ones((sq, skv), np.int64)
    if mask == "causal":
        want = np.tril(want)
    for role in (0, 1):
        assert (visits[role] == want[None, None]).all(), role
    order = fa.bwd_order(b, sq, skv, h, kv, mask)
    assert len(set(order)) == len(order)
    n_kv, n_q = fa.bwd_grid_blocks(b, sq, skv, h, kv)
    assert sum(r == 0 for r, _, _ in order) == n_kv
    assert sum(r == 1 for r, _, _ in order) == n_q


@pytest.mark.parametrize("case", [(8, 128, 128, 16, 16, 64, "causal"),
                                  (8, 128, 128, 16, 8, 64, "causal"),
                                  (4, 150, 150, 16, 16, 64, "none"),
                                  (1, 4096, 4096, 8, 2, 128, "causal"),
                                  (1, 70, 70, 7, 1, 64, "causal")],
                         ids=lambda c: "-".join(map(str, c)))
def test_bwd_order_is_heaviest_first(case):
    """The grid's walks, weighted by their products a block (4 for dK/dV, 3
    for dQ), never grow along the launch order; each level (a role's block
    over every batch row and head) is contiguous."""
    b, sq, skv, h, kv, dh, mask = case
    order = fa.bwd_order(b, sq, skv, h, kv, mask)
    cost = [(fa.BWD_COST_KV if r == 0 else fa.BWD_COST_Q)
            * len(fa.bwd_walk(r, blk, sq, skv, h, kv, mask))
            for r, blk, _ in order]
    assert all(x >= y for x, y in zip(cost, cost[1:]))
    levels = [(r, blk) for r, blk, _ in order]
    runs = [lv for i, lv in enumerate(levels) if i == 0 or lv != levels[i - 1]]
    assert len(runs) == len(set(runs))
    if mask == "causal" and sq == skv and h == kv:
        # the first key block's dK/dV CTAs, then the last query block's dQ
        assert runs[0] == (0, 0)
        assert (1, -(-sq // fa.BLOCK_Q) - 1) in runs[1:3]


def test_bwd_grid_and_waves():
    """The grid at the training shapes and its waves by paper Eq. 3 (S =
    132 SMs times the CTAs an SM holds, ``BWD_FORMS``); the forms' shared
    memory as the kernel sizes it."""
    assert fa.bwd_grid_blocks(8, 128, 128, 16, 16) == (256, 256)
    assert fa.bwd_grid_blocks(8, 128, 128, 16, 8) == (128, 256)
    assert fa.bwd_grid_blocks(4, 32, 150, 16, 16) == (192, 64)
    assert fa.bwd_grid_blocks(1, 4096, 4096, 8, 2) == (128, 512)
    assert fa.bwd_waves(8, 128, 128, 16, 16, 64) == 2      # 512 / 396
    assert fa.bwd_waves(8, 128, 128, 16, 8, 64) == 1       # 384 / 396
    assert fa.bwd_waves(4, 2048, 2048, 16, 16, 64) == 11
    assert fa.bwd_waves(1, 4096, 4096, 8, 2, 128) == 5     # 640 / 132
    for dh, f in fa.BWD_FORMS.items():
        tile = 64 * dh * 2
        assert f["smem_bytes"] == 1024 + tile * (2 + 3 * f["stages"]) \
            + 512 * f["stages"] + 8 * (1 + f["stages"])
        assert f["threads"] == 128 * (dh // 64)
        assert fa.bwd_form(dh, device="cpu") == f
    assert fa.bwd_walk(0, 1, 128, 128, 16, 8, "causal") == [(0, 1), (1, 1)]
    assert fa.bwd_walk(1, 0, 128, 128, 16, 8, "causal") == [0]
    assert fa.bwd_walk(1, 0, 32, 150, 16, 16, "none") == [0, 1, 2]
