"""The port's recurrent blocks (``repro_torch.models.recurrent``) against the
JAX package's, function by function, on the same numpy inputs made from a
seed (CPU: the port takes its kernels' plain versions there).

``perturb_fp32_reads`` is shared with the model and serving tests: it moves
the leaves that ``repro`` reads in fp32 off their constant initial values
(``ln_x`` ones and zeros, ``decay_w`` -1), so that a rounding of them to
bf16 would show; with ``norms=True`` it moves every norm's scale and bias
too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recurrent as jrec
from repro_torch.interop import params_from_jax
from repro_torch.models import recurrent as trec
from repro_torch.models import transformer as ttfm

F32 = 2e-4      # tests/test_kernels.py:23 and tests/test_recurrent.py:82
BF16 = 4e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a module's tests (every port test module but
    the card's and the convnet's imports this fixture): pytest-xdist runs
    several workers on the machine's cores, and torch's OpenMP threads in
    each worker contend for them (on an 8-core CPU, six concurrent runs of
    tests/test_torch_chaos_cli.py took 21x longer at torch's default
    thread count than at one thread each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def perturb_fp32_reads(tree, seed=0, norms=False):
    """A copy of a ``repro`` param tree (numpy leaves) whose fp32-read
    leaves (``transformer.FP32_READS``, norms excluded) carry noise off
    bf16's grid. With ``norms``, so does every norm: each dict of a
    ``scale`` (and a ``bias``) alone, found by its shape and not by
    ``FP32_READS``, so that a norm missing there would show."""
    rng = np.random.default_rng(seed)

    def noisy(a, scale):
        return (a + scale * rng.standard_normal(a.shape)).astype(a.dtype)

    def walk(t, parent):
        if not isinstance(t, dict):
            return t
        out = {}
        for k, v in t.items():
            rule = ttfm.FP32_READS.get(parent) or ()
            if k in rule and k == "ln_x":
                out[k] = {"scale": noisy(v["scale"], 0.1),
                          "bias": noisy(v["bias"], 0.1)}
            elif k in rule:
                out[k] = noisy(np.asarray(v), 0.3 if k == "decay_w"
                               else 0.01 * (1 + np.abs(v).mean()))
            elif norms and isinstance(v, dict) and "scale" in v \
                    and set(v) <= {"scale", "bias"}:
                out[k] = {n: noisy(np.asarray(a), 0.1) for n, a in v.items()}
            else:
                out[k] = walk(v, k)
        return out
    return walk(tree, None)


def close(t, j, tol):
    j = np.asarray(jnp.asarray(j).astype(jnp.float32))
    t = t.float().numpy()
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(j).max())))


def both(a, dtype=np.float32):
    """One numpy array in both packages: fp32, or bf16 with the same bits."""
    a = np.asarray(a, np.float32)
    if dtype == "bf16":
        return (jnp.asarray(a).astype(jnp.bfloat16),
                torch.from_numpy(a).to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a)


def tree_pair(jtree, key):
    """A block's ``repro`` params, perturbed as they sit under ``key`` in
    a layer, in both packages."""
    host = {k: np.asarray(v) if not isinstance(v, dict)
            else {c: np.asarray(x) for c, x in v.items()}
            for k, v in jtree.items()}
    host = perturb_fp32_reads({key: host})[key]
    return jax_tree(host), params_from_jax(host)


def jax_tree(host):
    return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in host.items()}


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------
W = 32


@pytest.fixture(scope="module")
def rglru():
    import jax
    return tree_pair(jrec.init_rglru(jax.random.PRNGKey(0), W), "rglru")


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(rglru, with_state):
    jp, tp = rglru
    rng = np.random.default_rng(1)
    jx, tx = both(rng.standard_normal((2, 7, W)), "bf16")
    js = ts = None
    if with_state:
        js, ts = both(rng.standard_normal((2, trec.CONV_K - 1, W)), "bf16")
    jy, jst = jrec._causal_conv(jx, jp["conv_w"], jp["conv_b"] + 0.1, js)
    ty, tst = trec._causal_conv(tx, tp["conv_w"], tp["conv_b"] + 0.1, ts)
    close(ty, jy, BF16)
    assert ty.dtype == torch.bfloat16
    close(tst, jst, 0)


def test_rglru_gates(rglru):
    jp, tp = rglru
    jx, tx = both(np.random.default_rng(2).standard_normal((2, 5, W)))
    for t, j in zip(trec._rglru_gates(tp, tx), jrec._rglru_gates(jp, jx)):
        assert t.dtype == torch.float32
        close(t, j, F32)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_vs_associative_scan(rglru, with_h0):
    """The port's scan (the kernel's plain version, from h0) against
    ``repro``'s associative scan (h0 folded into the first step)."""
    jp, tp = rglru
    rng = np.random.default_rng(3)
    jx, tx = both(rng.standard_normal((2, 40, W)))
    jh = th = None
    if with_h0:
        jh, th = both(rng.standard_normal((2, W)))
    jy, jlast = jrec.rglru_scan(jp, jx, jh)
    ty, tlast = trec.rglru_scan(tp, tx, th)
    assert ty.dtype == torch.bfloat16 and tlast.dtype == torch.float32
    close(ty, jy, BF16)
    close(tlast, jlast, 1e-4)        # tests/test_recurrent.py:37
    ry, rlast = trec.rglru_ref(tp, tx, th)
    close(ry, jy, BF16)
    close(rlast, jlast, 1e-4)


def test_rglru_step(rglru):
    jp, tp = rglru
    rng = np.random.default_rng(4)
    jx, tx = both(rng.standard_normal((3, W)), "bf16")
    jh, th = both(rng.standard_normal((3, W)))
    (ty, th2), (jy, jh2) = trec.rglru_step(tp, tx, th), \
        jrec.rglru_step(jp, jx, jh)
    close(ty, jy, BF16)
    close(th2, jh2, F32)


def test_rglru_block_prefill_then_decode(rglru):
    """Prefill from no state, then three decode steps carrying the states,
    in both packages."""
    jp, tp = rglru
    rng = np.random.default_rng(5)
    jx, tx = both(rng.standard_normal((2, 9, W)), "bf16")
    jy, jst = jrec.apply_rglru_block(jp, jx)
    ty, tst = trec.apply_rglru_block(tp, tx)
    close(ty, jy, BF16)
    close(tst["h"], jst["h"], BF16)
    close(tst["conv"], jst["conv"], 0)
    for step in range(3):
        jx, tx = both(rng.standard_normal((2, 1, W)), "bf16")
        jy, jst = jrec.apply_rglru_block(jp, jx, state=jst, decode=True)
        ty, tst = trec.apply_rglru_block(tp, tx, state=tst, decode=True)
        close(ty, jy, BF16)
        close(tst["h"], jst["h"], BF16)
        close(tst["conv"], jst["conv"], BF16)


def test_rglru_init_layout():
    import jax
    j = jrec.init_rglru(jax.random.PRNGKey(0), W)
    t = trec.init_rglru(torch.Generator().manual_seed(0), W, lead=(2,))
    assert set(t) == set(j)
    for k in j:
        assert tuple(t[k].shape) == (2,) + j[k].shape
        assert t[k].dtype == torch.float32
    # the decay a = exp(-c softplus(L)) lies in (0.9, 0.999) at r = 1
    a = torch.exp(-trec.RG_C * torch.nn.functional.softplus(t["a_param"]))
    assert (a > 0.9 - 1e-6).all() and (a < 0.999 + 1e-6).all()
    st = trec.rglru_init_state(3, W)
    jst = jrec.rglru_init_state(3, W)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in st.items()} == \
        {k: (v.shape, f"torch.{v.dtype}") for k, v in jst.items()}


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------
D, H, DH = 32, 2, 16


@pytest.fixture(scope="module")
def rwkv():
    import jax
    p = jrec.init_rwkv(jax.random.PRNGKey(0), D, H, DH, 3 * D)
    jtm, ttm = tree_pair(p["rwkv"], "rwkv")
    jcm, tcm = tree_pair(p["cmix"], "cmix")
    assert not np.all(np.asarray(jtm["decay_w"]) == -1.0)
    return jtm, ttm, jcm, tcm


def rwkv_inputs(seed, b, t, h, dh, lw=None):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, t, h, dh)) for _ in range(3)]
    if lw is None:
        lw = -np.exp(np.clip(rng.standard_normal((b, t, h, dh)), -8, 1))
    else:
        lw = np.full((b, t, h, dh), lw)
    u = 0.1 * rng.standard_normal((h, dh))
    s0 = rng.standard_normal((b, h, dh, dh))
    return [both(a) for a in arrs + [lw, u, s0]]


@pytest.mark.parametrize("t", [32, 40, 7])
def test_rwkv_chunked_and_ref_with_s0(t):
    """``rwkv_chunked`` and the sequential ``rwkv_ref`` from a non-zero
    state, against ``repro``'s, fp32 at 2e-4."""
    (jr, tr), (jk, tk), (jv, tv), (jl, tl), (ju, tu), (js, ts) = \
        rwkv_inputs(6, 2, t, H, DH)
    jo, jS = jrec.rwkv_ref(jr, jk, jv, jl, ju, js)
    for fn in (trec.rwkv_ref, trec.rwkv_chunked):
        to, tS = fn(tr, tk, tv, tl, tu, ts)
        assert to.dtype == tS.dtype == torch.float32
        close(to, jo, F32)
        close(tS, jS, F32)
    co, cS = jrec.rwkv_chunked(jr, jk, jv, jl, ju, js, chunk=16)
    to, tS = trec.rwkv_chunked(tr, tk, tv, tl, tu, ts, chunk=16)
    close(to, co, F32)
    close(tS, cS, F32)


def test_rwkv_rkvwg(rwkv):
    jp, tp, _, _ = rwkv
    rng = np.random.default_rng(7)
    jx, tx = both(rng.standard_normal((2, 6, D)), "bf16")
    js, ts = both(rng.standard_normal((2, 6, D)), "bf16")
    got = trec._rwkv_rkvwg(tp, tx, ts)
    want = jrec._rwkv_rkvwg(jp, jx, js)
    for t, j in zip(got[:4], want[:4]):
        assert t.dtype == torch.bfloat16
        close(t, j, BF16)
    assert got[4].dtype == torch.float32
    close(got[4], want[4], F32)


def test_timemix_prefill_then_decode(rwkv):
    jp, tp, _, _ = rwkv
    rng = np.random.default_rng(8)
    jx, tx = both(rng.standard_normal((2, 11, D)), "bf16")
    jy, jst = jrec.apply_rwkv_timemix(jp, jx)
    ty, tst = trec.apply_rwkv_timemix(tp, tx)
    close(ty, jy, BF16)
    close(tst["s"], jst["s"], BF16)
    close(tst["shift"], jst["shift"], 0)
    for step in range(3):
        jx, tx = both(rng.standard_normal((2, 1, D)), "bf16")
        jy, jst = jrec.apply_rwkv_timemix(jp, jx, state=jst, decode=True)
        ty, tst = trec.apply_rwkv_timemix(tp, tx, state=tst, decode=True)
        close(ty, jy, BF16)
        close(tst["s"], jst["s"], BF16)


def test_channelmix_with_and_without_state(rwkv):
    _, _, jp, tp = rwkv
    rng = np.random.default_rng(9)
    jx, tx = both(rng.standard_normal((2, 5, D)), "bf16")
    js, ts = both(rng.standard_normal((2, 1, D)), "bf16")
    for jstate, tstate in ((None, None), (js, ts)):
        jy, jsh = jrec.apply_rwkv_channelmix(jp, jx, jstate)
        ty, tsh = trec.apply_rwkv_channelmix(tp, tx, tstate)
        close(ty, jy, BF16)
        close(tsh, jsh, 0)


def test_rwkv_init_layout():
    import jax
    j = jrec.init_rwkv(jax.random.PRNGKey(0), D, H, DH, 3 * D)
    t = trec.init_rwkv(torch.Generator().manual_seed(0), D, H, DH, 3 * D)
    flat = lambda tree, p=(): [x for k, v in sorted(tree.items()) for x in (
        flat(v, p + (k,)) if isinstance(v, dict) else [(p + (k,), v)])]
    assert [(k, tuple(v.shape)) for k, v in flat(t)] == \
        [(k, v.shape) for k, v in flat(j)]
    st = trec.rwkv_init_state(3, D, H, DH)
    jst = jrec.rwkv_init_state(3, D, H, DH)
    assert {k: tuple(v.shape) for k, v in st.items()} == \
        {k: v.shape for k, v in jst.items()}
    assert st["s"].dtype == torch.float32
