"""The gradients of the port's three scan and expert kernels on the training
path, on the CPU: the plain backwards of the grouped matmul
(``moe_gmm.moe_gmm_bwd_ref``), the RG-LRU (``rglru.rglru_bwd_ref``) and
RWKV6 (``rwkv6.rwkv6_bwd_ref``) against ``jax.vjp`` of the JAX package's
plain functions on the same numpy inputs, and the
``torch.autograd.Function``s that ``kernels.ops`` wraps them in (the wiring
that the card runs with the CUDA backward kernels) against autograd of the
plain forwards.

Tolerances, as tests/test_torch_attention_grad.py's: in fp32, 2e-4 of the
largest gradient (tests/test_kernels.py:23's fp32 bound), since both sides
sum the same products in other orders; with bf16 inputs a product's
gradients are each one fp32 sum rounded once to bf16, so they may land one
bf16 step apart, two steps (2^-6) of the largest value where a broadcast
x's per-expert gradients are summed after that rounding.

The plain RWKV6 forward takes the exponential of each pairwise log-decay
difference only where it is <= 0, so its gradient stays finite at steep
decays; ``repro``'s ``rwkv_chunked`` takes it of every difference and its
gradient is NaN from a log decay of -3 down (a reference defect that the
port deliberately does not share): the port is held to ``repro``'s
sequential ``rwkv_ref`` there, and to ``rwkv_chunked`` where that is finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import recurrent as jrec
from repro_torch.kernels import moe_gmm as mg
from repro_torch.kernels import ops
from repro_torch.kernels import rglru as rg
from repro_torch.kernels import rwkv6 as rw
from test_torch_recurrent import one_torch_thread  # noqa: F401 — autouse

FP32_TOL = 2e-4
BF16_STEP = 2.0 ** -7


def _close(got, want, tol, what=""):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all(), what
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, \
        (what, float(np.abs(got - want).max()), scale)


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


# ---------------------------------------------------------------------------
# moe_gmm
# ---------------------------------------------------------------------------
MOE_CASES = [(4, 24, 40, 16), (3, 65, 32, 48)]     # (E, C, D, F)


@pytest.mark.parametrize("broadcast", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MOE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_moe_gmm_bwd_ref_vs_jax_vjp(case, dtype, broadcast):
    """dX = dY W^T and dW = X^T dY against jax's vjp of ``moe_gmm_ref``; a
    broadcast x (the dense strategy's ``x.expand(E, T, D)``) gets its
    gradient summed over the experts in both."""
    e, c, d, f = case
    rng = np.random.default_rng(e * c + d)
    x = rng.standard_normal((c, d) if broadcast else (e, c, d)) \
        .astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    dy = rng.standard_normal((e, c, f)).astype(np.float32)
    td = getattr(torch, dtype)
    tx, tw = (torch.from_numpy(a).to(td).requires_grad_(True) for a in (x, w))
    tdy = torch.from_numpy(dy).to(td)
    xin = tx.expand(e, c, d) if broadcast else tx
    dx, dw = mg.moe_gmm_bwd_ref(xin.detach(), tw.detach(), tdy)
    assert dx.shape == (e, c, d) and dx.dtype == td and dw.dtype == td
    if broadcast:
        dx = dx.float().sum(0)
    jd = getattr(jnp, dtype)

    def f_(a, b):
        a = jnp.broadcast_to(a, (e, c, d)) if broadcast else a
        return jref.moe_gmm_ref(a, b)
    _, vjp = jax.vjp(f_, *(jnp.asarray(t.detach().float().numpy()).astype(jd)
                           for t in (tx, tw)))
    jdx, jdw = (np.asarray(g.astype(jnp.float32))
                for g in vjp(jnp.asarray(dy).astype(jd)))
    tol = FP32_TOL if dtype == "float32" else 2 * BF16_STEP
    _close(dx, jdx, tol if not broadcast else 2 * tol, "dx")
    _close(dw, jdw, tol, "dw")
    # the Function's CPU route is the plain backward
    out = ops.moe_gmm(xin, tw)
    assert out.grad_fn is not None and out.dtype == td
    with torch.no_grad():
        assert torch.equal(out, ops.moe_gmm(xin, tw))
    out.backward(tdy)
    assert torch.equal(tw.grad, mg.moe_gmm_bwd_ref(xin.detach(), tw.detach(),
                                                   tdy)[1])
    _close(tx.grad, jdx, tol if not broadcast else 2 * tol, "x.grad")


@pytest.mark.parametrize("broadcast", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_bwd_ref_on_transposed_views_vs_jax_vjp(dtype, broadcast):
    """``moe_gmm_bwd_ref`` on transposed views (x, w and dY each the
    ``transpose(1, 2)`` of a contiguous array; a broadcast x the expansion
    of a ``.t()`` view), as the backward's kernel now reads them: its
    result on contiguous copies bit for bit, and jax's vjp of
    ``moe_gmm_ref`` within the same tolerances."""
    e, c, d, f = MOE_CASES[1]
    rng = np.random.default_rng(11 + broadcast)
    x = rng.standard_normal((c, d) if broadcast else (e, c, d)) \
        .astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    dy = rng.standard_normal((e, c, f)).astype(np.float32)
    td = getattr(torch, dtype)
    if broadcast:
        tx = torch.from_numpy(x.T.copy()).to(td).t().expand(e, c, d)
    else:
        tx = torch.from_numpy(x.transpose(0, 2, 1).copy()).to(td) \
            .transpose(1, 2)
    tw, tdy = (torch.from_numpy(a.transpose(0, 2, 1).copy()).to(td)
               .transpose(1, 2) for a in (w, dy))
    assert not any(t.is_contiguous() for t in (tx, tw, tdy))
    got = mg.moe_gmm_bwd_ref(tx, tw, tdy)
    want = mg.moe_gmm_bwd_ref(tx.contiguous(), tw.contiguous(),
                              tdy.contiguous())
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    dx = got[0].float().sum(0) if broadcast else got[0]
    jd = getattr(jnp, dtype)

    def f_(a, b):
        a = jnp.broadcast_to(a, (e, c, d)) if broadcast else a
        return jref.moe_gmm_ref(a, b)
    xin = tx[0] if broadcast else tx
    _, vjp = jax.vjp(f_, *(jnp.asarray(t.float().numpy()).astype(jd)
                           for t in (xin, tw)))
    jdx, jdw = (np.asarray(g.astype(jnp.float32))
                for g in vjp(jnp.asarray(tdy.float().numpy()).astype(jd)))
    tol = FP32_TOL if dtype == "float32" else 2 * BF16_STEP
    _close(dx, jdx, tol if not broadcast else 2 * tol, "dx")
    _close(got[1], jdw, tol, "dw")


def test_moe_gmm_function_vs_autograd_of_plain():
    """The Function's gradients against autograd through ``moe_gmm_ref``
    itself, on the capacity strategy's shape (x not broadcast, fp32); and
    a weight that needs grad under an input that does not gets only dW."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 17, 12, generator=g).requires_grad_(True)
    w = torch.randn(4, 12, 9, generator=g).requires_grad_(True)
    dy = torch.randn(4, 17, 9, generator=g)
    got = torch.autograd.grad((ops.moe_gmm(x, w) * dy).sum(), (x, w))
    want = torch.autograd.grad((mg.moe_gmm_ref(x, w) * dy).sum(), (x, w))
    for a, b in zip(got, want):
        _close(a, b.numpy(), FP32_TOL)
    xd = x.detach()
    ops.moe_gmm(xd, w).sum().backward()
    assert xd.grad is None and w.grad.shape == w.shape


# ---------------------------------------------------------------------------
# rglru_scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,t,w", [(2, 17, 8), (1, 64, 33), (3, 1, 5)])
@pytest.mark.parametrize("dh_last", [False, True])
def test_rglru_bwd_ref_vs_jax_vjp(b, t, w, dh_last):
    """(da, db, dh0) against jax's vjp of ``rglru_ref`` with an h0 and,
    where given, a cotangent on the final state."""
    rng = np.random.default_rng(b * t + w)
    a = rng.uniform(0.2, 1.0, (b, t, w)).astype(np.float32)
    bb = rng.standard_normal((b, t, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    dy = rng.standard_normal((b, t, w)).astype(np.float32)
    dh = rng.standard_normal((b, w)).astype(np.float32) if dh_last \
        else np.zeros((b, w), np.float32)
    (ys, _), vjp = jax.vjp(jref.rglru_ref, jnp.asarray(a), jnp.asarray(bb),
                           jnp.asarray(h0))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    ta, tb, th0, tdy, tdh = _t(a, bb, h0, dy, dh)
    y, _ = rg.rglru_ref(ta, tb, th0)
    _close(y, np.asarray(ys), FP32_TOL, "y")
    got = rg.rglru_bwd_ref(ta, y, th0, tdy, tdh if dh_last else None)
    for name, g_, w_ in zip(("da", "db", "dh0"), got, want):
        _close(g_, np.asarray(w_), FP32_TOL, name)
    # the Function's CPU route against autograd of the plain forward
    ins = [x.clone().requires_grad_(True) for x in (ta, tb, th0)]
    yy, hh = ops.rglru_scan(*ins)
    assert yy.grad_fn is not None
    loss = (yy * tdy).sum() + ((hh * tdh).sum() if dh_last else 0.0)
    for name, g_, w_ in zip(("da", "db", "dh0"),
                            torch.autograd.grad(loss, ins), want):
        _close(g_, np.asarray(w_), FP32_TOL, name)


def test_rglru_bwd_ref_at_zero_steps_passes_dh_last_through():
    """T = 0: no step to walk, so dh0 is dh_last (zeros without one)."""
    a = torch.zeros(2, 0, 3)
    h0, dh = torch.randn(2, 3), torch.randn(2, 3)
    da, db, dh0 = rg.rglru_bwd_ref(a, a, h0, a, dh)
    assert da.shape == (2, 0, 3) and db.shape == (2, 0, 3)
    assert torch.equal(dh0, dh)
    assert torch.equal(rg.rglru_bwd_ref(a, a, h0, a)[2], torch.zeros(2, 3))


# ---------------------------------------------------------------------------
# rwkv6
# ---------------------------------------------------------------------------
# (B, T, H, dh, log decay: a constant, or None for the model's range
# -e^(clip(N(0, 2), -8, 4)), from -54.6 to -3.4e-4)
RWKV_CASES = [(1, 37, 2, 64, -0.37), (1, 37, 2, 64, -3.0),
              (1, 37, 2, 64, -8.0), (1, 37, 2, 64, -54.6),
              (2, 37, 2, 64, None), (1, 21, 2, 128, None)]


def _rwkv_inputs(b, t, h, dh, lw, seed=0):
    rng = np.random.default_rng(seed + t * dh + (0 if lw is None
                                                 else int(-lw * 10)))
    r, k, v = (0.5 * rng.standard_normal((b, t, h, dh)).astype(np.float32)
               for _ in range(3))
    if lw is None:
        log_w = -np.exp(np.clip(2 * rng.standard_normal((b, t, h, dh)),
                                -8, 4)).astype(np.float32)
    else:
        log_w = np.full((b, t, h, dh), lw, np.float32)
    u = 0.5 * rng.standard_normal((h, dh)).astype(np.float32)
    s0 = rng.standard_normal((b, h, dh, dh)).astype(np.float32)
    do = rng.standard_normal((b, t, h, dh)).astype(np.float32)
    ds = rng.standard_normal((b, h, dh, dh)).astype(np.float32)
    return r, k, v, log_w, u, s0, do, ds


def _jax_rwkv_grads(fn, r, k, v, log_w, u, s0, do, ds):
    (o, s), vjp = jax.vjp(fn, *(jnp.asarray(a)
                                for a in (r, k, v, log_w, u, s0)))
    return np.asarray(o), np.asarray(s), [
        np.asarray(g) for g in vjp((jnp.asarray(do), jnp.asarray(ds)))]


@pytest.mark.parametrize("case", RWKV_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_rwkv6_bwd_ref_vs_jax_vjp_of_rwkv_ref(case):
    """The explicit formulas from an s0 with a final state's cotangent,
    against jax's vjp of ``repro``'s sequential ``rwkv_ref``: every
    gradient finite and within 2e-4 of its largest, down to log decay
    -54.6 (where dlog_w is about 1e-23)."""
    ins = _rwkv_inputs(*case)
    _, _, want = _jax_rwkv_grads(jrec.rwkv_ref, *ins)
    got = rw.rwkv6_bwd_ref(*_t(*ins))
    names = ("dr", "dk", "dv", "dlog_w", "du", "ds0")
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        _close(g, w, FP32_TOL, name)


@pytest.mark.parametrize("lw", [-0.37, -2.0, None])
def test_rwkv6_bwd_ref_vs_jax_vjp_of_rwkv_chunked(lw):
    """Against ``repro``'s chunked form where its gradient is finite (log
    decays above -3: the model's range cut to [-2.7, -3.4e-4] for None)."""
    b, t, h, dh = 1, 32, 2, 64
    ins = list(_rwkv_inputs(b, t, h, dh, lw, seed=1))
    if lw is None:
        ins[3] = np.maximum(ins[3], -2.7).astype(np.float32)
    _, _, want = _jax_rwkv_grads(
        lambda *a: jrec.rwkv_chunked(*a, chunk=16), *ins)
    assert all(np.isfinite(w).all() for w in want)
    for g, w in zip(rw.rwkv6_bwd_ref(*_t(*ins)), want):
        _close(g, w, FP32_TOL)


@pytest.mark.parametrize("lw", [-3.0, -8.0, -54.6])
def test_plain_rwkv6_gradient_is_finite_at_steep_decay(lw):
    """Autograd through the plain chunked forward (``rwkv6_ref``, the
    kernel's oracle on the card) is finite at steep decays and equals
    jax's grad of ``repro``'s sequential ``rwkv_ref``; ``repro``'s own
    ``rwkv_chunked`` gives NaN there (the deliberate difference)."""
    b, t, h, dh = 1, 64, 2, 16
    rng = np.random.default_rng(int(-lw * 10))
    r, k, v = (rng.standard_normal((b, t, h, dh)).astype(np.float32)
               for _ in range(3))
    log_w = np.full((b, t, h, dh), lw, np.float32)
    u = rng.standard_normal((h, dh)).astype(np.float32)

    def loss(fn):
        return lambda *a: fn(*a)[0].sum()
    jin = [jnp.asarray(a) for a in (r, k, v, log_w, u)]
    want = jax.grad(loss(jrec.rwkv_ref), argnums=(0, 1, 2, 3, 4))(*jin)
    chunked = jax.grad(loss(lambda *a: jrec.rwkv_chunked(*a, chunk=32)),
                       argnums=3)(*jin)
    assert np.isnan(np.asarray(chunked)).any()
    ts = [x.requires_grad_(True) for x in _t(r, k, v, log_w, u)]
    o, _ = rw.rwkv6_ref(*ts, chunk=32)
    got = torch.autograd.grad(o.sum(), ts)
    for name, g, w in zip(("dr", "dk", "dv", "dlog_w", "du"), got, want):
        _close(g, np.asarray(w), FP32_TOL, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state", [False, True])
def test_rwkv6_function_vs_autograd_of_plain(dtype, state):
    """``ops.rwkv6`` on tensors that need grad: its output equals the
    forward alone, and its gradients (the plain backward) match autograd
    through ``rwkv6_ref`` with and without an s0 and a final state's
    cotangent; r, k, v's gradients come back in their dtype."""
    b, t, h, dh = 2, 29, 2, 16
    r, k, v, log_w, u, s0, do, ds = _rwkv_inputs(b, t, h, dh, None, seed=2)
    td = getattr(torch, dtype)
    rkv = [x.requires_grad_(True) for x in _t(r, k, v, dtype=td)]
    rest = [x.requires_grad_(True) for x in _t(log_w, u)]
    ts0 = _t(s0)[0].requires_grad_(True) if state else None
    tdo, tds = _t(do, ds)
    ins = rkv + rest + ([ts0] if state else [])

    def run(fn):
        o, s = fn(*rkv, *rest, ts0, chunk=8)
        loss = (o * tdo).sum() + ((s * tds).sum() if state else 0.0)
        return o, torch.autograd.grad(loss, ins)
    o, got = run(ops.rwkv6)
    with torch.no_grad():
        assert torch.equal(o, ops.rwkv6(*rkv, *rest, ts0, chunk=8)[0])
    _, want = run(rw.rwkv6_ref)
    for x, g, w in zip(ins, got, want):
        assert g.dtype == x.dtype
        tol = FP32_TOL if x.dtype == torch.float32 else 2 * BF16_STEP
        _close(g, w.float().numpy(), tol)


def test_rwkv6_function_only_output_grad():
    """The final state unused (the training loss): the backward gets no
    state cotangent and still matches autograd of the plain forward."""
    r, k, v, log_w, u, _, do, _ = _rwkv_inputs(1, 40, 2, 16, -8.0, seed=3)
    ts = [x.requires_grad_(True) for x in _t(r, k, v, log_w, u)]
    tdo = _t(do)[0]
    got = torch.autograd.grad((ops.rwkv6(*ts)[0] * tdo).sum(), ts)
    want = torch.autograd.grad((rw.rwkv6_ref(*ts)[0] * tdo).sum(), ts)
    for g, w in zip(got, want):
        _close(g, w.numpy(), FP32_TOL)
