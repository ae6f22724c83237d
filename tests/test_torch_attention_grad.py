"""The gradients of the port's two kernels on the training path, on the CPU:
the plain backward of attention (``flash_attention.attention_bwd_ref``) and
of the tiled matmul (``matmul_tiled.matmul_bwd_ref``) against ``jax.grad``
of the JAX package's plain functions on the same numpy inputs, and the
``torch.autograd.Function``s that ``kernels.ops`` wraps them in (the wiring
that the card runs with the CUDA backward kernels). The other kernels'
gradients are tests/test_torch_scan_grad.py's.

Tolerances: in fp32, 2e-4 of the largest gradient (tests/test_kernels.py:23's
fp32 bound): both sides sum the same products in other orders, which moves
each fp32 result by a few ulps of the largest term. With bf16 inputs the
product's gradients are each one fp32 sum rounded once to bf16, so they
may land one bf16 step apart (2^-7 of the largest value); attention's bf16
gradients are held at 4e-2 of the largest (the bf16 bound of
tests/test_kernels.py:23), since the port rounds O before the backward
reads it, as the card does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul_tiled as mt
from repro_torch.kernels import ops
from test_torch_recurrent import one_torch_thread  # noqa: F401

FP32_TOL = 2e-4
BF16_TOL = 4e-2
BF16_STEP = 2.0 ** -7

# (B, Sq, Skv, H, KV, dh, mask, window): the training shape cut down,
# GQA groups 2 and 7, ragged S, Sq != Skv unmasked, dh 128, local
CASES = [(2, 64, 64, 4, 4, 64, "causal", 0),
         (1, 100, 100, 4, 2, 64, "causal", 0),
         (1, 70, 70, 7, 1, 64, "causal", 0),
         (2, 33, 33, 14, 2, 128, "none", 0),
         (1, 40, 97, 7, 1, 64, "none", 0),
         (1, 80, 80, 4, 2, 64, "local", 24)]


def _inputs(case, dtype=np.float32):
    b, sq, skv, h, kv, dh, _, _ = case
    rng = np.random.default_rng(sq * 7 + h)
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, skv, kv, dh)).astype(np.float32)
    v = rng.standard_normal((b, skv, kv, dh)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, mask, window, dtype=jnp.float32):
    def f(q, k, v):
        return jref.attention_ref(q, k, v, mask_kind=mask, window=window)
    out, vjp = jax.vjp(f, *(jnp.asarray(a).astype(dtype) for a in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(do).astype(out.dtype))]


def _close(got, want, tol):
    got = got.float().numpy() if torch.is_tensor(got) else got
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, \
        (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_bwd_ref_vs_jax_grad(case):
    """The explicit formulas from (O, lse) against jax's autodiff of the
    reference's plain attention, in fp32."""
    *_, mask, window = case
    q, k, v, do = _inputs(case)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = fa.attention_ref(tq, tk, tv, mask_kind=mask, window=window,
                              lse=True)
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    assert lse.dtype == torch.float32
    got = fa.attention_bwd_ref(tq, tk, tv, o, lse, tdo, mask_kind=mask,
                               window=window)
    for g, w in zip(got, _jax_grads(q, k, v, do, mask, window)):
        _close(g, w, FP32_TOL)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_function_backward_is_the_plain_backward(case):
    """``ops.flash_attention`` on tensors that need grad: the output equals
    the forward alone, and autograd's (dq, dk, dv) are exactly
    ``attention_bwd_ref`` on the saved output and lse; in bf16 they are
    within 4e-2 of jax's grads of the same bf16 inputs."""
    *_, mask, window = case
    q, k, v, do = _inputs(case)
    ts = [torch.from_numpy(a).bfloat16().requires_grad_(True)
          for a in (q, k, v)]
    tdo = torch.from_numpy(do).bfloat16()
    out = ops.flash_attention(*ts, mask_kind=mask, window=window)
    assert out.grad_fn is not None
    with torch.no_grad():
        plain = ops.flash_attention(*ts, mask_kind=mask, window=window)
    assert plain.grad_fn is None and torch.equal(out, plain)
    out.backward(tdo)
    o, lse = fa.attention_ref(*(t.detach() for t in ts), mask_kind=mask,
                              window=window, lse=True)
    want = fa.attention_bwd_ref(*(t.detach() for t in ts), o, lse, tdo,
                                mask_kind=mask, window=window)
    for t, w in zip(ts, want):
        assert t.grad.dtype == torch.bfloat16 and torch.equal(t.grad, w)
    bf = [np.asarray(t.detach().float().numpy()) for t in ts]
    jg = _jax_grads(*bf, tdo.float().numpy(), mask, window,
                    dtype=jnp.bfloat16)
    for t, w in zip(ts, jg):
        _close(t.grad, w, BF16_TOL)


@pytest.mark.parametrize("m,k,n", [(64, 96, 80), (100, 130, 70),
                                   (256, 64, 176)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_function_backward_vs_jax_grad(m, k, n, dtype):
    """``ops.matmul`` on tensors that need grad: autograd's dX and dW are
    ``matmul_bwd_ref``'s (dY W^T and X^T dY, fp32 sums cast to the inputs'
    dtype) and agree with jax's grads of x @ w."""
    rng = np.random.default_rng(m + k + n)
    x, w = (rng.standard_normal(s).astype(np.float32) for s in
            ((m, k), (k, n)))
    dy = rng.standard_normal((m, n)).astype(np.float32)
    td = getattr(torch, dtype)
    tx, tw = (torch.from_numpy(a).to(td).requires_grad_(True)
              for a in (x, w))
    tdy = torch.from_numpy(dy).to(td)
    out = ops.matmul(tx, tw)
    assert out.grad_fn is not None and out.dtype == td
    out.backward(tdy)
    want = mt.matmul_bwd_ref(tx.detach(), tw.detach(), tdy)
    assert torch.equal(tx.grad, want[0]) and torch.equal(tw.grad, want[1])
    jd = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda a, b: jnp.matmul(
        a, b, preferred_element_type=jnp.float32).astype(jd),
        *(jnp.asarray(t.detach().float().numpy()).astype(jd)
          for t in (tx, tw)))
    jg = vjp(jnp.asarray(tdy.float().numpy()).astype(jd))
    tol = FP32_TOL if dtype == "float32" else 2 * BF16_STEP
    for t, g in zip((tx, tw), jg):
        _close(t.grad, np.asarray(g.astype(jnp.float32)), tol)


@pytest.mark.parametrize("m,k,n", [(64, 96, 80), (100, 130, 70)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_bwd_ref_on_transposed_views_vs_jax_vjp(m, k, n, dtype):
    """``matmul_bwd_ref`` on operands that are transposed views (x, w and
    dY each the ``.t()`` of a contiguous array), as the backward's kernel
    now reads them where they lie: its result on contiguous copies bit for
    bit, and jax's vjp of x @ w within the same tolerances."""
    rng = np.random.default_rng(7 * m + n)
    x, w, dy = (rng.standard_normal(s).astype(np.float32) for s in
                ((m, k), (k, n), (m, n)))
    td = getattr(torch, dtype)
    tx, tw, tdy = (torch.from_numpy(a.T.copy()).to(td).t()
                   for a in (x, w, dy))
    assert not any(t.is_contiguous() for t in (tx, tw, tdy))
    got = mt.matmul_bwd_ref(tx, tw, tdy)
    want = mt.matmul_bwd_ref(tx.contiguous(), tw.contiguous(),
                             tdy.contiguous())
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    jd = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda a, b: jnp.matmul(
        a, b, preferred_element_type=jnp.float32).astype(jd),
        *(jnp.asarray(t.float().numpy()).astype(jd) for t in (tx, tw)))
    jg = vjp(jnp.asarray(tdy.float().numpy()).astype(jd))
    tol = FP32_TOL if dtype == "float32" else 2 * BF16_STEP
    for t, g in zip(got, jg):
        _close(t, np.asarray(g.astype(jnp.float32)), tol)


def test_matmul_function_skips_unneeded_grads():
    """A weight that needs grad under an input that does not: only dW."""
    x = torch.randn(70, 32).bfloat16()
    w = torch.randn(32, 24).bfloat16().requires_grad_(True)
    ops.matmul(x, w).float().sum().backward()
    assert x.grad is None and w.grad.shape == w.shape
    with torch.no_grad():
        assert ops.matmul(x, w).grad_fn is None
