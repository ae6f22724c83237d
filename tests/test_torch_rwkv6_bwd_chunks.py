"""The RWKV6 backward kernel's chunked algorithm, on the CPU.

``csrc/rwkv6_bwd.cu`` cannot run here; its algorithm can.
``tests/_rwkv6_bwd_chunks.py`` transcribes it into torch: the chunk-start
states (pass 1), the outputs' part of the state's cotangent at each chunk's
end (pass 2), and each chunk on its own (pass 3) with the kernel's 16-row
sub-chunk factoring of the decays and its prefix and suffix sums for
dlog_w. This file holds the transcription against ``rwkv6_bwd_ref`` (the
explicit formulas walked step by step) and against jax's vjp of ``repro``'s
sequential ``rwkv_ref``, on the same numpy inputs: T a multiple of 32 and
ragged (97, 33, 1), log decays -8, -54.6 (where dlog_w is about 1e-23)
and -3.4e-4 and the model's range, with and without s0 and a final state's
cotangent, head dims 16 and 64, and the chunk of 16 rows that the kernel
takes at head dim 128.

Tolerance: 2e-4 of each gradient's largest value (tests/test_kernels.py:23's
fp32 bound): all three sum the same products in fp32, in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _rwkv6_bwd_chunks import rwkv6_bwd_chunked
from repro.models import recurrent as jrec
from repro_torch.kernels import rwkv6 as rw
from test_torch_recurrent import one_torch_thread  # noqa: F401 — autouse

TOL = 2e-4
NAMES = ("dr", "dk", "dv", "dlog_w", "du", "ds0")

# (B, T, H, dh, log decay: a constant, or None for the model's range
# -e^(clip(N(0, 2), -8, 4)), s0 and dS given, chunk)
CASES = [(2, 64, 2, 16, None, True, 32), (1, 64, 2, 64, -8.0, True, 32),
         (1, 97, 2, 16, -54.6, True, 32), (1, 97, 2, 64, None, False, 32),
         (2, 33, 1, 16, -3.4e-4, True, 32), (1, 33, 2, 64, -54.6, False, 32),
         (2, 1, 2, 16, None, True, 32), (1, 1, 1, 64, -8.0, False, 32),
         (1, 40, 2, 16, None, True, 16)]


def _inputs(b, t, h, dh, lw, state, seed=0):
    rng = np.random.default_rng(seed + 7 * t + dh)
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
    if not state:
        s0 = ds = None
    return r, k, v, log_w, u, s0, do, ds


def _close(got, want, what):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_chunked_transcription_vs_plain_backward(case):
    """The transcription against ``rwkv6_bwd_ref``: every gradient finite
    and within 2e-4 of its largest, ds0 passed through from dS where no
    s0 is given."""
    *shape, chunk = case
    ins = _torch(*_inputs(*shape))
    got = rwkv6_bwd_chunked(*ins, chunk=chunk)
    want = rw.rwkv6_bwd_ref(*ins)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype, name
        _close(g, w.numpy(), name)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_chunked_transcription_vs_jax_vjp_of_rwkv_ref(case):
    """The transcription against jax's vjp of ``repro``'s sequential
    ``rwkv_ref`` (zeros for an s0 and a dS not given), within 2e-4 of each
    gradient's largest, down to log decay -54.6."""
    *shape, chunk = case
    r, k, v, log_w, u, s0, do, ds = _inputs(*shape)
    b, t, h, dh = r.shape
    zs = np.zeros((b, h, dh, dh), np.float32)
    _, vjp = jax.vjp(jrec.rwkv_ref, *(jnp.asarray(a) for a in (
        r, k, v, log_w, u, zs if s0 is None else s0)))
    want = vjp((jnp.asarray(do), jnp.asarray(zs if ds is None else ds)))
    got = rwkv6_bwd_chunked(*_torch(r, k, v, log_w, u, s0, do, ds),
                            chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        _close(g, np.asarray(w), name)


def test_chunked_transcription_in_bf16_rounds_as_the_kernel_returns():
    """bf16 r, k, v: the gradients of r, k, v come back in bf16, within two
    bf16 steps of the largest of the fp32 plain backward's; dlog_w, du and
    ds0 stay fp32 and within 2e-4."""
    r, k, v, log_w, u, s0, do, ds = _torch(*_inputs(2, 70, 2, 16, None,
                                                    True))
    rb, kb, vb = (x.bfloat16() for x in (r, k, v))
    got = rwkv6_bwd_chunked(rb, kb, vb, log_w, u, s0, do, ds)
    want = rw.rwkv6_bwd_ref(rb, kb, vb, log_w, u, s0, do, ds)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype, name
        if g.dtype == torch.bfloat16:
            err = (g.float() - w.float()).abs().max().item()
            assert err <= 2.0 ** -6 * w.float().abs().max().item(), name
        else:
            _close(g, w.numpy(), name)
