"""The port's kernel modules on the CPU: each plain version against the JAX
package's Pallas kernel (interpret mode) and oracle on the same numpy
inputs, the dispatch by device, and the build's behaviour without nvcc.
The CUDA kernels themselves run in tests/test_torch_cuda.py on the card."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul_tiled as mt
from repro_torch.kernels import rglru as rg
from repro_torch.kernels import rwkv6 as rw

# tests/test_kernels.py:23
TOL = {"float32": 2e-4, "bfloat16": 4e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def pair(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def as_np(t):
    return t.float().numpy() if torch.is_tensor(t) else \
        np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("m,n,k", [(128, 128, 128), (256, 384, 512),
                                   (100, 130, 70), (64, 257, 129)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_plain_vs_pallas(m, n, k, dtype):
    rng = np.random.default_rng(m * n + k)
    jx, tx = pair(rng, (m, k), dtype)
    jw, tw = pair(rng, (k, n), dtype)
    got = ops.matmul(tx, tw)
    assert got.dtype == tx.dtype and tuple(got.shape) == (m, n)
    want = jops.matmul(jx, jw, block_m=64, block_n=64, block_k=64,
                       force="pallas_interpret")
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=TOL[dtype],
                               atol=TOL[dtype] * 8)


@pytest.mark.parametrize("mask,window", [("causal", 0), ("local", 48),
                                         ("none", 0)])
@pytest.mark.parametrize("b,s,h,kv,dh", [(2, 128, 8, 2, 64),
                                         (1, 100, 4, 4, 64),
                                         (2, 100, 4, 1, 128)])
def test_flash_plain_vs_pallas_and_oracle(mask, window, b, s, h, kv, dh):
    rng = np.random.default_rng(s + h + dh)
    jq, tq = pair(rng, (b, s, h, dh), "float32")
    jk, tk = pair(rng, (b, s, kv, dh), "float32")
    jv, tv = pair(rng, (b, s, kv, dh), "float32")
    got = ops.flash_attention(tq, tk, tv, mask_kind=mask, window=window)
    oracle = jref.attention_ref(jq, jk, jv, mask_kind=mask, window=window)
    np.testing.assert_allclose(as_np(got), as_np(oracle), rtol=2e-4,
                               atol=2e-4)
    if mask == "none" and s % 64:
        return     # repro's wrapper refuses to pad kv for an unmasked S
    want = jops.flash_attention(jq, jk, jv, mask_kind=mask, window=window,
                                block_q=64, block_kv=64,
                                force="pallas_interpret")
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=2e-4,
                               atol=2e-4)


def test_flash_plain_bf16_vs_pallas():
    rng = np.random.default_rng(9)
    jq, tq = pair(rng, (1, 128, 4, 64), "bfloat16")
    jk, tk = pair(rng, (1, 128, 2, 64), "bfloat16")
    jv, tv = pair(rng, (1, 128, 2, 64), "bfloat16")
    got = ops.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    want = jops.flash_attention(jq, jk, jv, block_q=64, block_kv=64,
                                force="pallas_interpret")
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=TOL["bfloat16"],
                               atol=TOL["bfloat16"])


def test_grid_blocks_is_eq3_b():
    # K is looped inside each CTA, so it is no grid axis (unlike Pallas)
    assert mt.grid_blocks(100, 130) == 2 * 3
    assert mt.grid_blocks(512, 2816) == 8 * 44
    assert mt.grid_blocks(4, 2816) == 44


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((7, 3)).astype(np.float32))
    before = dict(ops.LAUNCHES)
    torch.testing.assert_close(ops.matmul(x, w), mt.matmul_ref(x, w),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.matmul(x, w, force="plain"),
                               mt.matmul_ref(x, w), rtol=0, atol=0)
    assert dict(ops.LAUNCHES) == before
    with pytest.raises(ValueError, match="force"):
        ops.matmul(x, w, force="kernel")


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never computes off the card: it raises, counts no
    launch and builds nothing."""
    x = torch.zeros(4, 8, dtype=torch.bfloat16)
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        mt.matmul_tiled(x, x.T.contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q)
    assert dict(ops.LAUNCHES) == before


def test_dispatch_refuses_other_devices():
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.matmul(x, torch.empty(8, 2, device="meta"))


def test_build_without_nvcc_names_it(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "kernels"))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.compile_source("matmul_tiled")
    assert not (tmp_path / "kernels").exists() or \
        not any((tmp_path / "kernels").iterdir())


def test_library_path_tracks_the_source(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    p = build.library_path("flash_attention")
    assert p.parent == tmp_path and p.name.startswith("flash_attention-")
    assert p == build.library_path("flash_attention")
    assert p != build.library_path("matmul_tiled")
    assert set(build.CUDA_SOURCES) == {"matmul_tiled", "flash_attention",
                                       "rwkv6", "moe_gmm"}
    assert set(build.TRITON_KERNELS) == {"staircase_fused", "rglru_scan"}
    assert set(build.LAUNCHES) == set(build.CUDA_SOURCES) \
        | set(build.TRITON_KERNELS)
    assert all((build.CSRC / f"{n}.cu").is_file()
               for n in build.CUDA_SOURCES)
    assert all((Path(build.__file__).parent / f"{m}.py").is_file()
               for m in build.TRITON_KERNELS.values())


# ---------------------------------------------------------------------------
# the recurrences: RG-LRU (Triton kernel) and RWKV6 (CUDA kernel)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,t,w,ct,bw", [(2, 64, 128, 8, 128),
                                         (1, 32, 256, 4, 128),
                                         (3, 16, 128, 16, 64)])
def test_rglru_plain_vs_pallas_and_oracle(b, t, w, ct, bw):
    """The sweep of tests/test_kernels.py:73-75, at its 1e-5."""
    from repro.kernels.rglru import rglru_pallas
    rng = np.random.default_rng(b * t + w)
    a = rng.uniform(0.3, 0.999, size=(b, t, w)).astype(np.float32)
    x = rng.standard_normal((b, t, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    y, h = ops.rglru_scan(*(torch.from_numpy(v) for v in (a, x, h0)))
    assert y.dtype == h.dtype == torch.float32
    for want in (rglru_pallas(jnp.asarray(a), jnp.asarray(x),
                              jnp.asarray(h0), chunk_t=ct, block_w=bw,
                              interpret=True),
                 jref.rglru_ref(jnp.asarray(a), jnp.asarray(x),
                                jnp.asarray(h0))):
        np.testing.assert_allclose(as_np(y), as_np(want[0]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(as_np(h), as_np(want[1]), rtol=1e-5,
                                   atol=1e-5)


def test_rglru_plain_edges():
    """T = 1, T = 0 and a ragged W (which the TPU wrapper refuses)."""
    rng = np.random.default_rng(11)
    for t, w in ((1, 300), (0, 8), (5, 2500)):
        a = torch.from_numpy(rng.uniform(0.3, 0.999, (2, t, w))
                             .astype(np.float32))
        x = torch.from_numpy(rng.standard_normal((2, t, w))
                             .astype(np.float32))
        h0 = torch.from_numpy(rng.standard_normal((2, w)).astype(np.float32))
        y, h = rg.rglru_ref(a, x, h0)
        assert tuple(y.shape) == (2, t, w)
        want_y, want_h = jref.rglru_ref(jnp.asarray(a.numpy()),
                                        jnp.asarray(x.numpy()),
                                        jnp.asarray(h0.numpy()))
        np.testing.assert_allclose(as_np(h), as_np(want_h), rtol=1e-5,
                                   atol=1e-5)
        if t:
            np.testing.assert_allclose(as_np(y), as_np(want_y), rtol=1e-5,
                                       atol=1e-5)
    assert rg.grid_programs(4, 2560) == 80 and rg.grid_programs(4, 2500) == 80


def rwkv_case(seed, b, t, h, dh, lw=None, s0=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, h, dh)).astype(np.float32)
               for _ in range(3))
    if lw is None:
        lw = -np.exp(np.clip(rng.standard_normal((b, t, h, dh)), -8, 1))
    else:
        lw = np.full((b, t, h, dh), lw)
    u = (0.1 * rng.standard_normal((h, dh))).astype(np.float32)
    st = (rng.standard_normal((b, h, dh, dh)).astype(np.float32)
          if s0 else None)
    return r, k, v, lw.astype(np.float32), u, st


@pytest.mark.parametrize("b,t,h,dh,lw,s0", [
    (2, 64, 2, 64, None, False), (1, 32, 4, 32, None, False),
    (2, 128, 1, 64, None, False),          # tests/test_kernels.py:84-86
    (2, 97, 2, 16, None, True),            # a prime T: a ragged last chunk
    (1, 40, 2, 16, -54.6, True),           # -e^4, the model's floor
    (1, 40, 2, 16, -8.0, False),
    (1, 40, 2, 16, -3.4e-4, True),         # -e^-8, the model's ceiling
])
def test_rwkv6_plain_vs_sequential_oracle(b, t, h, dh, lw, s0):
    """``rwkv6_ref`` (and ``ops.rwkv6`` on the CPU) against ``repro``'s
    sequential ``rwkv_ref``, not against ``rwkv6_pallas`` (which overflows
    for log decays <= -3): finite, and within 2e-4 (tests/test_recurrent.py
    :82), output and final state."""
    from repro.models.recurrent import rwkv_ref
    case = rwkv_case(b * t + h, b, t, h, dh, lw, s0)
    tin = [None if a is None else torch.from_numpy(a) for a in case]
    jo, js = rwkv_ref(*(None if a is None else jnp.asarray(a) for a in case))
    before = dict(ops.LAUNCHES)
    for o, s in (rw.rwkv6_ref(*tin), ops.rwkv6(*tin)):
        assert o.dtype == s.dtype == torch.float32
        assert torch.isfinite(o).all() and torch.isfinite(s).all()
        for got, want in ((o, jo), (s, js)):
            want = as_np(want)
            np.testing.assert_allclose(as_np(got), want, rtol=2e-4,
                                       atol=2e-4 * max(1.0,
                                                       np.abs(want).max()))
    assert dict(ops.LAUNCHES) == before


def test_rwkv6_plain_bf16_inputs_and_chunks():
    """bf16 r, k, v (the model's) are read as fp32; the chunk size changes
    only the order of fp32 sums."""
    r, k, v, lw, u, _ = rwkv_case(12, 2, 50, 2, 16)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (r, k, v)]
    tf = [t.float() for t in tb]
    lw, u = torch.from_numpy(lw), torch.from_numpy(u)
    want = rw.rwkv6_ref(*tf, lw, u)
    for chunk in (1, 16, 32, 64):
        got = rw.rwkv6_ref(*tb, lw, u, chunk=chunk)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=2e-4,
                                       atol=2e-4 * w.abs().max().item())


def test_recurrence_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 4, 8)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        rg.rglru_scan(x, x, x[:, 0])
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rw.rwkv6(q, q, q, q, torch.zeros(2, 8))
    assert dict(ops.LAUNCHES) == before
