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
    assert set(build.CUDA_SOURCES) == {"matmul_tiled", "flash_attention"}
    assert set(build.TRITON_KERNELS) == {"staircase_fused"}
    assert set(build.LAUNCHES) == set(build.CUDA_SOURCES) \
        | set(build.TRITON_KERNELS)
    assert all((build.CSRC / f"{n}.cu").is_file()
               for n in build.CUDA_SOURCES)
    assert all((Path(build.__file__).parent / f"{n}.py").is_file()
               for n in build.TRITON_KERNELS)
