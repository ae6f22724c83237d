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
from test_torch_cuda import one_hot_attention
from test_torch_recurrent import one_torch_thread  # noqa: F401

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


@pytest.mark.parametrize("b,s,h,kv,dh", [(1, 128, 16, 8, 64),
                                         (1, 65, 4, 2, 128),
                                         (1, 200, 4, 2, 128)])
def test_flash_plain_vs_pallas_kernel_shapes(b, s, h, kv, dh):
    """The shapes the CUDA kernel's tests add, on the plain version against
    repro's kernel (interpret mode, padded by its wrapper): granite's GQA
    map (16 heads on 8 kv heads) and kv lengths past a 64-row block."""
    rng = np.random.default_rng(b + s + h + dh)
    jq, tq = pair(rng, (b, s, h, dh), "bfloat16")
    jk, tk = pair(rng, (b, s, kv, dh), "bfloat16")
    jv, tv = pair(rng, (b, s, kv, dh), "bfloat16")
    got = ops.flash_attention(tq, tk, tv)
    want = jops.flash_attention(jq, jk, jv, block_q=64, block_kv=64,
                                force="pallas_interpret")
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=TOL["bfloat16"],
                               atol=TOL["bfloat16"])


@pytest.mark.parametrize("dh", [64, 128])
def test_flash_one_hot_inputs_pick_rows(dh):
    """The inputs of the CUDA kernel's P @ V identity check: in the plain
    version and in repro's kernel alike, attention returns v[pi]."""
    q, k, v, pi = one_hot_attention(dh)
    want = v[0, pi, 0].float().numpy()
    got = ops.flash_attention(q, k, v, mask_kind="none")
    assert np.abs(as_np(got)[0, :, 0] - want).max() <= 1e-2
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (q, k, v))
    pallas = jops.flash_attention(jq, jk, jv, mask_kind="none",
                                  block_q=64, block_kv=64,
                                  force="pallas_interpret")
    assert np.abs(as_np(pallas)[0, :, 0] - want).max() <= 1e-2


def test_flash_grid_blocks():
    """One CTA per (batch x head, 64-row query block)."""
    assert fa.grid_blocks(4, 128, 16) == 128
    assert fa.grid_blocks(1, 65, 8) == 16 and fa.grid_blocks(2, 1, 3) == 6


def test_grid_blocks_is_eq3_b():
    """The CTAs the kernel launches: prefill (M > 64) one per 128 x 64 tile
    over all of K; decode one per 64 x 64 tile and K chunk of 256."""
    assert (mt.BLOCK_M, mt.BLOCK_N, mt.DECODE_BLOCK_M, mt.SPLIT_K) == (
        128, 64, 64, 256)
    assert mt.grid_blocks(100, 130, 70) == 1 * 3
    assert mt.grid_blocks(512, 2816, 1024) == 4 * 44
    assert mt.grid_blocks(512, 1024, 2816) == 4 * 16
    # qwen1.5-0.5b's and recurrentgemma-2b's decode products (M = 4): at
    # least one full wave of 132 CTAs
    assert mt.grid_blocks(4, 2816, 1024) == 44 * 4
    assert mt.grid_blocks(4, 1024, 2816) == 16 * 11
    assert mt.grid_blocks(4, 7680, 2560) == 120 * 10
    assert mt.grid_blocks(4, 2560, 7680) == 40 * 30
    assert mt.grid_blocks(64, 64, 257) == 2 and mt.grid_blocks(65, 64, 257) \
        == 1
    assert mt.grid_blocks(4, 64, 0) == 0


@pytest.mark.parametrize("m", [1, 4, 64, 65, 129, 512])
@pytest.mark.parametrize("k", [1, 63, 64, 255, 256, 257, 600, 2752, 2816,
                               7680])
def test_schedule_chunks_cover_k_once_and_ignore_n(m, k):
    """The kernel's schedule: M <= 64 takes the decode form, whose chunks
    start at multiples of SPLIT_K and cover [0, K) once, in order; more
    rows take the prefill form, one range over all of K. N changes
    nothing."""
    form, chunks = mt.schedule(m, 64, k)
    assert form == ("decode" if m <= mt.DECODE_BLOCK_M else "prefill")
    assert chunks[0][0] == 0 and chunks[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(0 < k1 - k0 <= (mt.SPLIT_K if form == "decode" else k)
               for k0, k1 in chunks)
    if form == "decode":
        assert [k0 for k0, _ in chunks] == list(range(0, k, mt.SPLIT_K))
    else:
        assert chunks == [(0, k)]
    for n in (1, 63, 2752, 2816, 7680):
        assert mt.schedule(m, n, k) == (form, chunks)


def split_k_model(x, w):
    """A pure-torch model of the kernel's sum order on ``mt.schedule``'s
    chunks: per chunk, K tiles of 64 (the last zero-padded, as TMA fills
    it) summed in fp32 in order; the chunks' partials summed in order;
    cast to x.dtype."""
    m, k = x.shape
    n = w.shape[1]
    total = None
    for k0, k1 in mt.schedule(m, n, k)[1]:
        part = torch.zeros(m, n)
        for t in range(k0, k1, 64):
            span = min(64, k1 - t)
            xt, wt = torch.zeros(m, 64), torch.zeros(64, n)
            xt[:, :span], wt[:span] = x[:, t:t + span], w[t:t + span]
            part = part + xt @ wt
        total = part if total is None else total + part
    return total.to(x.dtype)


@pytest.mark.parametrize("m,k,pad", [(4, 600, 40), (4, 500, 20),
                                     (4, 2752, 64), (100, 300, 70)])
def test_split_order_is_bit_identical_under_zero_padding(m, k, pad):
    """The kernel's sum order (:func:`split_k_model`: fp32 K tiles in order
    within a chunk, the chunks' partials in order) gives the same bits for
    K and for K padded with zero rows of w (and zero columns of x), also
    where the padding adds a K tile or a whole chunk (500 -> 520); the
    columns that a narrower w keeps are bit-equal too."""
    rng = np.random.default_rng(m + k + pad)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, 72)).astype(np.float32))
    x, w = x.bfloat16(), w.bfloat16()
    got = split_k_model(x, w)
    xp = torch.cat([x, torch.zeros(m, pad, dtype=x.dtype)], 1)
    wp = torch.cat([w, torch.zeros(pad, 72, dtype=w.dtype)], 0)
    assert torch.equal(got, split_k_model(xp, wp))
    wn = torch.cat([w, torch.zeros(k, pad, dtype=w.dtype)], 1)
    assert torch.equal(got, split_k_model(x, wn)[:, :72])
    assert torch.equal(split_k_model(x, w[:, :40]), got[:, :40])
    torch.testing.assert_close(got.float(), mt.matmul_ref(x, w).float(),
                               rtol=2.0 ** -7, atol=2.0 ** -7 * float(
                                   mt.matmul_ref(x, w).float().abs().max()))


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
                                       "rwkv6", "moe_gmm", "rglru_scan",
                                       "flash_attention_bwd",
                                       "rglru_scan_bwd", "rwkv6_bwd"}
    assert set(build.TRITON_KERNELS) == {"staircase_fused", "staircase_cta",
                                         "adamw"}
    assert build.EXTRA_COUNTS == ("matmul_tiled_bwd", "moe_gmm_bwd")
    assert set(build.LAUNCHES) == set(build.CUDA_SOURCES) \
        | set(build.TRITON_KERNELS) | set(build.EXTRA_COUNTS)
    assert all((build.CSRC / f"{n}.cu").is_file()
               for n in build.CUDA_SOURCES)
    assert all((Path(build.__file__).parent / f"{m}.py").is_file()
               for m in build.TRITON_KERNELS.values())
    # an edit to a shared header builds anew: the hash covers csrc/*.cuh
    assert (build.CSRC / "gemm_sm90.cuh").is_file()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.library_path("moe_gmm")
    assert before.name == build.library_path("moe_gmm").name
    header = csrc / "gemm_sm90.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    assert build.library_path("moe_gmm") != before
    assert build.library_path("matmul_tiled") != p


# ---------------------------------------------------------------------------
# the recurrences: RG-LRU and RWKV6 (CUDA kernels)
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
    assert rg.form(4, 128, 2560)["ctas"] == 320 \
        and rg.form(4, 128, 2500)["ctas"] == 316


def largest_divisor(n: int, cap: int) -> int:
    return max(d for d in range(1, min(n, cap) + 1) if n % d == 0)


def rglru_windows_np(a, b, h0, *, window: int, warps: int = rg.WARPS):
    """numpy mirror of ``csrc/rglru_scan.cu``'s arithmetic, over all batch
    rows and channels at once: T in windows of ``window`` steps; in each,
    warp w's quarter walked from zero into its map h -> P h + Y (steps past
    T the identity), the carry into each quarter folded in order through
    the earlier quarters' maps from the window's carry, each quarter
    re-walked from its carry writing y, and the next window's carry the y
    of this window's last step."""
    bsz, t, w = a.shape
    seg = window // warps
    y = np.empty_like(a)
    h = h0.astype(np.float32)
    for t0 in range(0, t, window):
        n = min(window, t - t0)
        maps = []
        for wp in range(warps):
            p_, y_ = np.ones((bsz, w), np.float32), np.zeros((bsz, w),
                                                             np.float32)
            for k in range(wp * seg, (wp + 1) * seg):
                at = a[:, t0 + k] if k < n else np.float32(1)
                bt = b[:, t0 + k] if k < n else np.float32(0)
                y_ = at * y_ + bt
                p_ = p_ * at
            maps.append((p_, y_))
        for wp in range(warps):
            carry = h
            for p_, y_ in maps[:wp]:
                carry = p_ * carry + y_
            for k in range(wp * seg, min((wp + 1) * seg, n)):
                carry = a[:, t0 + k] * carry + b[:, t0 + k]
                y[:, t0 + k] = carry
            if wp == (n - 1) // seg:
                hand = carry
        h = hand
    return y, h


def model_decays(rng, shape, lo: float, hi: float):
    """``a = exp(-8 softplus(L) r)`` (the model's gate, r in (0, 1)) with
    softplus(L) drawn so that a spans [lo, hi]."""
    r = rng.uniform(0.0, 1.0, shape)
    c = rng.uniform(-np.log(hi), -np.log(lo), shape) / 8.0
    return np.exp(-8.0 * c * r).clip(lo, hi).astype(np.float32)


@pytest.mark.parametrize("b,t,w,decays,window", [
    (2, 1, 64, (0.3, 0.999), None),
    (2, 31, 33, (0.3, 0.999), None),      # ragged T and W
    (1, 33, 100, (1e-6, 0.05), None),     # a near 0
    (2, 129, 64, (0.99, 0.99999), None),  # a near 1, two windows
    (1, 300, 40, (1e-6, 0.99999), None),  # three windows, a ragged last
    (3, 300, 44, (0.3, 0.999), None),     # the same at batch 3
    (1, 300, 36, (0.3, 0.999), 32),       # ten windows of 32
    (2, 97, 20, (0.5, 0.9999), 64),
])
def test_rglru_window_decomposition_vs_pallas_and_oracle(b, t, w, decays,
                                                         window):
    """The kernel's decomposition (mirrored in numpy), from a non-zero h0,
    against ``rglru_pallas`` (interpret mode) and the reference's oracle,
    at the reference's 1e-5; the plain version too. h_last is the mirror's
    last y, bit for bit."""
    from repro.kernels.rglru import rglru_pallas
    rng = np.random.default_rng(t * 1000 + w)
    a = model_decays(rng, (b, t, w), *decays)
    x = rng.standard_normal((b, t, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    window = window or rg.form(b, t, w)["window"]
    y, h = rglru_windows_np(a, x, h0, window=window)
    assert np.array_equal(h, y[:, -1])
    ty, th = rg.rglru_ref(*(torch.from_numpy(v) for v in (a, x, h0)))
    pallas = rglru_pallas(jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0),
                          chunk_t=largest_divisor(t, 64),
                          block_w=largest_divisor(w, 128), interpret=True)
    oracle = jref.rglru_ref(jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0))
    for want_y, want_h in (pallas, oracle, (ty, th)):
        np.testing.assert_allclose(y, as_np(want_y), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(h, as_np(want_h), rtol=1e-5, atol=1e-5)


def test_rglru_form():
    """The host's form: a CTA per batch row and 32 channels (320 at
    recurrentgemma-2b's prefill), the window that holds T (else 128 steps),
    ring slots no more than the windows, at most 227 KB of shared memory,
    TMA only for 16-byte rows on 16-byte aligned bases."""
    f = rg.form(4, 128, 2560)
    assert (f["ctas"], f["channels"], f["warps"]) == (320, 32, 4)
    assert (f["window"], f["stages"], f["route"]) == (128, 1, "tma")
    assert rg.form(4, 1, 2560)["window"] == 32
    assert rg.form(1, 64, 2560)["window"] == 64
    assert rg.form(2, 97, 2501)["route"] == "cp.async"
    assert rg.form(4, 128, 2500)["route"] == "tma"
    assert rg.form(4, 128, 2560, aligned=False)["route"] == "cp.async"
    for b, t, w in ((1, 2048, 2560), (4, 2048, 2560), (1, 300, 64),
                    (2, 97, 2501), (1, 5, 1), (64, 4096, 4096)):
        f = rg.form(b, t, w)
        assert f["ctas"] == b * -(-w // 32)
        assert 1 <= f["stages"] <= min(rg.MAX_STAGES, -(-t // f["window"]))
        assert f["smem_bytes"] == rg.smem_bytes(f["window"], f["stages"])
        assert f["smem_bytes"] <= 232448
    assert rg.smem_bytes(128, rg.MAX_STAGES) <= 232448


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


def factored_chunk(r, k, v, lw, u, s):
    """One chunk of one (batch row, head) the way ``csrc/rwkv6.cu`` computes
    it, in fp32 numpy: n rows zero-padded to 16-row sub-chunks; le summed
    in row order; Rf_i = r_i exp(le_i - le_{B_I}) and Kf_j = k_j
    exp(le_{q_J} - le_j), with B_I the row before sub-chunk I (le 0 before
    the first) and q_J the last row of J; X[a][b] = exp(LB_a - LB_b) over
    the boundaries LB (the last is the chunk's last row); off-diagonal
    score blocks Rf_I (Kf_J X[I][J+1])^T, diagonal blocks by running
    products of the steps' decays; o = A v + (Rf X[I][0]) S and S' =
    X[ns][0] S + sum_J (Kf_J X[ns][J+1])^T v_J. Returns (o, S', every
    exponent it formed)."""
    n, dk = r.shape
    np_ = -(-n // 16) * 16
    ns = np_ // 16

    def pad(a):
        return np.concatenate([a, np.zeros((np_ - n, dk), np.float32)])

    r, k, v, lw = (pad(a).astype(np.float32) for a in (r, k, v, lw))
    le = np.zeros_like(lw)
    acc = np.zeros(dk, np.float32)
    for i in range(np_):
        acc = acc + lw[i]
        le[i] = acc
    lb = np.stack([np.zeros(dk, np.float32)]
                  + [le[16 * a - 1] for a in range(1, ns + 1)])
    exps = []

    def ex(z):
        exps.append(z)
        return np.exp(z).astype(np.float32)

    x = {(a, b): ex(lb[a] - lb[b]) for a in range(ns + 1) for b in range(a)}
    one = np.ones(dk, np.float32)
    xv = lambda a, b: one if a == b else x[a, b]
    sub = np.arange(np_) // 16
    rf = r * ex(le - lb[sub])
    kf = k * ex(lb[sub + 1] - le)
    w = ex(le[1:] - le[:-1])                    # w[i - 1]: row i's step
    amat = np.zeros((np_, np_), np.float32)
    for bi in range(ns):
        for bj in range(bi):
            rows, cols = slice(16 * bi, 16 * bi + 16), slice(16 * bj,
                                                             16 * bj + 16)
            amat[rows, cols] = rf[rows] @ (kf[cols] * xv(bi, bj + 1)).T
        for jl in range(16):
            j = 16 * bi + jl
            amat[j, j] = np.sum(r[j] * u * k[j])
            kd = k[j].copy()
            for i in range(j + 1, 16 * bi + 16):
                kd = kd * w[i - 1]
                amat[i, j] = np.sum(r[i] * kd)
    o = amat @ v + (rf * np.stack([xv(b, 0) for b in sub])) @ s
    ks = kf * np.stack([xv(ns, b + 1) for b in sub])
    s_new = xv(ns, 0)[:, None] * s + ks.T @ v
    return o[:n], s_new, np.concatenate([np.ravel(e) for e in exps])


@pytest.mark.parametrize("n", [17, 32, 64])
@pytest.mark.parametrize("lw", [-54.6, -8.0, -3.4e-4, None])
def test_rwkv6_subchunk_factoring_vs_sequential_oracle(n, lw):
    """The kernel's 16-row factoring of one chunk against ``repro``'s
    sequential ``rwkv_ref`` (fp32 tolerance 2e-4): finite at the model's
    decay floor (-e^4) and ceiling (-e^-8), and every exponent it forms is
    <= 0 (a wrong reference row B_I or q_J makes some positive)."""
    from repro.models.recurrent import rwkv_ref
    r, k, v, lwa, u, s0 = rwkv_case(n + 7, 1, n, 1, 32, lw, s0=True)
    if lw is None:      # the model's range: -exp(clip(., -8, 4))
        rng = np.random.default_rng(n)
        lwa = -np.exp(np.clip(2 * rng.standard_normal(lwa.shape), -8, 4)
                      ).astype(np.float32)
    o, s, exps = factored_chunk(r[0, :, 0], k[0, :, 0], v[0, :, 0],
                                lwa[0, :, 0], u[0], s0[0, 0])
    assert np.all(exps <= 0)
    assert np.isfinite(o).all() and np.isfinite(s).all()
    jo, js = rwkv_ref(*(jnp.asarray(a) for a in (r, k, v, lwa, u, s0)))
    for got, want in ((o, as_np(jo)[0, :, 0]), (s, as_np(js)[0, 0])):
        np.testing.assert_allclose(got, want, rtol=2e-4,
                                   atol=2e-4 * max(1.0, np.abs(want).max()))
