"""The port's MoE (``repro_torch.models.moe``) and its grouped-matmul kernel
module (``repro_torch.kernels.moe_gmm``) against the JAX package's, on the
same numpy inputs made from a seed (CPU: the port takes the kernel's plain
version there, the JAX package its Pallas kernel in interpret mode or its
einsums). The CUDA kernel itself runs in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import moe as jmoe
from repro_torch.kernels import moe_gmm as mg
from repro_torch.kernels import ops
from repro_torch.models import moe as tmoe

# tests/test_kernels.py:23
TOL = {"float32": 2e-4, "bfloat16": 4e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BF16 = 4e-2


def pair(a, dtype="float32"):
    """One fp32 numpy array in both packages, with the same bits."""
    jd, td = DTYPES[dtype]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def as_np(t):
    return t.float().numpy() if torch.is_tensor(t) else \
        np.asarray(t.astype(jnp.float32))


def close(t, j, tol):
    j = as_np(j)
    assert tuple(t.shape) == j.shape
    np.testing.assert_allclose(as_np(t), j, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(j).max())))


# ---------------------------------------------------------------------------
# the grouped matmul: plain version and dispatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("e,c,d,f", [(4, 128, 256, 128), (2, 256, 128, 256),
                                     (8, 128, 128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_plain_vs_pallas(e, c, d, f, dtype):
    """tests/test_kernels.py:107-117's sweep, at that file's tolerance."""
    rng = np.random.default_rng(e * c + d + f)
    jx, tx = pair(rng.standard_normal((e, c, d)), dtype)
    jw, tw = pair(rng.standard_normal((e, d, f)), dtype)
    got = ops.moe_gmm(tx, tw)
    assert got.dtype == tx.dtype and tuple(got.shape) == (e, c, f)
    want = jops.moe_gmm(jx, jw, force="pallas_interpret")
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=TOL[dtype],
                               atol=TOL[dtype] * 8)


@pytest.mark.parametrize("e,c,d,f", [(2, 33, 31, 32), (1, 31, 33, 33),
                                     (2, 65, 64, 63)])
def test_moe_gmm_plain_edges_vs_pallas(e, c, d, f):
    """tests/test_kernels.py:157-165: one over and one under the blocks."""
    rng = np.random.default_rng(e + c + d + f)
    jx, tx = pair(rng.standard_normal((e, c, d)))
    jw, tw = pair(rng.standard_normal((e, d, f)))
    want = jops.moe_gmm(jx, jw, block_c=32, block_f=32, block_d=32,
                        force="pallas_interpret")
    np.testing.assert_allclose(as_np(mg.moe_gmm_ref(tx, tw)), as_np(want),
                               rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(as_np(mg.moe_gmm_ref(tx, tw)),
                               as_np(jref.moe_gmm_ref(jx, jw)), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gmm_broadcast_x_equals_materialized(dtype):
    """The dense path's x: one (T, D) activation viewed with expert stride
    0 gives the result of its E materialized copies, bit for bit."""
    rng = np.random.default_rng(3)
    _, x = pair(rng.standard_normal((12, 32)), dtype)
    jw, w = pair(rng.standard_normal((4, 32, 24)), dtype)
    view = x.expand(4, 12, 32)
    assert view.stride(0) == 0
    got = ops.moe_gmm(view, w)
    torch.testing.assert_close(got, ops.moe_gmm(view.contiguous(), w),
                               rtol=0, atol=0)
    want = jref.moe_gmm_ref(jnp.broadcast_to(jnp.asarray(x.float().numpy())
                                             .astype(DTYPES[dtype][0]),
                                             (4, 12, 32)), jw)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_moe_gmm_grid_is_eq3_b():
    # D is looped inside each CTA, so it is no grid axis (unlike Pallas)
    assert mg.grid_blocks(2, 33, 32) == 2 * 1 * 1
    assert mg.grid_blocks(2, 65, 63) == 2 * 2 * 1
    # granite-moe-1b-a400m at full width, prefill 4 x 128 and decode 4
    assert mg.grid_blocks(32, 512, 512) == 2048
    assert mg.grid_blocks(32, 512, 1024) == 4096
    assert mg.grid_blocks(32, 4, 512) == 256
    assert mg.grid_blocks(32, 4, 1024) == 512
    assert mg.grid_blocks(32, 161, 512) == 32 * 3 * 8


def test_moe_gmm_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never computes off the card; the dispatch takes
    the plain version on the CPU and counts no launch."""
    x = torch.zeros(2, 4, 8, dtype=torch.bfloat16)
    w = torch.zeros(2, 8, 16, dtype=torch.bfloat16)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        mg.moe_gmm(x, w)
    torch.testing.assert_close(ops.moe_gmm(x, w), mg.moe_gmm_ref(x, w),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.moe_gmm(x, w, force="plain"),
                               mg.moe_gmm_ref(x, w), rtol=0, atol=0)
    assert dict(ops.LAUNCHES) == before


# ---------------------------------------------------------------------------
# routing and the two strategies (tests/test_moe.py's setup: d 32, e 8)
# ---------------------------------------------------------------------------
def setup_moe(shared=False, d=32, e=8, f=64, seed=0):
    """``repro``'s own init (key ``seed``) in both packages, and a bf16
    (2, 16, d) activation from numpy."""
    import jax
    jp = jax.device_get(jmoe.init_moe(jax.random.PRNGKey(seed), d, e, f,
                                      shared, f))
    tp = {k: ({c: torch.from_numpy(np.array(v)) for c, v in t.items()}
              if isinstance(t, dict) else torch.from_numpy(np.array(t)))
          for k, t in jp.items()}
    jp = {k: ({c: jnp.asarray(v) for c, v in t.items()}
              if isinstance(t, dict) else jnp.asarray(t))
          for k, t in jp.items()}
    rng = np.random.default_rng(seed + 1)
    jx, tx = pair(rng.standard_normal((2, 16, d)), "bfloat16")
    return jp, tp, jx, tx


def test_init_moe_tree_matches_jax():
    import jax
    for shared in (False, True):
        jp = jmoe.init_moe(jax.random.PRNGKey(0), 32, 8, 64, shared, 48)
        tp = tmoe.init_moe(torch.Generator().manual_seed(0), 32, 8, 64,
                           shared, 48)
        jl = jax.tree_util.tree_leaves_with_path(jp)
        assert len(jl) == (7 if shared else 4)
        for path, leaf in jl:
            node = tp
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == leaf.shape, path
            assert node.dtype == torch.float32 and leaf.dtype == jnp.float32
    stacked = tmoe.init_moe(torch.Generator().manual_seed(0), 32, 8, 64,
                            False, 48, lead=(3,))
    assert tuple(stacked["experts"]["w_down"].shape) == (3, 8, 64, 32)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_route_matches_jax(k):
    jp, tp, jx, tx = setup_moe()
    jg, ji, jaux = jmoe.route(jp, jx, k)
    tg, ti, taux = tmoe.route(tp, tx, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tg.sum(-1).numpy(), 1.0, rtol=1e-5)
    for name in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   rtol=1e-5, atol=1e-5)


def test_route_ties_take_the_lower_index_first():
    """Equal router logits: jax.lax.top_k's order, lower expert first."""
    p = {"router": torch.zeros(4, 6)}
    p["router"][:, 4] = 1.0
    x = torch.ones(3, 4, dtype=torch.bfloat16)
    _, ids, _ = tmoe.route(p, x, 3)
    assert ids.tolist() == [[4, 0, 1]] * 3
    jg, ji, _ = jmoe.route({"router": jnp.asarray(p["router"].numpy())},
                           jnp.ones((3, 4), jnp.bfloat16), 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))


@pytest.mark.parametrize("tokens,k,e,cf", [(32, 2, 8, 1.25), (512, 8, 32, 1.25),
                                           (4, 8, 32, 1.25), (32, 1, 8, 0.25),
                                           (3, 1, 128, 0.01)])
def test_capacity_matches_jax(tokens, k, e, cf):
    assert tmoe._capacity(tokens, k, e, cf) == \
        jmoe._capacity(tokens, k, e, cf)


def test_capacity_at_full_width():
    # granite-moe-1b-a400m: prefill 4 x 128 tokens, decode 4
    assert tmoe._capacity(512, 8, 32, 1.25) == 161
    assert tmoe._capacity(4, 8, 32, 1.25) == 2


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_apply_moe_dense_matches_jax(shared, k):
    jp, tp, jx, tx = setup_moe(shared=shared)
    jy, _ = jmoe.apply_moe_dense(jp, jx, k)
    ty, _ = tmoe.apply_moe_dense(tp, tx, k)
    assert ty.dtype == torch.bfloat16
    close(ty, jy, BF16)


@pytest.mark.parametrize("cf", [8.0, 1.25, 0.25])
@pytest.mark.parametrize("k,shared", [(1, False), (2, False), (2, True)])
def test_apply_moe_capacity_matches_jax(cf, k, shared):
    """The same tokens dropped (a token whose every slot was dropped comes
    out exactly zero without a shared expert), and values within the bf16
    tolerance."""
    jp, tp, jx, tx = setup_moe(shared=shared)
    jy, _ = jmoe.apply_moe_capacity(jp, jx, k, capacity_factor=cf)
    ty, _ = tmoe.apply_moe_capacity(tp, tx, k, cf)
    assert ty.dtype == torch.bfloat16
    close(ty, jy, BF16)
    if not shared:
        jzero = (np.asarray(jy.astype(jnp.float32)) == 0).all(-1)
        np.testing.assert_array_equal((ty == 0).all(-1).numpy(), jzero)
        if cf in (8.0, 0.25):     # no drops at 8.0; at 0.25 whole tokens
            assert jzero.any() == (cf == 0.25)
    if cf == 8.0:       # no drops: the dense strategy's function
        close(ty, tmoe.apply_moe_dense(tp, tx, k)[0], 6e-2)


def test_apply_moe_strategies():
    _, tp, _, tx = setup_moe()
    dense = tmoe.apply_moe_dense(tp, tx, 2)[0]
    for strategy in ("auto", "dense"):
        torch.testing.assert_close(
            tmoe.apply_moe(tp, tx, 2, 1.25, strategy)[0], dense, rtol=0,
            atol=0)
    torch.testing.assert_close(
        tmoe.apply_moe(tp, tx, 2, 0.25, "capacity")[0],
        tmoe.apply_moe_capacity(tp, tx, 2, 0.25)[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="strategy"):
        tmoe.apply_moe(tp, tx, 2, 1.25, "sparse")
    with pytest.raises(NotImplementedError, match="parallel"):
        tmoe.apply_moe_capacity(tp, tx, 2, 1.25, mesh=object())


def test_moe_products_go_through_the_dispatch(monkeypatch):
    """Each strategy runs its three expert products as ``ops.moe_gmm``
    calls: the dense one on the activations broadcast to every expert
    (expert stride 0, no copy), the capacity one on the (E, cap, D)
    buffer."""
    _, tp, _, tx = setup_moe()
    seen = []
    real = ops.moe_gmm

    def spy(x, w, **kw):
        seen.append((tuple(x.shape), x.stride(0), tuple(w.shape)))
        return real(x, w, **kw)
    monkeypatch.setattr(ops, "moe_gmm", spy)
    tmoe.apply_moe_dense(tp, tx, 2)
    assert seen == [((8, 32, 32), 0, (8, 32, 64)),
                    ((8, 32, 32), 0, (8, 32, 64)),
                    ((8, 32, 64), 32 * 64, (8, 64, 32))]
    seen.clear()
    cap = tmoe._capacity(32, 2, 8, 1.25)
    tmoe.apply_moe_capacity(tp, tx, 2, 1.25)
    assert [s[0] for s in seen] == [(8, cap, 32), (8, cap, 32),
                                    (8, cap, 64)]
