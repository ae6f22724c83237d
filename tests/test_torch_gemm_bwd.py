"""The GEMM backward's host side on the CPU: how the kernel reads each
operand where it lies (``matmul_tiled.operand_layout``), the backward's
tiles and grids at the training shapes (``bwd_tile``, ``bwd_grid_blocks``),
and that ``matmul_bwd`` and ``moe_gmm_bwd`` hand the kernel the views W^T
and X^T, never transposed copies. The kernels themselves run in
tests/test_torch_cuda.py on the card (``test_gemm_bwd_*``)."""

import pytest
import torch

from repro_torch.kernels import autotune
from repro_torch.kernels import matmul_tiled as mt
from repro_torch.kernels import moe_gmm as mg
from test_torch_recurrent import one_torch_thread  # noqa: F401 — autouse


def layout(x, w):
    return mt.operand_layout(x.shape, x.stride(), w.shape, w.stride())


def test_operand_layout_of_contiguous_operands():
    """The forward's operands: x K-major, w MN-major, their row strides."""
    x, w = torch.zeros(48, 80), torch.zeros(80, 24)
    assert layout(x, w) == (False, False, 80, 24)
    x3, w3 = torch.zeros(3, 48, 80), torch.zeros(3, 80, 24)
    assert layout(x3, w3) == (False, False, 80, 24)


@pytest.mark.parametrize("m,k,n", [(1024, 1024, 2816), (1024, 2816, 1024),
                                   (300, 130, 72), (48, 256, 200)])
def test_operand_layout_of_the_matmul_backward_views(m, k, n):
    """dX = dY W^T reads W (k, n) as a K-major w with N stride n; dW = X^T
    dY reads X (m, k) as an MN-major x with K stride k."""
    x, w, dy = torch.zeros(m, k), torch.zeros(k, n), torch.zeros(m, n)
    assert layout(dy, w.t()) == (False, True, n, n)
    assert layout(x.t(), dy) == (True, False, k, n)
    assert layout(dy[None], w.t()[None]) == (False, True, n, n)


@pytest.mark.parametrize("e,c,d,f,broadcast", [(32, 1024, 1024, 512, True),
                                               (32, 1024, 512, 1024, False),
                                               (3, 33, 31, 40, True)])
def test_operand_layout_of_the_grouped_backward_views(e, c, d, f, broadcast):
    """w.transpose(1, 2) is K-major with F stride f; x.transpose(1, 2) is
    MN-major with D stride d, a broadcast x's with expert stride 0."""
    x = torch.zeros(c, d).expand(e, c, d) if broadcast \
        else torch.zeros(e, c, d)
    w, dy = torch.zeros(e, d, f), torch.zeros(e, c, f)
    assert layout(dy, w.transpose(1, 2)) == (False, True, f, f)
    xt = x.transpose(1, 2)
    assert layout(xt, dy) == (True, False, d, f)
    assert xt.stride(0) == (0 if broadcast else c * d)


def test_operand_layout_dimensions_of_size_one():
    """A dimension of size 1 takes any stride: today's form is kept where
    it reads the operand."""
    x = torch.zeros(5, 1).t()                       # (1, 5), strides (1, 1)
    assert layout(x, torch.zeros(5, 7)) == (False, False, 5, 7)
    w = torch.zeros(7, 1).t()                       # (1, 7) w, K = 1
    assert layout(torch.zeros(4, 1), w) == (False, False, 1, 7)
    wt = torch.zeros(1, 6).t()                      # (6, 1) w, N = 1
    assert layout(torch.zeros(4, 6), wt)[:2] == (False, False)


def test_operand_layout_refusals():
    """No unit stride, or both operands transposed, or shapes that do not
    multiply: a ValueError, never a copy."""
    with pytest.raises(ValueError, match="neither its M nor its K"):
        layout(torch.zeros(8, 32)[:, ::2], torch.zeros(16, 4))
    with pytest.raises(ValueError, match="neither its K nor its N"):
        layout(torch.zeros(8, 16), torch.zeros(16, 8)[:, ::2])
    with pytest.raises(ValueError, match="not both"):
        layout(torch.zeros(16, 8).t(), torch.zeros(4, 16).t())
    with pytest.raises(ValueError, match="do not multiply"):
        layout(torch.zeros(8, 16), torch.zeros(15, 4))


# (E, M, N, K) of each backward product at the training shapes, with its
# tile and CTAs on 132 SMs: qwen1.5-0.5b at 8 x 128 tokens (up/gate: dX
# then dW, down: dX then dW) and granite-moe-1b-a400m's 32 experts at 1024
# tokens (gate/up, down)
TRAINING_PRODUCTS = [
    ((1, 1024, 1024, 2816), (128, 64), 128),
    ((1, 1024, 2816, 1024), (192, 128), 132),
    ((1, 1024, 2816, 1024), (192, 128), 132),
    ((1, 2816, 1024, 1024), (192, 128), 120),
    ((32, 1024, 1024, 512), (256, 128), 1024),
    ((32, 1024, 512, 1024), (256, 128), 512),
    ((32, 1024, 512, 1024), (256, 128), 512),
    ((32, 512, 1024, 1024), (256, 128), 512),
]


@pytest.mark.parametrize("shape,tile,ctas", TRAINING_PRODUCTS)
def test_bwd_tile_and_grid_at_the_training_shapes(shape, tile, ctas):
    """Each product's tile by paper Eq. 3 over the H100 SXM's 132 SMs (the
    default card) and its grid; the K ranges it sums, in order, are the
    forward's schedule's."""
    e, m, n, k = shape
    assert mt.bwd_tile(e, m, n) == tile == mt.bwd_tile(e, m, n, sms=132)
    assert mt.bwd_grid_blocks(e, m, n, k) == ctas
    assert mt.bwd_grid_blocks(e, m, n, k, tile) == ctas
    assert mt.schedule(m, n, k) == ("prefill", [(0, k)])


def test_bwd_tile_decode_form_and_refusals():
    """At M <= 64 the decode tile, its K chunks in the forward's order;
    a tile the backward does not have raises."""
    assert mt.bwd_tile(1, 48, 200) == mt.DECODE_TILE
    assert mt.bwd_grid_blocks(1, 48, 200, 256) == 4
    assert mt.schedule(48, 200, 600) == ("decode", [(0, 256), (256, 512),
                                                    (512, 600)])
    assert mt.bwd_grid_blocks(3, 33, 40, 31) == 3
    with pytest.raises(ValueError, match="one tile"):
        mt.bwd_tile(1, 48, 200, (128, 64))
    with pytest.raises(ValueError, match="no backward tile"):
        mt.bwd_tile(1, 512, 200, (256, 64))


def test_bwd_tiles_stay_out_of_the_forward():
    """The backward's tiles past (128, 64) are neither prefill tiles nor
    the autotuner's candidates; each is one CTA an SM, with a rate."""
    assert set(mt.BWD_TILES) - {mt.DEFAULT_TILE} == \
        set(mt.BWD_TILES) - set(mt.PREFILL_TILES)
    assert set(autotune._gemm_tiles(1024)) == set(mt.PREFILL_TILES)
    assert set(mt.BWD_TILE_RATE) == set(mt.BWD_TILES)
    for t in mt.BWD_TILES:
        f = mt.bwd_form(t, device="cpu")
        assert f["ctas_per_sm"] == 1
        assert f["threads"] == 128 * (1 + t[1] // 64)
        assert f["smem_bytes"] > 227 * 1024 // 2
    assert mg.bwd_form(mt.DECODE_TILE, device="cpu") == \
        mt.FORMS[("decode", mt.DECODE_TILE)]


def test_launch_bwd_refuses_cpu_tensors():
    """No fallback: the backward's launcher takes CUDA tensors only."""
    with pytest.raises(ValueError, match="CUDA"):
        mt.launch_bwd(mt.NAME, None,
                      torch.zeros(1, 4, 8, dtype=torch.bfloat16),
                      torch.zeros(1, 8, 4, dtype=torch.bfloat16), mt.NAME_BWD)


@pytest.fixture
def recorded(monkeypatch):
    """``launch_bwd`` replaced by a recorder of what each wrapper hands it:
    (x, w, count), answered with the plain product."""
    calls = []

    def fake(name, bind, x, w, count, tile=None):
        calls.append((name, x, w, count))
        return (x.float() @ w.float()).to(x.dtype)
    monkeypatch.setattr(mt, "launch_bwd", fake)
    monkeypatch.setattr(mg, "launch_bwd", fake)
    return calls


def test_matmul_bwd_hands_the_kernel_views(recorded):
    """Two products, each of views of the inputs themselves (no copy), in
    the layouts the kernel reads; the results are the plain backward's."""
    g = torch.Generator().manual_seed(0)
    x, w, dy = (torch.randn(*s, generator=g).bfloat16()
                for s in ((40, 24), (24, 56), (40, 56)))
    dx, dw = mt.matmul_bwd(x, w, dy)
    assert [(c[0], c[3]) for c in recorded] == [(mt.NAME, mt.NAME_BWD)] * 2
    (_, a0, b0, _), (_, a1, b1, _) = recorded
    assert a0.data_ptr() == dy.data_ptr() and b0.data_ptr() == w.data_ptr()
    assert a1.data_ptr() == x.data_ptr() and b1.data_ptr() == dy.data_ptr()
    assert layout(a0, b0)[:2] == (False, True)
    assert layout(a1, b1)[:2] == (True, False)
    for got, want in zip((dx, dw), mt.matmul_bwd_ref(x, w, dy)):
        assert torch.equal(got, want)
    recorded.clear()
    assert mt.matmul_bwd(x, w, dy, (False, True))[0] is None
    assert len(recorded) == 1


@pytest.mark.parametrize("broadcast", [False, True])
def test_moe_gmm_bwd_hands_the_kernel_views(recorded, broadcast):
    """As the matmul's: W^T and X^T are views of w and x (a broadcast x's
    with its expert stride 0), each product one launch."""
    g = torch.Generator().manual_seed(1)
    e, c, d, f = 3, 20, 16, 24
    xb = torch.randn(c, d, generator=g).bfloat16() if broadcast \
        else torch.randn(e, c, d, generator=g).bfloat16()
    x = xb.expand(e, c, d) if broadcast else xb
    w = torch.randn(e, d, f, generator=g).bfloat16()
    dy = torch.randn(e, c, f, generator=g).bfloat16()
    dx, dw = mg.moe_gmm_bwd(x, w, dy)
    assert [(c_[0], c_[3]) for c_ in recorded] == [(mg.NAME, mg.NAME_BWD)] * 2
    (_, a0, b0, _), (_, a1, b1, _) = recorded
    assert b0.data_ptr() == w.data_ptr() and a1.data_ptr() == xb.data_ptr()
    assert layout(a0, b0)[:2] == (False, True)
    assert layout(a1, b1)[:2] == (True, False)
    assert a1.stride(0) == (0 if broadcast else c * d)
    for got, want in zip((dx, dw), mg.moe_gmm_bwd_ref(x, w, dy)):
        assert torch.equal(got, want)
