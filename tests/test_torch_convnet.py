"""The port's convnet (``repro_torch.models.convnet``) against the JAX
package's, on the CPU: the reference's own init (``init_convnet`` at
``PRNGKey(0)``) carried across by ``params_from_jax`` and the same
numpy-seeded inputs. The port's conv is an im2col product (``torch.matmul``
in fp32; ``ops.matmul``, here its plain version, in bf16); the reference's
is XLA's conv.

Tolerances: logits and activations within 2e-4 (relative to the largest
value, at least 1) in fp32 and 4e-2 of the largest logit with bf16 input
(tests/test_kernels.py:23's pair); the loss and its gradient within 2e-4;
three SGD steps within 1e-5 (each step moves a parameter by lr x its
gradient, lr 3e-3, so the gradients' 2e-4 becomes at most 6e-7 a step);
the pruned net, the data, the layer shapes and the counts exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import pruning_opt as jpo
from repro.core.tail_model import LayerShape as JLayerShape
from repro.models import convnet as jcn
from repro_torch.core import H100_SXM
from repro_torch.core.tail_model import CtaWaveModel
from repro_torch.interop import params_from_jax
from repro_torch.kernels import matmul_tiled as mt
from repro_torch.launch import pruning_opt as po
from repro_torch.models import convnet as cn

from test_torch_recurrent import one_torch_thread  # noqa: F401

SMALL = (8, 12, 16, 20)


@functools.lru_cache(maxsize=None)
def _ref_init(widths, image):
    init = jax.jit(jcn.init_convnet, static_argnums=(1,),
                   static_argnames=("image",))
    return jax.device_get(init(jax.random.PRNGKey(0), widths, image=image))


def ref_params(widths=SMALL, image=8):
    """The reference's ``init_convnet`` at ``PRNGKey(0)`` (jitted: an eager
    ``jax.random.normal`` compiles for seconds per shape on the CPU)."""
    return _ref_init(tuple(widths), image)


def np_params(widths, image, seed=0):
    """Params in the reference's layout from a numpy seed, with non-zero
    biases, for the shapes other than ``SMALL``'s."""
    rng = np.random.default_rng(seed)
    out, cin = {}, 3
    for i, w in enumerate(widths):
        out[f"conv{i}"] = {
            "kernel": (rng.standard_normal((3, 3, cin, w))
                       / np.sqrt(9 * cin)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(w)).astype(np.float32)}
        cin = w
    feat = image // 2 ** (len(widths) // 2)
    out["head"] = {
        "w": (rng.standard_normal((feat * feat * cin, 10))
              / np.sqrt(feat * feat * cin)).astype(np.float32),
        "b": (0.1 * rng.standard_normal(10)).astype(np.float32)}
    return out


def images(batch=2, image=8, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (batch, image, image, 3)).astype(np.float32)


def close(got, want, tol):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def test_init_layout_and_scale():
    """The reference's keys and shapes; each kernel's std about
    1/sqrt(fan in), biases zero."""
    ref = jax.eval_shape(lambda: jcn.init_convnet(
        jax.random.PRNGKey(0), (32, 48, 64, 80), image=16))
    got = cn.init_convnet(torch.Generator().manual_seed(0), (32, 48, 64, 80),
                          image=16)
    assert set(got) == set(ref)
    for name in ref:
        for leaf in ref[name]:
            assert tuple(got[name][leaf].shape) == ref[name][leaf].shape
            assert got[name][leaf].dtype == torch.float32
    cin = 3
    for i, w in enumerate((32, 48, 64, 80)):
        std = float(got[f"conv{i}"]["kernel"].std())
        assert abs(std * np.sqrt(9 * cin) - 1.0) < 0.1
        assert not got[f"conv{i}"]["bias"].any()
        cin = w
    assert cn.conv_names() == jcn.conv_names()
    assert cn.DEFAULT_WIDTHS == jcn.DEFAULT_WIDTHS


@pytest.mark.parametrize("widths,image,batch", [
    (SMALL, 8, 2), ((5, 7, 9, 11, 6), 10, 3), ((16, 8), 6, 1)])
def test_forward_fp32(widths, image, batch):
    """Logits and every collected activation; image 10 pools an odd map
    (5 -> 2, VALID), five layers end on an unpooled conv."""
    host = ref_params() if widths == SMALL else np_params(widths, image)
    x = images(batch, image)
    want, wacts = jcn.forward_convnet(host, jnp.asarray(x), collect_acts=True)
    got, acts = cn.forward_convnet(params_from_jax(host), torch.from_numpy(x),
                                   collect_acts=True)
    assert got.dtype == torch.float32
    close(got, want, 2e-4)
    assert set(acts) == set(wacts)
    for name in wacts:
        close(acts[name], wacts[name], 2e-4)


@pytest.mark.parametrize("widths", [SMALL, (5, 7, 9, 11)])
def test_forward_bf16(widths):
    """bf16 input: the conv products on ``ops.matmul`` (its plain version
    here), K and N zero-padded to multiples of 8."""
    host = ref_params() if widths == SMALL else np_params(widths, 8)
    x = images(2, 8, seed=1)
    want, _ = jcn.forward_convnet(host, jnp.asarray(x).astype(jnp.bfloat16))
    got, _ = cn.forward_convnet(params_from_jax(host),
                                torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    close(got, want, 4e-2)
    # the prepared operands give the same forward
    ops_ = cn.conv_operands(params_from_jax(host), torch.bfloat16)
    again, _ = cn.forward_convnet(params_from_jax(host),
                                  torch.from_numpy(x).bfloat16(),
                                  operands=ops_)
    assert torch.equal(again, got)


@pytest.mark.parametrize("cin,cout", [(3, 84), (84, 127), (127, 211),
                                      (16, 16)])
def test_kernel_route_padded_product_equals_unpadded(cin, cout):
    """The kernel route's product on K and N padded to multiples of 8,
    sliced back, equals the plain product of the unpadded operands up to
    the order of the fp32 sum: two fp32 sums over K in another blocking
    (which torch's thread count picks) need not be bit-equal. The fp32
    products before the cast agree within K x 2^-24 x sum|a||b| per
    element (the bound of any two summation orders), and each bf16 output
    lies within one bf16 step (2^-7 of its binade) of the unpadded one, the
    most that one rounding of two such fp32 values can part them. A
    padding or slicing fault moves an output by O(1) of its taps and fails
    both."""
    rng = np.random.default_rng(cin * cout)
    x = torch.from_numpy(rng.standard_normal((2, 6, 6, cin)).astype(
        np.float32)).bfloat16()
    kern = torch.from_numpy(rng.standard_normal((3, 3, cin, cout)).astype(
        np.float32))
    wm = cn.conv_operand(kern, torch.bfloat16)
    assert wm.shape[0] % 8 == 0 and wm.shape[1] % 8 == 0
    assert wm.shape[0] - 9 * cin < 8 and wm.shape[1] - cout < 8
    loads = []
    got = cn.conv3x3(x, kern, loads=loads).reshape(-1, cout).float()
    a = cn.im2col(x).float()
    b = kern.reshape(9 * cin, cout).bfloat16().float()
    want = (a @ b).bfloat16().float()
    padded = (cn.im2col(x, wm.shape[0]).float() @ wm.float())[:, :cout]
    k = wm.shape[0]
    assert torch.all((padded - a @ b).abs()
                     <= k * 2.0 ** -24 * (a.abs() @ b.abs()))
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    assert torch.all((got - want).abs() <= torch.ldexp(
        torch.ones_like(got), e - 8))
    assert loads == [None]


def test_kernel_route_refuses_grad():
    """A ctypes launch has no gradient: the bf16 route raises rather than
    detach; under no_grad it runs."""
    x = torch.randn(1, 4, 4, 3, dtype=torch.bfloat16)
    kern = torch.randn(3, 3, 3, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        cn.conv3x3(x, kern)
    with pytest.raises(RuntimeError, match="no gradient"):
        cn.conv3x3(x.requires_grad_(True), kern.detach())
    with torch.no_grad():
        assert cn.conv3x3(x, kern).shape == (1, 4, 4, 8)
    # the fp32 route trains
    y = cn.conv3x3(torch.randn(1, 4, 4, 3), kern)
    y.sum().backward()
    assert kern.grad is not None


@pytest.mark.parametrize("batch,image", [(1, 16), (32, 16), (64, 32)])
@pytest.mark.parametrize("widths", [(128, 192, 320, 448),
                                    (84, 127, 211, 296),
                                    (84, 127, 128, 256),
                                    (64, 64, 211, 296),
                                    (64, 64, 192, 256)])
def test_padded_grid_is_the_models_b(batch, image, widths):
    """Each conv product's grid on the padded K and N
    (``matmul_tiled.grid_blocks``) is the B that ``CtaWaveModel`` prices
    for the layer, and padding keeps the decode form's K chunks."""
    model = CtaWaveModel(H100_SXM)
    cin = 3
    for s, w in zip(cn.conv_layer_shapes(widths, batch=batch, image=image),
                    widths):
        kp, np_ = -(-9 * cin // 8) * 8, -(-w // 8) * 8
        assert mt.grid_blocks(s.tokens, np_, kp) == model.blocks(s)
        assert mt.kernel_form(s.tokens, kp) == mt.kernel_form(s.tokens,
                                                              9 * cin)
        cin = w


def test_prune_convnet_exact():
    host = ref_params()
    rng = np.random.default_rng(3)
    idx = {f"conv{i}": np.sort(rng.choice(w, size=w // 2 + 1, replace=False))
           for i, w in enumerate(SMALL)}
    for indices in (idx, {k: v for k, v in idx.items() if k != "conv3"},
                    {"conv1": idx["conv1"]}):
        want = jax.device_get(jcn.prune_convnet(host, indices))
        got = cn.prune_convnet(params_from_jax(host), indices)
        assert set(got) == set(want)
        for name in want:
            for leaf in want[name]:
                np.testing.assert_array_equal(got[name][leaf].numpy(),
                                              np.asarray(want[name][leaf]))


@pytest.mark.parametrize("step,batch,image,seed", [
    (0, 4, 8, 0), (5, 3, 16, 0), (77, 2, 32, 1), (10_003, 5, 6, 0)])
def test_synthetic_cifar_bit_equal(step, batch, image, seed):
    want = jcn.synthetic_cifar(step, batch, image, seed=seed)
    got = cn.synthetic_cifar(step, batch, image, seed=seed)
    np.testing.assert_array_equal(got["images"].numpy(),
                                  np.asarray(want["images"]))
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    assert got["labels"].dtype == torch.int32


@pytest.mark.parametrize("widths", [(128, 192, 320, 448), (84, 127, 211, 296),
                                    (5, 7, 9), (64,)])
@pytest.mark.parametrize("batch,image", [(1, 16), (32, 16), (64, 32),
                                         (2, 10)])
def test_shapes_and_counts_exact(widths, batch, image):
    got = cn.conv_layer_shapes(widths, batch=batch, image=image, shard=2)
    want = jcn.conv_layer_shapes(widths, batch=batch, image=image, shard=2)
    assert [(s.name, s.tokens, s.d_in, s.width, s.shard_out) for s in got] \
        == [(s.name, s.tokens, s.d_in, s.width, s.shard_out) for s in want]
    assert isinstance(want[0], JLayerShape)
    assert cn.count_conv_params(widths, image=image) == \
        jcn.count_conv_params(widths, image=image)
    assert cn.count_conv_flops(widths, batch=batch, image=image) == \
        jcn.count_conv_flops(widths, batch=batch, image=image)


def test_loss_and_gradient():
    host = ref_params()
    batch = jcn.synthetic_cifar(3, 4, 8)
    (wl, wa), wg = jax.jit(jax.value_and_grad(jcn.convnet_loss,
                                              has_aux=True))(host, batch)
    params = {k: {kk: t.requires_grad_(True) for kk, t in v.items()}
              for k, v in params_from_jax(host).items()}
    loss, acc = cn.convnet_loss(params, cn.synthetic_cifar(3, 4, 8))
    loss.backward()
    assert abs(loss.item() - float(wl)) <= 2e-4 * max(1.0, abs(float(wl)))
    assert acc.item() == float(wa)
    for name in wg:
        for leaf in wg[name]:
            close(params[name][leaf].grad, wg[name][leaf], 2e-4)


def test_sgd_steps_match_reference():
    """Three steps of the port's ``train`` against ``repro``'s (batch 32,
    image 16)."""
    host = np_params(SMALL, 16, seed=1)
    want, wacc = jpo.train(jax.tree.map(jnp.asarray, host), 3)
    got, acc = po.train(params_from_jax(host), 3)
    assert acc == wacc
    want = jax.device_get(want)
    for name in want:
        for leaf in want[name]:
            np.testing.assert_allclose(got[name][leaf].numpy(),
                                       np.asarray(want[name][leaf]),
                                       rtol=0, atol=1e-5)
