"""The rest of the public layers, ops and utils of the port against the JAX
package (CPU, f32): the CBAM family, ``Normalize`` and ``PadToMultipleOf``,
the adaptive pools, ``edges``, ``gaussian_blur``, the four losses on
probabilities, class maps and images, ``polygon_iou``, ``f_score``,
``random_pad`` and the dotted-attribute helpers.

Tolerances: modules and filters of convs and means agree to 1e-5 (f32
summation order), their gradients to relative L2 1e-4; losses to relative
1e-5; polygon IoUs to 1e-5 absolute; the host helpers exactly.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from sihl_tpu.layers import CBAM as JaxCBAM
from sihl_tpu.layers import ChannelAttention as JaxChannelAttention
from sihl_tpu.layers import CrossCBAM as JaxCrossCBAM
from sihl_tpu.layers import Normalize as JaxNormalize
from sihl_tpu.layers import PadToMultipleOf as JaxPadToMultipleOf
from sihl_tpu.layers import SpatialAttention as JaxSpatialAttention
from sihl_tpu.ops import image as jax_image
from sihl_tpu.ops import losses as jax_losses
from sihl_tpu.utils import f_score as jax_f_score
from sihl_tpu.utils import random_pad as jax_random_pad
from sihl_tpu.utils.polygon_iou import polygon_area as jax_polygon_area
from sihl_tpu.utils.polygon_iou import polygon_iou as jax_polygon_iou
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.layers import CBAM, ChannelAttention, CrossCBAM, Normalize, PadToMultipleOf, SpatialAttention
from sihl_tpu_torch.ops import (adaptive_avg_pool, adaptive_max_pool, binary_cross_entropy, edges, focal_loss,
                                gaussian_blur, ssim_loss, tversky_loss)
from sihl_tpu_torch.utils import (f_score, polygon_area, polygon_iou, random_pad, recursive_getattr,
                                  recursive_setattr)

from test_torch_bifpn import _relative_error
from torch_parity import load_from_jax, to_numpy, to_torch

ATTENTION = {
    "spatial": (lambda: JaxSpatialAttention(rngs=nnx.Rngs(0)), lambda: SpatialAttention()),
    "channel": (lambda: JaxChannelAttention(32, rngs=nnx.Rngs(0)), lambda: ChannelAttention(32)),
    "cbam": (lambda: JaxCBAM(32, rngs=nnx.Rngs(0)), lambda: CBAM(32)),
    "cbam_applied": (lambda: JaxCBAM(32, 5, applied=True, rngs=nnx.Rngs(0)), lambda: CBAM(32, 5, applied=True)),
    "cross_cbam": (lambda: JaxCrossCBAM(32, rngs=nnx.Rngs(0)), lambda: CrossCBAM(32)),
}


@pytest.mark.parametrize("kind", list(ATTENTION))
def test_attention_outputs_and_gradients_match_jax(kind):
    """Outputs within 1e-5; gradients of sum(output * cotangent) for every
    parameter and input within relative L2 1e-4.  CBAM keeps the reference's
    ``kernel_size`` as ChannelAttention's ratio (32 // 7 = 4 hidden)."""
    make_jax, make = ATTENTION[kind]
    rng = np.random.RandomState(len(kind))
    jax_module = make_jax()
    for _, sub in nnx.iter_graph(jax_module):  # non-zero biases
        if isinstance(sub, nnx.Conv) and sub.bias is not None:
            sub.bias[...] = jnp.asarray(rng.uniform(-0.5, 0.5, sub.bias[...].shape), jnp.float32)
    module = load_from_jax(make(), jax_module)
    n_in = 2 if kind == "cross_cbam" else 1
    xs = [rng.randn(2, 12, 16, 32).astype(np.float32) for _ in range(n_in)]
    out_channels = 1 if kind == "spatial" else 32
    out_hw = (1, 1) if kind == "channel" else (12, 16)
    cot = rng.randn(2, *out_hw, out_channels).astype(np.float32)
    if kind.startswith("cbam"):
        assert module.channel_attention.conv1.weight.shape[0] == 32 // (5 if kind == "cbam_applied" else 7)

    def loss(m, inputs):
        out = m(*inputs)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, want), (want_params, want_in) = nnx.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jax_module, [jnp.asarray(x) for x in xs])
    inputs = [to_torch(x).requires_grad_(True) for x in xs]
    got = module(*inputs)
    (got * to_torch(cot)).sum().backward()
    np.testing.assert_allclose(to_numpy(got, nhwc=True), np.asarray(want), rtol=1e-5, atol=1e-5)
    want_grads = state_dict_from_flat({".".join(map(str, p)): np.asarray(v[...])
                                       for p, v in nnx.to_flat_state(want_params)})
    for name, p in module.named_parameters():
        assert _relative_error(p.grad.numpy(), want_grads[name].numpy()) <= 1e-4, name
    for x, w in zip(inputs, want_in):
        assert _relative_error(to_numpy(x.grad, nhwc=True), w) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_normalize_matches_jax(dtype):
    """In the input's dtype, as JAX casts its constants to it; no state."""
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    x = np.random.RandomState(0).rand(2, 8, 8, 3).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(JaxNormalize(mean, std)(jnp.asarray(x, jdt)), np.float32)
    module = Normalize(mean, std, device="cpu")
    got = module(to_torch(x).to(dtype))
    assert got.dtype == dtype and module.state_dict() == {}
    np.testing.assert_array_equal(to_numpy(got, nhwc=True), want)


@pytest.mark.parametrize("hw, n", [((13, 10), 8), ((16, 16), 8), ((7, 9), 4)])
def test_pad_to_multiple_of_matches_jax(hw, n):
    """The odd pixel of the padding goes to the bottom and right."""
    x = np.random.RandomState(1).rand(2, *hw, 3).astype(np.float32)
    want = np.asarray(JaxPadToMultipleOf(n)(jnp.asarray(x)))
    got = to_numpy(PadToMultipleOf(n)(to_torch(x)), nhwc=True)
    assert got.shape[1] % n == 0 and got.shape[2] % n == 0
    np.testing.assert_array_equal(got, want)


IMAGE_OPS = {
    "avg_1": (lambda x: jax_image.adaptive_avg_pool(x, 1), lambda x: adaptive_avg_pool(x, 1)),
    "avg_4x2": (lambda x: jax_image.adaptive_avg_pool(x, (4, 2)), lambda x: adaptive_avg_pool(x, (4, 2))),
    "avg_5_shrink": (lambda x: jax_image.adaptive_avg_pool(x, 5), lambda x: adaptive_avg_pool(x, 5)),
    "avg_24x20_grow": (lambda x: jax_image.adaptive_avg_pool(x, (24, 20)),
                       lambda x: adaptive_avg_pool(x, (24, 20))),
    "max_1": (lambda x: jax_image.adaptive_max_pool(x, 1), lambda x: adaptive_max_pool(x, 1)),
    "max_4": (lambda x: jax_image.adaptive_max_pool(x, 4), lambda x: adaptive_max_pool(x, 4)),
    "edges": (jax_image.edges, edges),
    "gaussian_blur": (jax_image.gaussian_blur, gaussian_blur),
    "gaussian_blur_3_sigma_1": (lambda x: jax_image.gaussian_blur(x, 3, 1.0), lambda x: gaussian_blur(x, 3, 1.0)),
}


@pytest.mark.parametrize("op", list(IMAGE_OPS))
def test_image_ops_match_jax(op):
    """The non-divisible adaptive average pools take the linear resize (its
    antialiased form when shrinking 16 to 5); ``edges`` divides by the
    largest magnitude over the whole batch."""
    jax_op, port_op = IMAGE_OPS[op]
    x = np.random.RandomState(2).rand(2, 16, 16, 3).astype(np.float32)
    want = np.asarray(jax_op(jnp.asarray(x)))
    got = to_numpy(port_op(to_torch(x)), nhwc=True)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_adaptive_max_pool_refuses_sizes_that_do_not_divide():
    with pytest.raises(ValueError, match="divide"):
        adaptive_max_pool(torch.zeros(1, 1, 16, 16), 5)


def _loss_inputs(rng):
    probs = rng.uniform(0.0, 1.0, (2, 3, 8, 8)).astype(np.float32)
    probs[0, 0, 0, :2] = [0.0, 1.0]  # clipped to EPS and 1 - EPS
    targets = (rng.rand(2, 3, 8, 8) > 0.5).astype(np.float32)
    logits = rng.randn(2, 8, 8, 4).astype(np.float32)
    classes = rng.randint(0, 4, (2, 8, 8)).astype(np.int32)
    classes[0, :3] = -100
    classes[1, 5:, 5:] = 255
    images = [rng.rand(2, 12, 12, 3).astype(np.float32) for _ in range(2)]
    return probs, targets, logits, classes, images


LOSSES = {
    "bce": lambda m, p, t, l, c, im: m.binary_cross_entropy(p, t),
    "focal": lambda m, p, t, l, c, im: m.focal_loss(p, t),
    "focal_alpha_gamma": lambda m, p, t, l, c, im: m.focal_loss(p, t, alpha=0.6, gamma=1.5),
    "tversky": lambda m, p, t, l, c, im: m.tversky_loss(l, c),
    "tversky_void": lambda m, p, t, l, c, im: m.tversky_loss(l, c, alpha=0.3, beta=0.7, ignore_index=255),
    "ssim": lambda m, p, t, l, c, im: m.ssim_loss(*im),
    "ssim_sum": lambda m, p, t, l, c, im: m.ssim_loss(*im, window_size=5, size_average=False),
}


class _Port:
    """The port's losses behind the JAX module's names and layout: dense
    logits and images arrive NHWC and move to NCHW here."""

    binary_cross_entropy = staticmethod(lambda p, t: binary_cross_entropy(torch.from_numpy(p), torch.from_numpy(t)))
    focal_loss = staticmethod(lambda p, t, **kw: focal_loss(torch.from_numpy(p), torch.from_numpy(t), **kw))
    tversky_loss = staticmethod(lambda l, c, **kw: tversky_loss(to_torch(l), torch.from_numpy(c), **kw))
    ssim_loss = staticmethod(lambda a, b, **kw: ssim_loss(to_torch(a), to_torch(b), **kw))


@pytest.mark.parametrize("loss", list(LOSSES))
def test_losses_match_jax(loss):
    """In f32 as ``_f32`` computes them; the Tversky loss with ignored
    pixels (the default -100, and 255)."""
    inputs = _loss_inputs(np.random.RandomState(3))
    want = np.asarray(LOSSES[loss](jax_losses, *(jax.tree_util.tree_map(jnp.asarray, inputs))))
    got = LOSSES[loss](_Port, *inputs)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


def _quads():
    """Pairs of quadrilaterals: overlapping, equal, disjoint, a square and
    its 45-degree turn (an octagon of 8 = 4 + 4 vertices, the buffer's
    bound), one clockwise, and two touching at an edge."""
    square = np.array([[0, 0], [4, 0], [4, 4], [0, 4]], np.float32)
    turned = np.array([[2, -0.8], [4.8, 2], [2, 4.8], [-0.8, 2]], np.float32)
    skew = np.array([[1, 1], [6, 2], [5, 5], [2, 6]], np.float32)
    pairs = [
        (square, square + [2.0, 1.0]),
        (skew, skew),
        (square, square + [10.0, 0.0]),
        (square, turned),
        (skew[::-1], square),
        (square, square + [4.0, 0.0]),
    ]
    return np.stack([a for a, _ in pairs]).astype(np.float32), np.stack([b for _, b in pairs]).astype(np.float32)


def test_polygon_iou_matches_jax():
    """A batch of pairs in one call against JAX's function pair by pair; the
    equal pair has IoU 1, the disjoint and touching ones 0.

    The square and its turn intersect in an octagon whose 8 vertices fill
    the buffer to its bound.  There the JAX function's last clip writes the
    8th vertex to the slot that its non-emitting writes use as scratch, and
    a zero vertex can win (JAX reads 0.7758; ROADMAP.md, queue C).  The port
    keeps its scratch slot past the buffer, and is held to the exact IoU:
    the square (16) less four corner triangles of legs 1.2 (2.88) over the
    union 16 + 15.68 - 13.12."""
    p1, p2 = _quads()
    want = np.array([float(jax_polygon_iou(jnp.asarray(a), jnp.asarray(b))) for a, b in zip(p1, p2)])
    got = polygon_iou(torch.from_numpy(p1), torch.from_numpy(p2)).numpy()
    octagon = 3
    want[octagon] = 13.12 / 18.56
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got[[1, 2, 5]], [1.0, 0.0, 0.0], atol=1e-6)
    assert 0.2 < got[0] < 0.5
    for a, b, g in zip(p1, p2, got):  # one pair at a time
        assert float(polygon_iou(torch.from_numpy(a), torch.from_numpy(b))) == pytest.approx(float(g), abs=1e-7)


def test_polygon_area_matches_jax():
    """Whole buffers and padded ones with a count of valid vertices."""
    verts = np.random.RandomState(4).rand(3, 6, 2).astype(np.float32) * 5
    counts = np.array([3, 5, 6])
    for v, n in zip(verts, counts):
        assert float(polygon_area(torch.from_numpy(v))) == pytest.approx(float(jax_polygon_area(jnp.asarray(v))),
                                                                          rel=1e-6)
        want = float(jax_polygon_area(jnp.asarray(v), jnp.asarray(n)))
        assert float(polygon_area(torch.from_numpy(v), torch.tensor(n))) == pytest.approx(want, rel=1e-6)
    batched = polygon_area(torch.from_numpy(verts), torch.from_numpy(counts)).numpy()
    np.testing.assert_allclose(batched, [float(jax_polygon_area(jnp.asarray(v), n)) for v, n in zip(verts, counts)],
                               rtol=1e-6)


def test_f_score_matches_jax():
    for beta in (0.5, 1.0, 2.0):
        assert f_score(beta)(0.6, 0.3) == jax_f_score(beta)(0.6, 0.3)


@pytest.mark.parametrize("shape, target", [((20, 30, 3), 40), ((50, 30), (40, 36)), ((20, 30, 3), (20, 30))])
def test_random_pad_matches_jax(shape, target):
    """Under one ``random.seed`` both draw the same offsets; an image larger
    than the target shrinks by nearest-pixel sampling first."""
    image = np.random.RandomState(5).rand(*shape).astype(np.float32)
    random.seed(7)
    want = jax_random_pad(image, target, fill=0.5)
    random.seed(7)
    got = random_pad(image, target, fill=0.5)
    np.testing.assert_array_equal(got, want)
    size = (target, target) if isinstance(target, int) else target
    assert got.shape[:2] == size


def test_recursive_attributes():
    model = CBAM(32)
    assert recursive_getattr(model, "channel_attention.conv1.weight") is model.channel_attention.conv1.weight
    assert recursive_getattr(model, "channel_attention.missing", None) is None
    recursive_setattr(model, "spatial_attention.tag", 3)
    recursive_setattr(model, "applied", True)
    assert model.spatial_attention.tag == 3 and model.applied
