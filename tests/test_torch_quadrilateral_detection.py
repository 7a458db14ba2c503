"""The port's QuadrilateralDetection head against the JAX package's (CPU).

* ``quad_bbox_matching`` on hand-placed anchors, including anchors whose
  claiming gts all have a negative CIoU (the reference's argmax then lands
  on a gt that did not claim them): assignment and masks exact, relative
  CIoU within 1e-6;
* ``canonicalize_and_convexify`` (concave quads included) and
  ``sigmoid_focal_loss``, within 1e-6;
* the head at the size of ``tests/heads`` (64 px pyramid, 16 channels, one
  hidden layer, 8 instances, 5 targets), weights carried over by
  ``state_dict_from_flat`` (strict): inference with num_instances and
  classes exact, scores within 1e-5, quads within 1e-4 px; ``training_step``
  loss and metrics within 1e-4 relative and every gradient within relative
  L2 1e-3 of JAX's, from the port in f64 and in f32.

The whole model's step is in ``tests/test_torch_quad_slice.py``.

Targets are quads with one vertex on each side of an axis-aligned box of
integer corners and odd width and height: the box centres sit on half
pixels, never midway between two anchor centres, so no two anchors tie for
a target (``torch.topk`` and ``lax.top_k`` order ties differently).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from conftest import make_pyramid
from sihl_tpu.heads import QuadrilateralDetection as JaxQuadrilateralDetection
from sihl_tpu.heads.quadrilateral_detection import quad_bbox_matching as jax_quad_bbox_matching
from sihl_tpu.ops.losses import sigmoid_focal_loss as jax_sigmoid_focal_loss
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import QuadrilateralDetection
from sihl_tpu_torch.heads.quadrilateral_detection import quad_bbox_matching
from sihl_tpu_torch.ops.losses import sigmoid_focal_loss
from sihl_tpu_torch.policy import compute_dtype_scope

from torch_parity import flat_state, load_from_jax, randomize_norms, to_numpy, to_torch

BATCH, T = 2, 5
HEAD_KW = dict(num_channels=16, num_layers=1, max_instances=8, max_targets=T)


def quad_targets(rng, size, num_classes, counts):
    """Padded classes (B, T) int32 and quads (B, T, 4, 2) f32: one vertex on
    each side of a box with integer corners and odd, unequal sides."""
    classes = np.full((len(counts), T), -1, np.int32)
    quads = np.zeros((len(counts), T, 4, 2), np.float32)
    for b, n in enumerate(counts):
        for t in range(n):
            w, h = 2 * rng.choice(np.arange(size // 16, size // 5), 2, replace=False) + 1
            x0, y0 = rng.randint(0, size - w), rng.randint(0, size - h)
            x1, y1 = x0 + w, y0 + h
            a, bb, c, d = rng.randint(1, min(w, h), 4)
            quads[b, t] = [[x0 + a, y0], [x1, y0 + bb], [x1 - c, y1], [x0, y1 - d]]
            classes[b, t] = rng.randint(0, num_classes)
    return classes, quads


def test_quad_bbox_matching_matches_jax():
    """Batched over images; image 1 has two padded gt rows.  Small gts far
    from most of the anchors give top-k CIoUs that are all negative."""
    rng = np.random.RandomState(0)
    centres = rng.rand(40, 2) * 100
    anchors = np.concatenate([centres - 6, centres + 6], axis=1).astype(np.float32)
    xy = rng.rand(2, 4, 2) * 90
    gt = np.concatenate([xy, xy + 2 + rng.rand(2, 4, 2) * 8], axis=2).astype(np.float32)
    mask = np.array([[1, 1, 1, 1], [1, 1, 0, 0]], bool)
    want = jax.vmap(lambda b, m: jax_quad_bbox_matching(jnp.asarray(anchors), b, m, 9))(
        jnp.asarray(gt), jnp.asarray(mask)
    )
    got = quad_bbox_matching(torch.from_numpy(anchors), torch.from_numpy(gt), torch.from_numpy(mask), 9)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-6, atol=1e-7)
    # the reference quirk is exercised: claimed anchors whose match has CIoU <= 0
    assert ((got[0] >= 0) & (got[2] <= 0)).any() and (got[2] > 0).any()


def test_canonicalize_and_convexify_and_focal_loss_match_jax():
    rng = np.random.RandomState(1)
    quads = (rng.rand(3, 6, 4, 2) * 50).astype(np.float32)  # random vertex orders, some concave
    want = JaxQuadrilateralDetection.canonicalize_and_convexify(jnp.asarray(quads))
    got = QuadrilateralDetection.canonicalize_and_convexify(torch.from_numpy(quads))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        QuadrilateralDetection.quads_to_boxes(torch.from_numpy(quads)).numpy(),
        np.asarray(JaxQuadrilateralDetection.quads_to_boxes(jnp.asarray(quads))),
    )
    logits = (rng.randn(4, 7) * 3).astype(np.float32)
    targets = (rng.rand(4, 7) > 0.7).astype(np.float32)
    for alpha in (0.25, -1.0):
        np.testing.assert_allclose(
            sigmoid_focal_loss(torch.from_numpy(logits), torch.from_numpy(targets), alpha=alpha).numpy(),
            np.asarray(jax_sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(targets), alpha=alpha)),
            rtol=1e-6, atol=1e-7,
        )


@pytest.fixture(scope="module")
def head_pair():
    rng = np.random.RandomState(0)
    pyramid = make_pyramid(batch_size=BATCH, height=64, width=64, rng=rng)
    in_channels = [p.shape[-1] for p in pyramid]
    jax_head = JaxQuadrilateralDetection(in_channels, 4, rngs=nnx.Rngs(0), **HEAD_KW)
    randomize_norms(jax_head, rng)
    state = state_dict_from_flat(flat_state(jax_head))
    heads = {}
    for dtype in (torch.float32, torch.float64):
        with compute_dtype_scope(dtype):
            heads[dtype] = QuadrilateralDetection(in_channels, 4, **HEAD_KW)
        heads[dtype].load_state_dict(state, strict=True)
    return jax_head, heads, pyramid, quad_targets(rng, 64, 4, (2, 4))


def test_forward_matches_jax(head_pair):
    jax_head, heads, pyramid, _ = head_pair
    jax_head = nnx.clone(jax_head)
    jax_head.eval()
    inputs = [jnp.asarray(p) for p in pyramid]
    # move the loc bias midway between image 0's 4th and 5th loc logits, so
    # that about half of the slots clear the 0.5 score line
    bias = jax_head.loc_head.linears[-1].bias
    bias[...] = jnp.zeros((1,), jnp.float32)
    top = np.log(np.asarray(jax_head(inputs)[1][0], np.float64))
    top -= np.log1p(-np.exp(top))
    bias[...] = jnp.full((1,), -(top[3] + top[4]) / 2, jnp.float32)
    head = load_from_jax(copy.deepcopy(heads[torch.float32]), jax_head)
    want = [np.asarray(w) for w in jax_head(inputs)]
    with torch.no_grad():
        got = head([to_torch(p) for p in pyramid])
    for (name, shape), g in zip(head.output_shapes.items(), got):
        assert g.shape == tuple({"batch_size": BATCH}.get(s, s) for s in shape), name
    assert 0 < int(want[0].sum()) < 2 * 8
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_allclose(to_numpy(got[1]), want[1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(to_numpy(got[3]), want[3], atol=1e-4, rtol=0)


def _head_step(head, pyramid, classes, quads):
    head = copy.deepcopy(head).train()
    loss, metrics = head.training_step(
        [to_torch(p) for p in pyramid], torch.from_numpy(classes).long(), torch.from_numpy(quads)
    )
    loss.backward()
    grads = {n: p.grad for n, p in head.named_parameters()}
    return float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, grads


def _jax_head_step(jax_head, pyramid, classes, quads):
    jax_head = nnx.clone(jax_head)
    jax_head.train()

    @nnx.jit
    def value_and_grad(h, inputs, c, q):
        return nnx.value_and_grad(lambda hh: hh.training_step(inputs, c, q), has_aux=True)(h)

    (loss, metrics), grads = value_and_grad(
        jax_head, [jnp.asarray(p) for p in pyramid], jnp.asarray(classes), jnp.asarray(quads)
    )
    flat = {".".join(map(str, path)): np.asarray(v[...]) for path, v in nnx.to_flat_state(grads)}
    return float(loss), {k: float(v) for k, v in metrics.items()}, state_dict_from_flat(flat)


def _relative_error(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.double() - want.double())) / max(
        float(torch.linalg.vector_norm(want.double())), 1e-12
    )


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_training_step_losses_and_gradients_match_jax(head_pair, dtype):
    jax_head, heads, pyramid, (classes, quads) = head_pair
    want_loss, want_metrics, want_grads = _jax_head_step(jax_head, pyramid, classes, quads)
    loss, metrics, grads = _head_step(heads[dtype], pyramid, classes, quads)
    assert want_metrics["quad_loss"] > 0 and want_metrics["class_loss"] > 0  # the targets matched
    assert loss == pytest.approx(want_loss, rel=1e-4)
    assert sorted(metrics) == sorted(want_metrics) == ["class_loss", "location_loss", "quad_loss"]
    for k, v in metrics.items():
        assert v == pytest.approx(want_metrics[k], rel=1e-4, abs=1e-7), k
    assert sorted(grads) == sorted(want_grads)
    for name, g in grads.items():
        assert _relative_error(g, want_grads[name]) <= 1e-3, (name, _relative_error(g, want_grads[name]))


def test_training_step_without_targets(head_pair):
    jax_head, heads, pyramid, (classes, quads) = head_pair
    classes, quads = np.full_like(classes, -1), np.zeros_like(quads)
    want_loss, want_metrics, _ = _jax_head_step(jax_head, pyramid, classes, quads)
    loss, metrics, _ = _head_step(heads[torch.float32], pyramid, classes, quads)
    assert metrics["quad_loss"] == want_metrics["quad_loss"] == 0.0
    assert metrics["class_loss"] == want_metrics["class_loss"] == 0.0
    assert loss == pytest.approx(want_loss, rel=1e-4)
