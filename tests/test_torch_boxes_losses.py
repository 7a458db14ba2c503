"""Parity of the port's box geometry, anchor matching and losses with the JAX
package (f32, CPU).  Values agree to 1e-5 relative or better (the same
formulas, evaluated in another order); assignments exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sihl_tpu.ops import boxes as jax_boxes
from sihl_tpu.ops import losses as jax_losses
from sihl_tpu_torch.heads import anchors
from sihl_tpu_torch.ops import boxes, losses

import torch_parity  # noqa: F401  (one thread per worker)

TOL = dict(atol=1e-5, rtol=1e-5)


def _random_boxes(rng, n, size=128.0):
    xy = rng.rand(n, 2) * size * 0.8
    wh = rng.rand(n, 2) * size * 0.4
    wh[0] = 0.0  # a degenerate box
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def test_box_iou_and_ciou_match_jax():
    rng = np.random.RandomState(0)
    b1, b2 = _random_boxes(rng, 7), _random_boxes(rng, 5)
    t1, t2 = torch.from_numpy(b1), torch.from_numpy(b2)
    np.testing.assert_allclose(
        boxes.box_iou(t1, t2).numpy(), np.asarray(jax_boxes.box_iou(jnp.asarray(b1), jnp.asarray(b2))), **TOL
    )
    np.testing.assert_allclose(
        boxes.complete_box_iou(t1, t2).numpy(),
        np.asarray(jax_boxes.complete_box_iou(jnp.asarray(b1), jnp.asarray(b2))),
        **TOL,
    )


def test_ciou_loss_and_its_gradient_match_jax():
    rng = np.random.RandomState(1)
    pred, target = _random_boxes(rng, 9) / 128, _random_boxes(rng, 9) / 128
    pred[0] += 0.01  # keep the degenerate box off the other's corner
    weights = rng.rand(9).astype(np.float32)

    def jax_loss(p):
        return jnp.sum(jnp.asarray(weights) * jax_boxes.complete_box_iou_loss(p, jnp.asarray(target)))

    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = (torch.from_numpy(weights) * boxes.complete_box_iou_loss(p, torch.from_numpy(target))).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), atol=1e-4, rtol=1e-4)


def _matching_inputs():
    """Cell anchors of levels 3-5 at 64 px (84 anchors) and 3 images of padded
    gt: duplicate gt boxes (IoU ties between gts), a gt far smaller than any
    anchor, an image with no valid gt, and padding rows that are not zero."""
    pyramid = [torch.zeros(1, 1, 64 >> lvl, 64 >> lvl) for lvl in range(6)]
    offsets, scales = anchors.cell_anchors(pyramid, range(3, 6))
    anchor_boxes = ((offsets + scales) * 64).numpy()
    gt = np.zeros((3, 6, 4), np.float32)
    mask = np.zeros((3, 6), bool)
    gt[0, :4] = [[4, 4, 20, 20], [4, 4, 20, 20], [30, 8, 60, 40], [10, 30, 40, 62]]
    mask[0, :4] = True
    gt[0, 5] = [0, 0, 64, 64]  # a padding row with a box: masked out
    gt[1, :2] = [[32, 32, 32.5, 32.5], [0, 0, 64, 64]]
    mask[1, :2] = True
    return anchor_boxes, gt, mask


@pytest.mark.parametrize("relative", [True, False])
def test_bbox_matching_matches_jax(relative):
    anchor_boxes, gt, mask = _matching_inputs()
    want_assign, want_iou = jax.vmap(
        lambda b, m: jax_boxes.bbox_matching(jnp.asarray(anchor_boxes), b, m, 9, relative=relative)
    )(jnp.asarray(gt), jnp.asarray(mask))
    assign, iou = boxes.bbox_matching(
        torch.from_numpy(anchor_boxes), torch.from_numpy(gt), torch.from_numpy(mask), 9, relative=relative
    )
    assert assign.dtype == torch.int32 and assign.shape == (3, anchor_boxes.shape[0])
    np.testing.assert_array_equal(assign.numpy(), np.asarray(want_assign))
    np.testing.assert_allclose(iou.numpy(), np.asarray(want_iou), **TOL)
    # the duplicate gts tie everywhere: the lower index keeps the anchor
    assert 1 not in assign[0].tolist() and 0 in assign[0].tolist()
    assert (assign[2] == -1).all() and (iou[2] == 0).all()
    if relative:
        assert float(iou.max()) == 1.0


def test_binary_cross_entropy_with_logits_matches_jax():
    rng = np.random.RandomState(2)
    logits = (rng.randn(5, 7) * 20).astype(np.float32)
    targets = (rng.rand(5, 7) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        losses.binary_cross_entropy_with_logits(torch.from_numpy(logits), torch.from_numpy(targets)).numpy(),
        np.asarray(jax_losses.binary_cross_entropy_with_logits(jnp.asarray(logits), jnp.asarray(targets))),
        **TOL,
    )


@pytest.mark.parametrize("label_smoothing,ignore_index,axis", [(0.0, None, -1), (0.1, -1, -1), (0.2, 3, 1)])
def test_cross_entropy_matches_jax(label_smoothing, ignore_index, axis):
    rng = np.random.RandomState(3)
    logits = (rng.randn(4, 6, 5) * 3).astype(np.float32)
    shape = (4, 5) if axis == 1 else (4, 6)
    num_classes = logits.shape[axis]
    targets = rng.randint(0, num_classes, shape)
    if ignore_index is not None:
        targets[0, :2] = ignore_index
    want = jax_losses.cross_entropy(
        jnp.asarray(logits), jnp.asarray(targets), label_smoothing=label_smoothing,
        ignore_index=ignore_index, axis=axis,
    )
    got = losses.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(targets), label_smoothing=label_smoothing,
        ignore_index=ignore_index, dim=axis,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if ignore_index is not None:
        assert (got[0, :2] == 0).all()
