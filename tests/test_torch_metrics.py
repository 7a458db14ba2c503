"""The port's metric accumulators, COCO mAP and mask bit packing against the
JAX package's (CPU).

* each (init, update, compute) triple of ``training/metrics.py`` fed the
  same seeded batches on both sides, NaN and inf values, negative and
  out-of-range class ids and an ignore index included: counts equal
  exactly, f32 sums and metrics within 1e-6 relative; ``tree_add`` too;
* ``utils/coco_map.py``: the port's copy against the JAX package's file on
  the same padded (-1) detections, bbox and segm, result dicts equal
  exactly, and perfect predictions reading 1.0;
* ``packbits_last``: bitwise equal to JAX's, at widths divisible by 8 and
  not, and inverted by ``np.unpackbits(..., bitorder="little")``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sihl_tpu.ops.image import packbits_last as jax_packbits_last
from sihl_tpu.training import metrics as JM
from sihl_tpu.utils import coco_map as jax_coco_map
from sihl_tpu_torch.ops.image import packbits_last
from sihl_tpu_torch.training import metrics as M
from sihl_tpu_torch.utils import coco_map

import torch_parity  # noqa: F401  (the CPU as the port's default device)

RTOL = 1e-6


def _assert_tree_close(got, want, exact=()):
    """Every leaf of ``got`` (tensors) against ``want`` (jax arrays), the
    leaves under the keys in ``exact`` bit for bit, the rest within ``RTOL``
    relative."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k in exact:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0, err_msg=k)


def _run(init, update, compute, batches, jinit, jupdate, jcompute, init_args=()):
    state, jstate = init(*init_args), jinit(*init_args)
    for args in batches:
        state = update(state, *(torch.as_tensor(a) if a is not None else None for a in args))
        jstate = jupdate(jstate, *(jnp.asarray(a) if a is not None else None for a in args))
    return state, jstate, compute(state), jcompute(jstate)


def test_mean_ignores_non_finite_values():
    values = [1.5, np.nan, -2.25, np.inf, 3.0, -np.inf, 0.125]
    state, jstate = M.mean_init(), JM.mean_init()
    for i, v in enumerate(values):
        w = 1.0 + 0.5 * i
        state = M.mean_update(state, torch.tensor(v, dtype=torch.float64), w)
        jstate = JM.mean_update(jstate, v, w)
    _assert_tree_close(state, jstate, exact=("count",))
    assert float(state["count"]) == sum(1.0 + 0.5 * i for i, v in enumerate(values) if np.isfinite(v))
    np.testing.assert_allclose(float(M.mean_compute(state)), float(JM.mean_compute(jstate)), rtol=RTOL)
    assert float(M.mean_compute(M.mean_init())) == 0.0


@pytest.mark.parametrize("kind", ["confusion", "segmentation", "segmentation_ignore"])
def test_confusion_and_segmentation_match_jax(kind):
    rng = np.random.RandomState(0)
    n = 6
    batches = []
    for _ in range(3):
        preds = rng.randint(0, n, (4, 9, 9)).astype(np.int32)
        targets = rng.randint(0, n, (4, 9, 9)).astype(np.int32)
        targets[0, :2] = 255  # the ignore index (out of range without one)
        targets[1, 0, :3] = -1  # wraps to the last row, as jnp's .at[] does
        batches.append((preds, targets) if kind != "confusion" else (preds.reshape(-1), targets.reshape(-1)))
    if kind == "confusion":
        parts = (M.confusion_init, M.confusion_update, M.confusion_compute,
                 JM.confusion_init, JM.confusion_update, JM.confusion_compute)
    else:
        ignore = 255 if kind == "segmentation_ignore" else None

        def update(s, p, t):
            return M.segmentation_update(s, p, t, ignore)

        def jupdate(s, p, t):
            return JM.segmentation_update(s, p, t, ignore)

        parts = (M.segmentation_init, update, M.segmentation_compute,
                 JM.segmentation_init, jupdate, JM.segmentation_compute)
    state, jstate, got, want = _run(*parts[:3], batches, *parts[3:], init_args=(n,))
    _assert_tree_close(state, jstate, exact=("confusion",))
    _assert_tree_close(got, want)


def test_binary_stats_match_jax():
    rng = np.random.RandomState(1)
    batches = [(rng.rand(5, 7) > 0.4, rng.rand(5, 7) > 0.6) for _ in range(3)]
    state, jstate, got, want = _run(
        M.binary_stats_init, M.binary_stats_update, M.binary_stats_compute, batches,
        JM.binary_stats_init, JM.binary_stats_update, JM.binary_stats_compute,
    )
    _assert_tree_close(state, jstate, exact=("tp", "fp", "fn", "tn"))
    _assert_tree_close(got, want)


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_regression_matches_jax(masked):
    rng = np.random.RandomState(2)
    batches = [
        (rng.randn(4, 3).astype(np.float32), rng.randn(4, 3).astype(np.float32) * 2 + 1,
         (rng.rand(4, 3) > 0.3) if masked else None)
        for _ in range(3)
    ]
    state, jstate, got, want = _run(
        M.regression_init, M.regression_update, M.regression_compute, batches,
        JM.regression_init, JM.regression_update, JM.regression_compute,
    )
    _assert_tree_close(state, jstate, exact=("count",))
    _assert_tree_close(got, want)


def test_tree_add_and_empty_states():
    a = {"x": {"total": torch.tensor(1.5), "count": torch.tensor(2.0)}, "y": [torch.tensor(3.0)]}
    b = {"x": {"total": torch.tensor(0.25), "count": torch.tensor(1.0)}, "y": [torch.tensor(-1.0)]}
    want = JM.tree_add(
        {"x": {"total": jnp.float32(1.5), "count": jnp.float32(2.0)}, "y": [jnp.float32(3.0)]},
        {"x": {"total": jnp.float32(0.25), "count": jnp.float32(1.0)}, "y": [jnp.float32(-1.0)]},
    )
    got = M.tree_add(a, b)
    assert float(got["x"]["total"]) == float(want["x"]["total"]) and float(got["y"][0]) == float(want["y"][0])
    # compute on empty states: the same guarded divisions
    _assert_tree_close(M.confusion_compute(M.confusion_init(3)), JM.confusion_compute(JM.confusion_init(3)))
    _assert_tree_close(M.regression_compute(M.regression_init()), JM.regression_compute(JM.regression_init()))


# --------------------------------------------------------------------------
# COCO mAP


def _detections(rng, batch, slots, targets, num_classes, size=128.0, perfect=False):
    """Padded predictions and ground truth: boxes (x0, y0, x1, y1) of all
    sizes (the COCO small, medium and large ranges), gt classes -1 padded."""
    gt_classes = np.full((batch, targets), -1, np.int32)
    gt_boxes = np.zeros((batch, targets, 4), np.float32)
    for b in range(batch):
        n = rng.randint(1, targets + 1)
        gt_classes[b, :n] = rng.randint(0, num_classes, n)
        xy = rng.rand(n, 2) * size * 0.6
        wh = np.exp(rng.uniform(np.log(4), np.log(size * 0.9), (n, 2)))
        gt_boxes[b, :n] = np.concatenate([xy, xy + wh], 1)
    if perfect:
        scores = np.where(gt_classes >= 0, np.linspace(0.9, 0.5, targets)[None], 0.0).astype(np.float32)
        return gt_boxes.copy(), np.maximum(gt_classes, 0), scores, gt_boxes, gt_classes
    pred_boxes = np.zeros((batch, slots, 4), np.float32)
    pred_classes = rng.randint(0, num_classes, (batch, slots)).astype(np.int32)
    for b in range(batch):
        # half the slots near a gt box, the rest anywhere
        src = gt_boxes[b, rng.randint(0, max(int((gt_classes[b] >= 0).sum()), 1), slots)]
        jitter = rng.randn(slots, 4) * rng.choice([0.5, 2.0, 8.0], (slots, 1))
        near = rng.rand(slots) < 0.5
        pred_boxes[b] = np.where(near[:, None], src + jitter, rng.rand(slots, 4) * size)
        pred_boxes[b, :, 2:] = np.maximum(pred_boxes[b, :, 2:], pred_boxes[b, :, :2] + 1)
        pred_classes[b, near] = np.maximum(gt_classes[b, rng.randint(0, targets, slots)], 0)[near]
    scores = rng.rand(batch, slots).astype(np.float32)
    return pred_boxes, pred_classes, scores, gt_boxes, gt_classes


def _boxes_to_masks(boxes, size):
    """Binary (B, N, size, size) masks of each box's pixels."""
    ys = np.arange(size)[:, None] + 0.5
    xs = np.arange(size)[None, :] + 0.5
    b = boxes[..., None, None]
    return ((xs >= b[..., 0, :, :]) & (xs < b[..., 2, :, :]) & (ys >= b[..., 1, :, :])
            & (ys < b[..., 3, :, :])).astype(np.uint8)


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_coco_map_copy_matches_jax(iou_type):
    rng = np.random.RandomState(3)
    acc = coco_map.MeanAveragePrecisionAccumulator(iou_type=iou_type)
    jacc = jax_coco_map.MeanAveragePrecisionAccumulator(iou_type=iou_type)
    for _ in range(2):
        pred, pcls, scores, gt, gcls = _detections(rng, 2, 12, 6, 3)
        if iou_type == "segm":
            pred, gt = _boxes_to_masks(pred / 2, 64), _boxes_to_masks(gt, 128)  # predictions at half size
        acc.update(pred, pcls, scores, gt, gcls)
        jacc.update(pred, pcls, scores, gt, gcls)
    got, want = acc.compute(), jacc.compute()
    assert got == want
    assert set(got) == {"map", "map_50", "map_75", "map_small", "map_medium", "map_large",
                        "mar_1", "mar_10", "mar_100"}
    assert 0 < got["map_50"] < 1


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_coco_map_perfect_predictions(iou_type):
    rng = np.random.RandomState(4)
    acc = coco_map.MeanAveragePrecisionAccumulator(iou_type=iou_type)
    jacc = jax_coco_map.MeanAveragePrecisionAccumulator(iou_type=iou_type)
    pred, pcls, scores, gt, gcls = _detections(rng, 3, 6, 6, 2, perfect=True)
    if iou_type == "segm":
        pred, gt = _boxes_to_masks(pred, 128), _boxes_to_masks(gt, 128)
    acc.update(pred, pcls, scores, gt, gcls)
    jacc.update(pred, pcls, scores, gt, gcls)
    got = acc.compute()
    assert got == jacc.compute()
    assert got["map"] == got["map_50"] == got["map_75"] == 1.0
    assert coco_map.MeanAveragePrecisionAccumulator().compute() == {}


def test_coco_map_is_a_copy():
    """The port's file holds the JAX file's code after its docstring, and
    loads nothing of the JAX package."""
    def body(module):
        text = open(module.__file__).read()
        return text[text.index("from typing"):]

    assert body(coco_map) == body(jax_coco_map)
    assert "sihl_tpu." not in body(coco_map)


# --------------------------------------------------------------------------
# packbits_last


@pytest.mark.parametrize("shape", [(2, 3, 16), (2, 5, 13), (4, 1), (3, 7, 9, 24), (1, 2, 640)])
def test_packbits_last_matches_jax(shape):
    rng = np.random.RandomState(sum(shape))
    x = rng.rand(*shape) > 0.5
    got = packbits_last(torch.from_numpy(x))
    want = np.asarray(jax_packbits_last(jnp.asarray(x)))
    assert got.dtype == torch.uint8 and want.dtype == np.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    unpacked = np.unpackbits(got.numpy(), axis=-1, bitorder="little")[..., : shape[-1]]
    np.testing.assert_array_equal(unpacked, x)
