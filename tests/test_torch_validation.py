"""The port's head validation against the JAX package's (CPU).

Each ported head (ObjectDetection, QuadrilateralDetection,
InstanceSegmentation) at the size of ``tests/heads`` (64 px pyramid, 16
channels, one hidden layer, 8 instances, 5 targets), weights carried over
by ``state_dict_from_flat`` (strict), eval mode, the loc bias set so that
about half of image 0's slots score above 0.5; the port in f64 and in f32
against JAX (whose heads compute their losses and scores in f32 whatever
the input, so f32 sets the tolerances):

* ``validation_step``: the loss within ``LOSS_RTOL`` relative, the metric
  state's count exactly and its total as the loss; ``aux`` with the same
  keys: classes, ground truth, mask widths and bit-packed masks exactly,
  scores within ``SCORE_ATOL``, boxes within ``BOX_ATOL`` px;
* ``validation_end`` on the batch's host-side ``aux``: the same keys, the
  loss within ``LOSS_RTOL`` and every mAP value within 1e-9 (image 1's
  first three targets are JAX's own top three detections, so that mAP50
  lies strictly between 0 and 1);
* ``full_res_masks=True``: the port's linear resize of its own masks
  within 1e-6 of ``jax.image.resize`` of the same masks, and the full-size
  masks within the forward's 1e-4 of JAX's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from conftest import make_pyramid
from sihl_tpu.heads import InstanceSegmentation as JaxInstanceSegmentation
from sihl_tpu.heads import ObjectDetection as JaxObjectDetection
from sihl_tpu.heads import QuadrilateralDetection as JaxQuadrilateralDetection
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import InstanceSegmentation, ObjectDetection, QuadrilateralDetection
from sihl_tpu_torch.policy import compute_dtype_scope
from sihl_tpu_torch.training.trainer import _to_host
from test_torch_instance_segmentation import _targets as instance_targets
from test_torch_quadrilateral_detection import quad_targets

from torch_parity import flat_state, randomize_norms, to_numpy, to_torch

BATCH, T, SIZE, NUM_CLASSES = 2, 5, 64, 4
HEAD_KW = dict(num_channels=16, num_layers=1, max_instances=8, max_targets=T)
LOSS_RTOL, SCORE_ATOL, BOX_ATOL, MAP_ATOL = 1e-5, 1e-6, 1e-4, 1e-9
HEADS = {
    "detection": (JaxObjectDetection, ObjectDetection, {}),
    "quad": (JaxQuadrilateralDetection, QuadrilateralDetection, {}),
    "instance": (JaxInstanceSegmentation, InstanceSegmentation, {"max_mask_positives": 16}),
}


def box_targets(rng, size, num_classes, counts):
    """Padded classes (B, T) int32 and boxes (B, T, 4) f32 with integer
    corners and odd sides, whose centres sit on half pixels (no two anchors
    tie for a target's best IoU)."""
    classes = np.full((len(counts), T), -1, np.int32)
    boxes = np.zeros((len(counts), T, 4), np.float32)
    for b, n in enumerate(counts):
        for t in range(n):
            w, h = 2 * rng.randint(size // 16, size // 5, 2) + 1
            x0, y0 = rng.randint(0, size - w), rng.randint(0, size - h)
            boxes[b, t] = [x0, y0, x0 + w, y0 + h]
            classes[b, t] = rng.randint(0, num_classes)
    return classes, boxes


def set_loc_bias(jax_head, inputs) -> None:
    """Move the loc bias midway between image 0's 4th and 5th loc logits."""
    bias = jax_head.loc_head.linears[-1].bias
    bias[...] = jnp.zeros((1,), jnp.float32)
    top = np.log(np.asarray(jax_head(inputs)[1][0], np.float64))
    top -= np.log1p(-np.exp(top))
    bias[...] = jnp.full((1,), -(top[3] + top[4]) / 2, jnp.float32)


@pytest.fixture(scope="module", params=list(HEADS))
def head_case(request):
    kind = request.param
    jax_cls, cls, extra = HEADS[kind]
    rng = np.random.RandomState(0)
    pyramid = make_pyramid(batch_size=BATCH, height=SIZE, width=SIZE, rng=rng)
    in_channels = [p.shape[-1] for p in pyramid]
    jax_head = jax_cls(in_channels, NUM_CLASSES, rngs=nnx.Rngs(0), **HEAD_KW, **extra)
    randomize_norms(jax_head, rng)
    jax_head.eval()
    set_loc_bias(jax_head, [jnp.asarray(p) for p in pyramid])
    state = state_dict_from_flat(flat_state(jax_head))
    heads = {}
    for dtype in (torch.float32, torch.float64):
        with compute_dtype_scope(dtype):
            heads[dtype] = cls(in_channels, NUM_CLASSES, **HEAD_KW, **extra)
        heads[dtype].load_state_dict(state, strict=True)
        heads[dtype].eval()
    make = {"detection": box_targets, "quad": quad_targets, "instance": instance_targets}[kind]
    classes, geoms = make(rng, SIZE, NUM_CLASSES, (2, 4))
    # image 1's first three targets are JAX's own top three detections, so
    # that the mAP values are neither all 0 nor all 1
    _, _, pred_classes, pred_geoms = (np.asarray(o) for o in jax_head([jnp.asarray(p) for p in pyramid]))
    classes[1, :3] = pred_classes[1, :3]
    if kind == "instance":  # the 8 x 8 masks, > 0.5, at the targets' 64 x 64
        pred_geoms = (pred_geoms > 0.5).repeat(SIZE // 8, axis=-1).repeat(SIZE // 8, axis=-2)
    geoms[1, :3] = pred_geoms[1, :3]
    return kind, jax_head, heads, pyramid, (classes, geoms)


@pytest.fixture(scope="module")
def jax_validation(head_case):
    """JAX's ``validation_step`` and ``validation_end`` on the batch."""
    _, jax_head, _, pyramid, (classes, geoms) = head_case
    state, loss, aux = nnx.jit(lambda h, s, x, c, g: h.validation_step(s, x, c, g))(
        jax_head, jax_head.metrics_init(), [jnp.asarray(p) for p in pyramid], jnp.asarray(classes), jnp.asarray(geoms)
    )
    host = jax.device_get(aux)
    return state, float(loss), host, jax_head.validation_end(state, [host])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_validation_step_and_end_match_jax(head_case, jax_validation, dtype):
    kind, _, heads, pyramid, (classes, geoms) = head_case
    want_state, want_loss, want_aux, want_end = jax_validation
    head = heads[dtype]
    with torch.no_grad():
        state, loss, aux = head.validation_step(
            head.metrics_init(), [to_torch(p) for p in pyramid], torch.from_numpy(classes).long(),
            torch.from_numpy(geoms),
        )
    assert float(loss) == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert float(state["loss"]["count"]) == float(want_state["loss"]["count"]) == 1.0
    assert float(state["loss"]["total"]) == pytest.approx(float(want_state["loss"]["total"]), rel=LOSS_RTOL)
    assert state["loss"]["total"].dtype == torch.float32

    host = _to_host(aux)
    assert sorted(host) == sorted(want_aux)
    for k, want in want_aux.items():
        got = host[k]
        if k in ("scores",):
            np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0, err_msg=k)
        elif k in ("pred_boxes",):
            np.testing.assert_allclose(got, want, atol=BOX_ATOL, rtol=0, err_msg=k)
        else:  # classes, ground truth, bit-packed masks, widths
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=k)
    if kind == "instance":
        assert host["pred_masks_bits"].dtype == np.uint8 and host["pred_masks_width"] == SIZE // 8
        assert 0 < np.unpackbits(host["pred_masks_bits"]).mean() < 1  # some pixels above 0.5, not all
    if kind != "instance":
        assert 0 < int((host["scores"] > 0.5).sum()) < BATCH * HEAD_KW["max_instances"]

    end = head.validation_end(state, [host])
    assert sorted(end) == sorted(want_end)
    assert end["loss"] == pytest.approx(want_end["loss"], rel=LOSS_RTOL)
    for k, v in end.items():
        if k != "loss":
            assert isinstance(v, float) and v == pytest.approx(want_end[k], abs=MAP_ATOL), k
    assert 0 < end["map_50"] < 1


def test_default_head_validation():
    """``Head``'s defaults: no state, the training step's loss and metrics as ``aux``, no metrics at the end."""
    rng = np.random.RandomState(5)
    pyramid = make_pyramid(batch_size=BATCH, height=SIZE, width=SIZE, rng=rng)
    head = ObjectDetection([p.shape[-1] for p in pyramid], NUM_CLASSES, **HEAD_KW).eval()
    classes, boxes = box_targets(rng, SIZE, NUM_CLASSES, (1, 2))
    x = [to_torch(p) for p in pyramid]
    targets = (torch.from_numpy(classes).long(), torch.from_numpy(boxes))
    with torch.no_grad():
        state, loss, metrics = super(ObjectDetection, head).validation_step({}, x, *targets)
        want_loss, want_metrics = head.training_step(x, *targets)
    assert state == {} and float(loss) == float(want_loss)
    assert {k: float(v) for k, v in metrics.items()} == {k: float(v) for k, v in want_metrics.items()}
    assert super(ObjectDetection, head).validation_end(state, [metrics]) == {}
    assert super(ObjectDetection, head).metrics_init() == {}


def test_full_res_masks_match_jax():
    rng = np.random.RandomState(6)
    pyramid = make_pyramid(batch_size=BATCH, height=SIZE, width=SIZE, rng=rng)
    in_channels = [p.shape[-1] for p in pyramid]
    kw = dict(HEAD_KW, max_mask_positives=16)
    jax_head = JaxInstanceSegmentation(in_channels, NUM_CLASSES, full_res_masks=True, rngs=nnx.Rngs(0), **kw)
    randomize_norms(jax_head, rng)
    jax_head.eval()
    head = InstanceSegmentation(in_channels, NUM_CLASSES, full_res_masks=True, **kw)
    head.load_state_dict(state_dict_from_flat(flat_state(jax_head)), strict=True)
    head.eval()
    inputs = [to_torch(p) for p in pyramid]
    with torch.no_grad():
        masks = head(inputs)[3]
        low = copy.deepcopy(head)
        low.full_res_masks = False
        low_masks = low(inputs)[3]
    assert masks.shape == (BATCH, HEAD_KW["max_instances"], SIZE, SIZE)
    assert low_masks.shape == (BATCH, HEAD_KW["max_instances"], SIZE // 8, SIZE // 8)
    # the resize alone: JAX's resize of the port's own low-resolution masks
    want = jax.image.resize(jnp.asarray(to_numpy(low_masks)), masks.shape, method="linear")
    np.testing.assert_allclose(to_numpy(masks), np.asarray(want), atol=1e-6, rtol=0)
    # the whole forward against JAX's
    want_masks = np.asarray(jax_head([jnp.asarray(p) for p in pyramid])[3])
    np.testing.assert_allclose(to_numpy(masks), want_masks, atol=1e-4, rtol=0)
