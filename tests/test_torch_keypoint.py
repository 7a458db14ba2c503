"""The port's KeypointDetection head against the JAX package's (CPU).

The head at a small size (64 px pyramid, 16 channels, one hidden layer, 5
keypoints, anchors at levels 4-5, heatmaps at level 2 (16 x 16), 8
instances, 5 targets, 16 positives; the dynamic net's c = 32 is fixed by
the head), weights carried over by ``state_dict_from_flat`` (strict):

* inference: num_instances exact, scores and presence within 1e-5, the
  softmax heatmaps and the saliency within 1e-5 + 1e-4 relative (logits of
  magnitude near 10 through exp in f32), keypoints exact wherever a heatmap's two
  largest logits lie more than 1e-4 of its largest magnitude apart (the
  first maximum of two values within rounding of each other may differ);
* ``keypoints_to_boxes`` and ``keypoints_to_heatmaps`` exact;
* ``training_step``: the loss and its three parts within 1e-5 relative of
  JAX's f64 step from the port in f64, 1e-4 in f32, and every gradient of
  the head within relative L2 1e-4 (f64) and 1e-3 (f32) of JAX's f64
  gradients (JAX's decode runs its einsum chain in f32 inside its f64 step,
  ``sihl_tpu/ops/pallas/dynconv.py:67``: the port's f64 step reads about
  6e-6 from it); with no target, keypoint and presence losses of exactly 0;
* ``validation_end``'s PCK equal to JAX's on the same collected outputs;
* ``utils/pck.py``: the JAX package's file after its docstring, byte for
  byte, and the same PCK on random instances.

Keypoints are integers: their boxes' edges are integers and the targets'
box centres, drawn with odd sums of opposite edges, sit on half pixels,
never midway between two anchor centres (so no two anchors tie for a
target's best IoU, the ``rel_iou == 1`` kink); and round(kp 15 / 63) lies
at least 1/42 from a .5 boundary.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from conftest import make_pyramid
from sihl_tpu.heads import KeypointDetection as JaxKeypointDetection
from sihl_tpu.layers import convblocks as jax_convblocks
from sihl_tpu.policy import compute_dtype_scope as jax_compute_dtype_scope
from sihl_tpu.utils import pck as jax_pck
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import KeypointDetection
from sihl_tpu_torch.policy import compute_dtype_scope
from sihl_tpu_torch.utils import pck

from torch_parity import flat_state, load_from_jax, randomize_norms, to_numpy, to_torch

BATCH, T, K, SIZE = 2, 5, 5, 64
HEAD_KW = dict(num_channels=16, num_layers=1, max_instances=8, max_targets=T, max_mask_positives=16,
               bottom_level=4, top_level=5, mask_level=2)


def keypoint_targets(rng, size, counts, num_keypoints=K, max_targets=T):
    """Padded integer keypoints (B, T, K, 2) in an image of ``size`` px and
    presence (B, T, K): each instance with at least two visible keypoints,
    its visible box of positive width and height with odd sums of opposite
    edges (centre on a half pixel)."""
    keypoints = np.zeros((len(counts), max_targets, num_keypoints, 2), np.float32)
    presence = np.zeros((len(counts), max_targets, num_keypoints), bool)
    for b, n in enumerate(counts):
        for t in range(n):
            while True:
                kp = rng.randint(2, size - 2, (num_keypoints, 2))
                vis = rng.rand(num_keypoints) > 0.3
                if vis.sum() < 2:
                    continue
                low, high = kp[vis].min(axis=0), kp[vis].max(axis=0)
                if (high > low).all() and ((low + high) % 2 == 1).all():
                    break
            keypoints[b, t], presence[b, t] = kp, vis
    return keypoints, presence


@pytest.fixture(scope="module")
def head_pair():
    rng = np.random.RandomState(0)
    pyramid = make_pyramid(batch_size=BATCH, height=SIZE, width=SIZE, rng=rng)
    in_channels = [p.shape[-1] for p in pyramid]
    jax_head = JaxKeypointDetection(in_channels, K, rngs=nnx.Rngs(0), **HEAD_KW)
    randomize_norms(jax_head, rng)
    state = state_dict_from_flat(flat_state(jax_head))
    heads = {}
    for dtype in (torch.float32, torch.float64):
        with compute_dtype_scope(dtype):
            heads[dtype] = KeypointDetection(in_channels, K, **HEAD_KW)
        heads[dtype].load_state_dict(state, strict=True)
    # image 0 without targets, image 1 with 3
    return jax_head, heads, pyramid, keypoint_targets(rng, SIZE, (0, 3))


def _served_pair(jax_head, heads, pyramid):
    """The JAX head in eval mode with its loc bias midway between image 0's
    4th and 5th loc logits (about half of the slots clear 0.5), and the
    port's f32 head with its weights."""
    jax_head = nnx.clone(jax_head)
    jax_head.eval()
    inputs = [jnp.asarray(p) for p in pyramid]
    bias = jax_head.loc_head.linears[-1].bias
    bias[...] = jnp.zeros((1,), jnp.float32)
    top = np.log(np.asarray(jax_head(inputs)[1][0], np.float64))
    top -= np.log1p(-np.exp(top))
    bias[...] = jnp.full((1,), -(top[3] + top[4]) / 2, jnp.float32)
    return jax_head, inputs, load_from_jax(copy.deepcopy(heads[torch.float32]), jax_head)


def test_forward_matches_jax(head_pair):
    jax_head, heads, pyramid, _ = head_pair
    jax_head, inputs, head = _served_pair(jax_head, heads, pyramid)
    want = [np.asarray(w) for w in jax_head(inputs)]
    x = [to_torch(p) for p in pyramid]
    with torch.no_grad():
        got = head(x)
        heatmaps = head(x, output_heatmaps=True)
        logits = heatmaps.log()  # each map's logits up to a constant, for the gap of its two largest
    for (name, shape), g in zip(head.output_shapes.items(), got):
        assert g.shape == tuple({"batch_size": BATCH}.get(s, s) for s in shape), name
    num, scores, presence, keypoints = got
    assert 0 < int(want[0].sum()) < 2 * 8
    np.testing.assert_array_equal(num.numpy(), want[0])
    np.testing.assert_allclose(to_numpy(scores), want[1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(to_numpy(presence), want[2], atol=1e-5, rtol=0)
    np.testing.assert_allclose(heatmaps.numpy(), np.asarray(jax_head(inputs, output_heatmaps=True)), atol=1e-5, rtol=1e-4)
    b, i, h, w, k = logits.shape
    top = logits.reshape(b, i, h * w, k).topk(2, dim=2).values
    clear = ((top[:, :, 0] - top[:, :, 1]) > 1e-4 * top[:, :, 0].abs()).numpy()  # (B, I, K)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(keypoints.numpy()[clear], want[3][clear])
    assert keypoints.dtype == torch.float32 and ((keypoints >= 0) & (keypoints <= SIZE)).all()
    with torch.no_grad():
        saliency = head.get_saliency(x)
    np.testing.assert_allclose(saliency.numpy(), np.asarray(jax_head.get_saliency(inputs)), atol=1e-5, rtol=1e-4)


def test_keypoints_to_boxes_and_heatmaps_match_jax(head_pair):
    jax_head, heads, _, _ = head_pair
    rng = np.random.RandomState(3)
    kpts = (rng.rand(3, 4, K, 2) * 63).astype(np.float32)
    pres = rng.rand(3, 4, K) > 0.4
    pres[0, 0] = False  # an instance with no visible keypoint: a zero box
    boxes = KeypointDetection.keypoints_to_boxes(torch.from_numpy(kpts), torch.from_numpy(pres))
    want = JaxKeypointDetection.keypoints_to_boxes(jnp.asarray(kpts), jnp.asarray(pres))
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(want))
    assert not boxes[0, 0].any()
    heat = heads[torch.float32].keypoints_to_heatmaps(torch.from_numpy(kpts), torch.from_numpy(pres).float(),
                                                     16, 12, 64, 48)
    want = jax_head.keypoints_to_heatmaps(jnp.asarray(kpts), jnp.asarray(pres, jnp.float32), 16, 12, 64, 48)
    assert heat.shape == (3, 4, K, 16, 12) and heat.dtype == torch.float32
    np.testing.assert_array_equal(heat.numpy(), np.asarray(want))


def test_split_dynamic_weights_matches_jax(head_pair):
    """The six parts of a (B, I, P) dynamic weight tensor (P = 2,341 at
    c = 32, K = 5), in JAX's order and shapes."""
    jax_head, heads, _, _ = head_pair
    dyn = np.random.RandomState(4).randn(2, 3, heads[torch.float32].kernel_head.linears[-1].weight.shape[0])
    got = heads[torch.float32]._split_dynamic_weights(torch.from_numpy(dyn))
    want = jax_head._split_dynamic_weights(jnp.asarray(dyn, jnp.float32))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w))


def _head_step(head, pyramid, keypoints, presence):
    head = copy.deepcopy(head).train()
    x = [to_torch(p).to(next(head.parameters()).dtype) for p in pyramid]
    loss, metrics = head.training_step(x, torch.from_numpy(keypoints), torch.from_numpy(presence))
    loss.backward()
    grads = {n: p.grad for n, p in head.named_parameters()}
    return float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, grads


def _jax_head_step64(jax_head, pyramid, keypoints, presence):
    """JAX's jitted f64 head step (``jax.enable_x64``, the f64 compute
    dtype, the stock BatchNorm): loss, metrics, gradients as a port state
    dict."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True), jax_compute_dtype_scope(jnp.float64):
        mp.setattr(jax_convblocks, "_FUSED_BN", False)
        head = nnx.clone(jax_head)
        nnx.update(head, jax.tree_util.tree_map(
            lambda v: jnp.asarray(v, jnp.float64) if v.dtype == jnp.float32 else v, nnx.state(head)))
        head.train()

        @nnx.jit
        def value_and_grad(h, inputs, kp, pr):
            return nnx.value_and_grad(lambda hh: hh.training_step(inputs, kp, pr), has_aux=True)(h)

        (loss, metrics), grads = value_and_grad(
            head, [jnp.asarray(p, jnp.float64) for p in pyramid], jnp.asarray(keypoints), jnp.asarray(presence))
        flat = {".".join(map(str, path)): np.asarray(v[...], np.float64) for path, v in nnx.to_flat_state(grads)}
        return float(loss), {k: float(v) for k, v in metrics.items()}, state_dict_from_flat(flat)


@pytest.fixture(scope="module")
def jax_step(head_pair):
    jax_head, _, pyramid, (keypoints, presence) = head_pair
    return _jax_head_step64(jax_head, pyramid, keypoints, presence)


def _relative_error(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.double() - want.double())) / max(
        float(torch.linalg.vector_norm(want.double())), 1e-12
    )


@pytest.mark.parametrize("dtype,loss_tol,grad_tol", [(torch.float64, 1e-5, 1e-4), (torch.float32, 1e-4, 1e-3)],
                         ids=["f64", "f32"])
def test_training_step_losses_and_gradients_match_jax_f64(head_pair, jax_step, dtype, loss_tol, grad_tol):
    _, heads, pyramid, (keypoints, presence) = head_pair
    want_loss, want_metrics, want_grads = jax_step
    loss, metrics, grads = _head_step(heads[dtype], pyramid, keypoints, presence)
    assert want_metrics["keypoint_loss"] > 0 and want_metrics["presence_loss"] > 0  # the targets matched
    assert loss == pytest.approx(want_loss, rel=loss_tol)
    assert sorted(metrics) == sorted(want_metrics) == ["keypoint_loss", "location_loss", "presence_loss"]
    for k, v in metrics.items():
        assert v == pytest.approx(want_metrics[k], rel=loss_tol), k
    assert sorted(grads) == sorted(want_grads)
    for name, g in grads.items():
        assert _relative_error(g, want_grads[name]) <= grad_tol, (name, _relative_error(g, want_grads[name]))


def test_training_step_without_targets(head_pair):
    jax_head, heads, pyramid, (keypoints, presence) = head_pair
    presence = np.zeros_like(presence)
    want_loss, want_metrics, _ = _jax_head_step64(jax_head, pyramid, keypoints, presence)
    loss, metrics, _ = _head_step(heads[torch.float32], pyramid, keypoints, presence)
    assert metrics["keypoint_loss"] == want_metrics["keypoint_loss"] == 0.0
    assert metrics["presence_loss"] == want_metrics["presence_loss"] == 0.0
    assert loss == pytest.approx(want_loss, rel=1e-4)


def test_validation_matches_jax(head_pair):
    """``validation_step`` then ``validation_end`` of both heads (JAX's aux
    through ``jax.device_get``, the port's through the host): the loss
    within 1e-4 relative, PCK equal, and between 0 and 1 exclusive: image
    1's first two targets are the head's own top keypoints, so some are
    correct and some not."""
    jax_head, heads, pyramid, (keypoints, presence) = head_pair
    jax_head, inputs, head = _served_pair(jax_head, heads, pyramid)
    own = np.asarray(jax_head(inputs)[3])
    keypoints = keypoints.copy()
    keypoints[1, :2] = own[1, :2]
    state, _, aux = jax_head.validation_step(jax_head.metrics_init(), inputs, jnp.asarray(keypoints),
                                             jnp.asarray(presence))
    want = jax_head.validation_end(state, [jax.device_get(aux)])
    with torch.no_grad():
        state, _, aux = head.validation_step(head.metrics_init(), [to_torch(p) for p in pyramid],
                                             torch.from_numpy(keypoints), torch.from_numpy(presence))
    got = head.validation_end(state, [{k: v.numpy() for k, v in aux.items()}])
    assert sorted(got) == sorted(want) == ["PCK", "loss"]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-4)
    assert got["PCK"] == want["PCK"] and 0 < got["PCK"] < 1


def test_pck_is_the_jax_package_copy():
    """The code after the docstring equals the JAX package's byte for byte,
    and both give the same PCK on random instances (some hidden, some
    unmatched, one image without predictions)."""
    root = Path(__file__).resolve().parents[1]

    def body(path):
        text = (root / path).read_bytes()
        return text[text.index(b'"""', 3) + 3 :]

    assert body("sihl_tpu_torch/utils/pck.py") == body("sihl_tpu/utils/pck.py")
    rng = np.random.RandomState(5)
    acc, jacc = pck.PercentageOfCorrectKeypoints(0.1), jax_pck.PercentageOfCorrectKeypoints(0.1)
    for n_pred, n_gt in ((3, 2), (0, 2), (4, 4), (2, 0)):
        args = (rng.rand(n_pred, K, 2), rng.rand(n_pred, K) > 0.3, rng.rand(n_gt, K, 2), rng.rand(n_gt, K) > 0.3)
        acc.update(*args)
        jacc.update(*args)
    assert acc.compute() == jacc.compute() and 0 < acc.compute()["PCK"] < 1
