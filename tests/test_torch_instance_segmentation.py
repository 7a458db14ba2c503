"""The port's InstanceSegmentation head against the JAX package's (CPU).

The head at the size of ``tests/heads/test_instance_heads.py`` (64 px
pyramid, 16 channels, one hidden layer, 8 instances, 5 targets, 16 mask
positives), weights carried over by ``state_dict_from_flat`` (strict):

* inference: num_instances and classes exact, scores within 1e-5, masks
  within 1e-4;
* ``training_step``: loss and metrics within 1e-4 relative, and every
  gradient of the head within relative L2 1e-3 of JAX's, from the port in
  f64 and in f32; with no target, a mask loss of exactly 0;

and one whole training step (resnet26 with level 1 frozen, FPN 32 wide over
levels 3-5, the head with 5 classes, 2 images at 128 px) through
``Trainer`` and through ``_losses`` against JAX's, in the style of
``tests/test_torch_train_slice.py``.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from conftest import make_pyramid
from sihl_tpu import Backbone as JaxBackbone
from sihl_tpu import SihlModel as JaxSihlModel
from sihl_tpu.heads import InstanceSegmentation as JaxInstanceSegmentation
from sihl_tpu.layers import FPN as JaxFPN
from sihl_tpu.training import Trainer as JaxTrainer
from sihl_tpu.training.trainer import _losses as jax_losses
from sihl_tpu_torch import Backbone, SihlModel
from sihl_tpu_torch.convert import state_dict_from_flat
from sihl_tpu_torch.heads import InstanceSegmentation
from sihl_tpu_torch.layers import FPN
from sihl_tpu_torch.policy import compute_dtype_scope
from sihl_tpu_torch.training import Trainer
from sihl_tpu_torch.training.trainer import _losses

from torch_parity import damp_residual_branches, flat_state, load_from_jax, randomize_norms, to_numpy, to_torch

BATCH, T = 2, 5
HEAD_KW = dict(num_channels=16, num_layers=1, max_instances=8, max_targets=T, max_mask_positives=16)
OPTIMIZER = dict(
    optimizer="adamw",
    optimizer_kwargs={"lr": 1e-4, "weight_decay": 1e-4, "backbone_lr_factor": 0.1},
    grad_clip=0.1,
)


def _targets(rng, size, num_classes, counts):
    """Padded classes (B, T) and binary masks (B, T, size, size) at image
    resolution: rectangles of even, unequal sides.  Their boxes' centres
    then sit on half pixels, never midway between two anchor centres, so
    no two anchors tie for a target's best IoU: at a tie, whether both
    ratios to the best come out exactly 1 (a location target) rests on the
    last bit of each framework's CIoU."""
    classes = np.full((BATCH, T), -1, np.int32)
    masks = np.zeros((BATCH, T, size, size), np.float32)
    for b, n in enumerate(counts):
        for t in range(n):
            classes[b, t] = rng.randint(0, num_classes)
            y, x = rng.randint(0, size * 3 // 4, 2)
            hh, ww = 2 * rng.choice(np.arange(size // 16, size // 8 + 1), 2, replace=False)
            masks[b, t, y : y + hh, x : x + ww] = 1.0
    return classes, masks


@pytest.fixture(scope="module")
def head_pair():
    rng = np.random.RandomState(0)
    pyramid = make_pyramid(batch_size=BATCH, height=64, width=64, rng=rng)
    in_channels = [p.shape[-1] for p in pyramid]
    jax_head = JaxInstanceSegmentation(in_channels, 4, rngs=nnx.Rngs(0), **HEAD_KW)
    randomize_norms(jax_head, rng)
    state = state_dict_from_flat(flat_state(jax_head))
    heads = {}
    for dtype in (torch.float32, torch.float64):
        with compute_dtype_scope(dtype):
            heads[dtype] = InstanceSegmentation(in_channels, 4, **HEAD_KW)
        heads[dtype].load_state_dict(state, strict=True)
    # image 0 without targets, image 1 with 3
    classes, masks = _targets(rng, 64, 4, (0, 3))
    return jax_head, heads, pyramid, (classes, masks)


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
        num, scores, classes, masks = head([to_torch(p) for p in pyramid])
    for (name, shape), g in zip(head.output_shapes.items(), (num, scores, classes, masks)):
        assert g.shape == tuple({"batch_size": BATCH, "height/8": 8, "width/8": 8}.get(s, s) for s in shape), name
    assert 0 < int(want[0].sum()) < 2 * 8
    np.testing.assert_array_equal(num.numpy(), want[0])
    np.testing.assert_array_equal(classes.numpy(), want[2])
    np.testing.assert_allclose(to_numpy(scores), want[1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(to_numpy(masks), want[3], atol=1e-4, rtol=0)


def _head_step(head, pyramid, classes, masks):
    head = copy.deepcopy(head).train()
    x = [to_torch(p) for p in pyramid]
    loss, metrics = head.training_step(x, torch.from_numpy(classes).long(), torch.from_numpy(masks))
    loss.backward()
    grads = {n: p.grad for n, p in head.named_parameters()}
    return float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, grads


def _jax_head_step(jax_head, pyramid, classes, masks):
    jax_head = nnx.clone(jax_head)
    jax_head.train()

    @nnx.jit
    def value_and_grad(h, inputs, c, m):
        return nnx.value_and_grad(lambda hh: hh.training_step(inputs, c, m), has_aux=True)(h)

    (loss, metrics), grads = value_and_grad(
        jax_head, [jnp.asarray(p) for p in pyramid], jnp.asarray(classes), jnp.asarray(masks)
    )
    flat = {".".join(map(str, path)): np.asarray(v[...]) for path, v in nnx.to_flat_state(grads)}
    return float(loss), {k: float(v) for k, v in metrics.items()}, state_dict_from_flat(flat)


def _relative_error(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.double() - want.double())) / max(
        float(torch.linalg.vector_norm(want.double())), 1e-12
    )


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_training_step_losses_and_gradients_match_jax(head_pair, dtype):
    jax_head, heads, pyramid, (classes, masks) = head_pair
    want_loss, want_metrics, want_grads = _jax_head_step(jax_head, pyramid, classes, masks)
    loss, metrics, grads = _head_step(heads[dtype], pyramid, classes, masks)
    assert want_metrics["mask_loss"] > 0 and want_metrics["class_loss"] > 0  # the targets matched
    assert loss == pytest.approx(want_loss, rel=1e-4)
    assert sorted(metrics) == sorted(want_metrics) == ["class_loss", "location_loss", "mask_loss"]
    for k, v in metrics.items():
        assert v == pytest.approx(want_metrics[k], rel=1e-4, abs=1e-7), k
    assert sorted(grads) == sorted(want_grads)
    for name, g in grads.items():
        assert _relative_error(g, want_grads[name]) <= 1e-3, (name, _relative_error(g, want_grads[name]))


def test_training_step_without_targets(head_pair):
    jax_head, heads, pyramid, (classes, masks) = head_pair
    classes, masks = np.full_like(classes, -1), np.zeros_like(masks)
    want_loss, want_metrics, _ = _jax_head_step(jax_head, pyramid, classes, masks)
    loss, metrics, _ = _head_step(heads[torch.float32], pyramid, classes, masks)
    assert metrics["mask_loss"] == want_metrics["mask_loss"] == 0.0
    assert metrics["class_loss"] == want_metrics["class_loss"] == 0.0
    assert loss == pytest.approx(want_loss, rel=1e-4)


def test_full_res_masks_waits_for_eval(head_pair):
    """``full_res_masks=True`` builds and returns masks at the input's size
    (their values against JAX's: ``tests/test_torch_validation.py``)."""
    _, heads, pyramid, _ = head_pair
    head = InstanceSegmentation([p.shape[-1] for p in pyramid], 4, full_res_masks=True, **HEAD_KW)
    head.load_state_dict(heads[torch.float32].state_dict(), strict=True)
    with torch.no_grad():
        masks = head.eval()([to_torch(p) for p in pyramid])[3]
    assert masks.shape == (BATCH, HEAD_KW["max_instances"], 64, 64)


def _build_model(backbone, fpn, head, model, **init):
    bb = backbone("resnet26", top_level=5, **init)
    bb.set_frozen_levels(1)
    neck = fpn(bb.out_channels, 32, bottom_level=3, top_level=5, **init)
    seg = head(neck.out_channels, 5, num_channels=32, max_targets=T, max_mask_positives=32, **init)
    return model(bb, neck, [seg])


@pytest.fixture(scope="module")
def model_pair():
    rng = np.random.RandomState(1)
    jax_model = _build_model(JaxBackbone, JaxFPN, JaxInstanceSegmentation, JaxSihlModel, rngs=nnx.Rngs(0))
    randomize_norms(jax_model, rng)
    damp_residual_branches(jax_model, rng)
    model = _build_model(Backbone, FPN, InstanceSegmentation, SihlModel)
    model.load_state_dict(state_dict_from_flat(flat_state(jax_model)), strict=True)
    x = rng.rand(BATCH, 128, 128, 3).astype(np.float32)
    classes, masks = _targets(rng, 128, 5, (2, 4))
    jax_batch = (jnp.asarray(x), {"classes": jnp.asarray(classes), "masks": jnp.asarray(masks)})
    batch = (to_torch(x), {"classes": torch.from_numpy(classes).long(), "masks": torch.from_numpy(masks)})
    return jax_model, model, jax_batch, batch


def test_model_step_gradients_match_jax(model_pair):
    """The summed losses' gradients of every trainable parameter, by part:
    heads and neck within relative L2 1e-3, backbone 5e-3 (f32 loses digits
    in train-mode BatchNorm's backward on random weights, as in
    tests/test_torch_train_slice.py)."""
    jax_model, model, (jx, jt), (x, t) = model_pair
    jax_model = nnx.clone(jax_model)
    jax_model.train()

    @nnx.jit
    def value_and_grad(m, xx, tt):
        return nnx.value_and_grad(lambda mm: jax_losses(mm, xx, [tt]), has_aux=True)(m)

    (_, want_metrics), jax_grads = value_and_grad(jax_model, jx, jt)
    want = state_dict_from_flat({".".join(map(str, p)): np.asarray(v[...]) for p, v in nnx.to_flat_state(jax_grads)})
    model = copy.deepcopy(model).train()
    loss, metrics = _losses(model, x, [t])
    loss.backward()
    assert float(want_metrics["head0/train/mask_loss"]) > 0
    for k, v in metrics.items():
        assert float(v.detach()) == pytest.approx(float(want_metrics[k]), rel=1e-4, abs=1e-7), k
    limits = {"heads": 1e-3, "neck": 1e-3, "backbone": 5e-3}
    for name, p in model.named_parameters():
        if name.startswith("backbone.features.stem."):
            assert p.grad is None and not want[name].any(), name
            continue
        err = _relative_error(p.grad, want[name])
        assert err <= limits[name.split(".")[0]], (name, err)


def test_model_trainer_step_matches_jax(model_pair):
    jax_model, model, (jx, jt), (x, t) = model_pair
    want = JaxTrainer(nnx.clone(jax_model), **OPTIMIZER).training_step(jx, jt)
    got = Trainer(copy.deepcopy(model), **OPTIMIZER).training_step(x, t)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert float(v) == pytest.approx(float(want[k]), rel=1e-4, abs=1e-7), k
